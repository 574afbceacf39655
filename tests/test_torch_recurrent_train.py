"""Training of the recurrent families in the port against the JAX
package's, on the CPU at smoke size: the chunked WKV and the
chunk-checkpointed selective scan as differentiable torch recurrences,
the rwkv6-1.6b and hymba-1.5b training forward, loss and gradients, and
three steps of the ZeRO-3 trainer.

The reference runs in JAX subprocesses with 8 forced host devices on a
plain `jax.sharding.Mesh` of (8, 1) as ("data", "model") (its
`run_training` and `launch/mesh.py` build theirs with `jax.make_mesh`,
which these tests avoid). Five subprocesses run side by side: the
recurrence, model and spec cases, and each trainer run (two families in
f32 and bf16). Inputs are made from numpy seeds; the models start from
the reference's own `init_params`, carried over by
`convert.params_from_jax` (bf16 leaves cross as f32, exactly; `w0`, `u`
and the SSM's step size, decays and skip stay f32 in either dtype, as the
reference's `init_rwkv` and `init_mamba` leave them).

Off the TPU the reference evaluates WKV in its chunked parallel form
(`models/recurrence.py` `_wkv_chunk`) and the SSM as a step-by-step scan
in `jax.checkpoint`ed chunks (inline in `mamba_ssm`); on a TPU it calls
Pallas kernels that have no VJP. The port trains through the same two
forms in torch ops (`recurrence._wkv_chunk`, `_ssm_scan_chunked`); the
card wrappers `ops.wkv` / `ops.ssm_scan` serve and refuse grad.

Tolerances, against the largest |value| of the compared tensor:
- `_wkv_chunk` and the SSM scan in f32, values, final states and the
  gradients of a seeded scalar: 1e-5 (f32 sums in another order;
  measured at most 1.1e-6). The reference's scan is inline in
  `mamba_ssm`, so the scan is held through that layer from a given
  state: its output, final state, and the gradients of the scalar with
  respect to the layer's input, every weight (`log_a`, the decays, enters
  the scan alone) and the state;
- the training logits, loss and each leaf's gradient in f32, remat on
  and off: 1e-5, as `test_torch_train.py`'s dense models (measured at
  most 2.4e-6);
- the trainer's losses and gnorms for 3 steps: f32 within 1e-5 relative
  a step, bf16 within 5e-3, the bars of `test_torch_train.py` (its
  docstring gives why). Measured: f32 at most 2.9e-7; bf16 losses
  3.4e-4, gnorms 4.7e-3 at worst, rwkv6's step-3 gnorm, where the
  port's bf16 run sits 3.9e-4 from the f32 run's and the reference's
  4.3e-3 (its reduce-scatter folds bf16 rows in bf16, the port's in
  f32).

The sequence is 48 tokens: two WKV chunks of 24 (the largest divisor of
48 not above 32), three SSM chunks of 16, and past the smoke hymba's
32-token window, so the window masks keys.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import recurrence
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unstack_layers)
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ["rwkv6-1.6b", "hymba-1.5b"]
N = 8
SEQ = 48
DATA = dict(vocab=512, seq_len=SEQ, global_batch=8, seed=0)
STEPS = 3
LR = 1e-3
WKV_T = [24, 64]             # one chunk of 24; two chunks of 32
SSM_T = [24, 48]             # two chunks of 12; three chunks of 16
WKV = dict(B=2, H=3, K=8, V=8)
TOL = 1e-5
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
SPECS = ARCHS + [f"{a}/full" for a in ARCHS]

_CHILD = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.cost_model import PAPER_TABLE5
from repro.core.sync import SyncConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch.train import make_manual_train_step, shard_params_zero3
from repro.models import hybrid_model, recurrence, rwkv_model
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import AdamWConfig, adamw_init

out_path, in_path, spec = sys.argv[1], sys.argv[2], eval(sys.argv[3])
inp = dict(np.load(in_path))
res = {}
parts = spec["parts"]
INIT = {"rwkv6-1.6b": rwkv_model.init_params,
        "hymba-1.5b": hybrid_model.init_params}


def put(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)            # exact
        res[f"{prefix}/{key}" if key else prefix] = a


def api_of(arch, dtype):
    cfg = smoke_config(get_config(arch))
    return dataclasses.replace(
        build(cfg), init_params=lambda key, dtype=dtype:
        INIT[arch](key, cfg, dtype))


def j(name):
    return jnp.asarray(inp[name])


# ---- the chunked WKV: values and the gradients of a seeded scalar --------
for T in spec["wkv_t"] if "recurrence" in parts else []:
    args = [j(f"wkv/{T}/{a}") for a in ("r", "k", "v", "logw", "u", "s0")]

    def f(*a):
        o, s = recurrence._wkv_chunk(*a, 32)
        return ((o * j(f"wkv/{T}/co")).sum() + (s * j(f"wkv/{T}/cs")).sum(),
                (o, s))
    (_, (o, s)), g = jax.value_and_grad(f, argnums=tuple(range(6)),
                                        has_aux=True)(*args)
    put(f"wkv/{T}/out", o)
    put(f"wkv/{T}/state", s)
    for name, gi in zip(("r", "k", "v", "logw", "u", "s0"), g):
        put(f"wkv/{T}/grad/{name}", gi)

# ---- the SSM scan, through mamba_ssm from a given state ------------------
if "recurrence" in parts:
    cfg = smoke_config(get_config("hymba-1.5b"))
    p = recurrence.init_mamba(jax.random.PRNGKey(1), cfg, jnp.float32)
    put("ssm/params", p)
for T in spec["ssm_t"] if "recurrence" in parts else []:
    def f(p, x, s0):
        o, s = recurrence.mamba_ssm(p, x, cfg, state=s0, chunk=16)
        return ((o * j(f"ssm/{T}/co")).sum() + (s * j(f"ssm/{T}/cs")).sum(),
                (o, s))
    (_, (o, s)), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        p, j(f"ssm/{T}/x"), j(f"ssm/{T}/s0"))
    put(f"ssm/{T}/out", o)
    put(f"ssm/{T}/state", s)
    put(f"ssm/{T}/grad/p", g[0])
    put(f"ssm/{T}/grad/x", g[1])
    put(f"ssm/{T}/grad/s0", g[2])

# ---- each family's training logits, loss and gradients --------------------
for arch in spec["archs"] if "model" in parts else []:
    api = api_of(arch, jnp.float32)
    params = api.init_params(jax.random.PRNGKey(0))
    batch = {"tokens": j(f"{arch}/tokens"), "labels": j(f"{arch}/labels")}
    put(f"{arch}/params", params)
    put(f"{arch}/logits", api.forward(params, batch, remat=False))
    for remat in (True, False):
        loss, grads = jax.value_and_grad(
            lambda p: api.loss_fn(p, batch, remat=remat))(params)
        put(f"{arch}/{remat}/loss", loss)
        put(f"{arch}/{remat}/grads", grads)

for arch in spec["specs"] if "model" in parts else []:
    cfg = get_config(arch.split("/")[0])
    if not arch.endswith("/full"):
        cfg = smoke_config(cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(build(cfg).params_spec())
    res[f"spec/{arch}"] = np.array(
        ["/".join(str(p.key) for p in path) + " " + str(l.dtype) + " "
         + " ".join(map(str, l.shape)) for path, l in leaves])

# ---- three steps of the manual ZeRO-3 trainer -----------------------------
data = SyntheticLM(DataConfig(**spec["data"]))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("data", "model"))
sync = SyncConfig(strategy="plan", bucket_bytes=0, params=PAPER_TABLE5)
for tag in [t for t in parts if t.startswith("train/")]:
    _, arch, dtype = tag.split("/")
    api = api_of(arch, getattr(jnp, dtype))
    params = api.init_params(jax.random.PRNGKey(0))
    put(f"{tag}/init", params)
    state = {"params": shard_params_zero3(params, mesh),
             "opt": adamw_init(shard_params_zero3(params, mesh))}
    state["opt"] = {k: jax.tree.map(lambda z, q: jax.device_put(z, q.sharding),
                                    state["opt"][k], state["params"])
                    for k in ("m", "v")}
    state["opt"]["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                          NamedSharding(mesh, P()))
    step = make_manual_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                                  sync=sync)
    losses, gnorms = [], []
    for s in range(spec["steps"]):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(s)))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res[f"{tag}/losses"] = np.asarray(losses)
    res[f"{tag}/gnorms"] = np.asarray(gnorms)
np.savez(out_path, **res)
"""


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _inputs() -> dict:
    """Every input the reference cases read, numpy from seeds: the WKV's
    r, k, v, log-decays (≤ 0), bonus and state; the SSM layer's input and
    state; each scalar's cotangents; each family's tokens."""
    rng = np.random.default_rng(31)
    out = {}
    B, H, K, V = WKV["B"], WKV["H"], WKV["K"], WKV["V"]
    for T in WKV_T:
        for name in ("r", "k", "v"):
            shape = (B, H, T, V if name == "v" else K)
            out[f"wkv/{T}/{name}"] = rng.standard_normal(shape)
        out[f"wkv/{T}/logw"] = -np.exp(
            rng.standard_normal((B, H, T, K)) * 0.5 - 1.0)
        out[f"wkv/{T}/u"] = rng.standard_normal((H, K)) * 0.1
        out[f"wkv/{T}/s0"] = rng.standard_normal((B, H, K, V))
        out[f"wkv/{T}/co"] = rng.standard_normal((B, H, T, V))
        out[f"wkv/{T}/cs"] = rng.standard_normal((B, H, K, V))
    cfg = smoke_config(get_config("hymba-1.5b"))
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    for T in SSM_T:
        out[f"ssm/{T}/x"] = rng.standard_normal((2, T, cfg.d_model))
        out[f"ssm/{T}/s0"] = rng.standard_normal((2, di, n)) * 0.1
        out[f"ssm/{T}/co"] = rng.standard_normal((2, T, cfg.d_model))
        out[f"ssm/{T}/cs"] = rng.standard_normal((2, di, n))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    for arch in ARCHS:
        toks = rng.integers(0, smoke_config(get_config(arch)).vocab,
                            (2, SEQ + 1))
        out[f"{arch}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{arch}/labels"] = toks[:, 1:].astype(np.int32)
    return out


TRAIN_TAGS = [f"train/{a}/{d}" for a in ARCHS
              for d in ("float32", "bfloat16")]


def _spawn(d, name, parts):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr({"archs": ARCHS, "specs": SPECS, "wkv_t": WKV_T,
                 "ssm_t": SSM_T, "data": DATA, "lr": LR, "steps": STEPS,
                 "parts": parts})
    out = d / f"{name}.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(out), str(d / "inputs.npz"),
         spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    """The reference cases, in five JAX subprocesses side by side."""
    d = tmp_path_factory.mktemp("torch_recurrent_train")
    np.savez(d / "inputs.npz", **inputs)
    jobs = [_spawn(d, "cases", ["recurrence", "model"])]
    jobs += [_spawn(d, tag.replace("/", "-"), [tag]) for tag in TRAIN_TAGS]
    out = {}
    for proc, path in jobs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        out.update(dict(np.load(path)))
    return out


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs (the JAX subprocesses
    run beside it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _api(arch, **kw):
    return build(dataclasses.replace(smoke_config(get_config(arch)), **kw))


def _tree(flat: dict, prefix: str) -> dict:
    return tree_from_items(
        (tuple(k[len(prefix) + 1:].split("/")), v)
        for k, v in sorted(flat.items()) if k.startswith(prefix + "/"))


def _params(ref, prefix, api, dtype):
    """The reference's params under `prefix` as the port's, each leaf in
    its `params_spec(dtype)` dtype (bf16 leaves crossed as f32, so the
    cast is exact)."""
    spec = dict(tree_items(api.params_spec(dtype)))
    stacked = stack_layers(params_from_jax(_tree(ref, prefix)))
    return unstack_layers(tree_from_items(
        (p, t.to(spec[p].dtype)) for p, t in tree_items(stacked)))


def _t(inputs, name, grad=False):
    return torch.from_numpy(inputs[name]).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the two recurrences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", WKV_T)
def test_wkv_chunk_matches_reference(ref, inputs, T):
    names = ("r", "k", "v", "logw", "u", "s0")
    args = [_t(inputs, f"wkv/{T}/{a}", True) for a in names]
    out, s = recurrence._wkv_chunk(*args, 32)
    scalar = ((out * _t(inputs, f"wkv/{T}/co")).sum()
              + (s * _t(inputs, f"wkv/{T}/cs")).sum())
    grads = torch.autograd.grad(scalar, args)
    assert _rel(_np(out), ref[f"wkv/{T}/out"]) <= TOL
    assert _rel(_np(s), ref[f"wkv/{T}/state"]) <= TOL
    for name, g in zip(names, grads):
        assert np.isfinite(_np(g)).all(), name
        assert _rel(_np(g), ref[f"wkv/{T}/grad/{name}"]) <= TOL, name


@pytest.mark.parametrize("T", WKV_T + [1, 7, 33])
def test_wkv_chunk_equals_the_served_recurrence(inputs, T):
    """The training form and the wrapper's plain version (what the
    kernel computes) agree, T = 33 a prime past one chunk."""
    rng = np.random.default_rng(T)
    B, H, K, V = WKV["B"], WKV["H"], WKV["K"], WKV["V"]

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    r, k, v = f(B, H, T, K), f(B, H, T, K), f(B, H, T, V)
    logw = -torch.exp(f(B, H, T, K) * 0.5 - 1.0)
    u, s0 = f(H, K) * 0.1, f(B, H, K, V)
    want = ops.wkv(r, k, v, logw, u, s0)
    got = recurrence._wkv_chunk(r, k, v, logw, u, s0, 32)
    for a, b in zip(got, want):
        assert _rel(_np(a), _np(b)) <= TOL


def _ssm_layer(p, x, s0, chunk=16):
    """`mamba_ssm` with the training scan from the state s0."""
    u, dt, b, c, z = recurrence._ssm_inputs(p, x)
    ys, s = recurrence._ssm_scan_chunked(u, dt, b, c, p["log_a"], s0, chunk)
    return recurrence._ssm_out(p, x, ys, u, z), s


@pytest.mark.parametrize("T", SSM_T)
def test_ssm_scan_matches_reference(ref, inputs, T):
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in _tree(ref, "ssm/params").items()}
    x, s0 = _t(inputs, f"ssm/{T}/x", True), _t(inputs, f"ssm/{T}/s0", True)
    out, s = _ssm_layer(p, x, s0)
    scalar = ((out * _t(inputs, f"ssm/{T}/co")).sum()
              + (s * _t(inputs, f"ssm/{T}/cs")).sum())
    keys = sorted(p)
    grads = torch.autograd.grad(scalar, [p[k] for k in keys] + [x, s0])
    assert _rel(_np(out), ref[f"ssm/{T}/out"]) <= TOL
    assert _rel(_np(s), ref[f"ssm/{T}/state"]) <= TOL
    want = [ref[f"ssm/{T}/grad/p/{k}"] for k in keys] + [
        ref[f"ssm/{T}/grad/x"], ref[f"ssm/{T}/grad/s0"]]
    for name, g, w in zip(keys + ["x", "s0"], grads, want):
        assert np.isfinite(_np(g)).all(), name
        assert _rel(_np(g), w) <= TOL, name


@pytest.mark.parametrize("T,chunk", [(24, 16), (48, 16), (7, 16), (5, 1)])
def test_ssm_scan_chunked_equals_the_served_scan(T, chunk):
    """The training scan and the wrapper's plain version (what the kernel
    computes) agree, whatever the chunk (T = 7: one chunk of 7)."""
    rng = np.random.default_rng(T)
    B, Di, Nst = 2, 24, 5

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    u, b, c = f(B, T, Di), f(B, T, Nst), f(B, T, Nst)
    dt = torch.nn.functional.softplus(f(B, T, Di))
    log_a, s0 = -torch.exp(f(Di, Nst) * 0.5), f(B, Di, Nst)
    want = ops.ssm_scan(u, dt, b, c, log_a, s0)
    got = recurrence._ssm_scan_chunked(u, dt, b, c, log_a, s0, chunk)
    for a, w in zip(got, want):
        assert _rel(_np(a), _np(w)) <= TOL


def test_masked_pairs_put_no_nan_in_the_backward():
    """Decays so steep that the masked pairs' exponents overflow exp: the
    −inf mask before the exp keeps the gradients finite."""
    B, H, T, K = 1, 1, 32, 4
    g = torch.Generator().manual_seed(0)
    args = [torch.randn((B, H, T, K), generator=g) for _ in range(3)]
    logw = torch.full((B, H, T, K), -40.0)
    args = [a.requires_grad_(True) for a in args + [logw]]
    out, s = recurrence._wkv_chunk(*args, torch.zeros((H, K)),
                                   torch.zeros((B, H, K, K)), 32)
    grads = torch.autograd.grad(out.sum() + s.sum(), args)
    assert all(torch.isfinite(t).all() for t in grads)


# ---------------------------------------------------------------------------
# each family's training forward, loss and gradients
# ---------------------------------------------------------------------------
def _batch(inputs, arch):
    return {k: torch.from_numpy(inputs[f"{arch}/{k}"]).long()
            for k in ("tokens", "labels")}


def _grads(api, params, batch, remat):
    """The loss and its gradients of the stacked leaves, in the
    reference's order."""
    items = tree_items(stack_layers(params))
    paths = [p for p, _ in items]
    leaves = [t.detach().requires_grad_(True) for _, t in items]
    loss = api.loss_fn(unstack_layers(tree_from_items(zip(paths, leaves))),
                       batch, remat=remat)
    return paths, loss, torch.autograd.grad(loss, leaves)


def test_smoke_hymba_window_bites():
    cfg = _api("hymba-1.5b").cfg
    assert {cfg.window_for_layer(i) for i in range(cfg.n_layers)} == {32}
    assert SEQ > 32


@pytest.mark.parametrize("arch", ARCHS)
def test_training_logits_match_reference(ref, inputs, arch):
    api = _api(arch)
    params = _params(ref, f"{arch}/params", api, torch.float32)
    with torch.no_grad():
        logits = api.forward(params, _batch(inputs, arch), remat=False)
    assert logits.dtype == torch.float32
    assert _rel(_np(logits), ref[f"{arch}/logits"]) <= TOL


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref, inputs, arch, remat):
    api = _api(arch)
    params = _params(ref, f"{arch}/params", api, torch.float32)
    paths, loss, grads = _grads(api, params, _batch(inputs, arch), remat)
    assert _rel(_np(loss), ref[f"{arch}/{remat}/loss"]) <= TOL
    for path, g in zip(paths, grads):
        want = ref[f"{arch}/{remat}/grads/" + "/".join(path)]
        assert _rel(_np(g), want) <= TOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_identical_grads(ref, inputs, arch):
    api, batch = _api(arch), _batch(inputs, arch)
    params = _params(ref, f"{arch}/params", api, torch.float32)
    _, _, with_remat = _grads(api, params, batch, True)
    _, _, without = _grads(api, params, batch, False)
    for a, b in zip(with_remat, without):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_forward_calls_no_kernel_wrapper(monkeypatch, ref, inputs,
                                                  arch):
    """The training forward and backward run torch ops only: no kernel
    wrapper is called (the kernels have no backward), and serving still
    goes through `wkv` / `ssm_scan` on the same weights."""
    api = _api(arch)
    params = _params(ref, f"{arch}/params", api, torch.float32)
    batch = _batch(inputs, arch)
    called = []
    for name in ("rmsnorm", "flash_attention", "wkv", "ssm_scan"):
        real = getattr(ops, name)
        monkeypatch.setattr(
            ops, name, lambda *a, _n=name, _r=real, **k:
            called.append(_n) or _r(*a, **k))
    _grads(api, params, batch, True)
    assert called == []
    with torch.no_grad():
        api.prefill(params, batch, cache_len=SEQ)
    assert ("wkv" if arch == "rwkv6-1.6b" else "ssm_scan") in called


def test_rwkv_forward_returns_the_final_state(ref, inputs):
    """The rwkv training forward's state, as the reference's `forward`
    returns it: the served state after the same tokens."""
    from repro_torch.models import rwkv_model
    api = _api("rwkv6-1.6b")
    params = _params(ref, "rwkv6-1.6b/params", api, torch.float32)
    tokens = _batch(inputs, "rwkv6-1.6b")["tokens"]
    with torch.no_grad():
        logits, state = rwkv_model.forward(params, api.cfg, tokens)
        last, served = api.prefill(params, {"tokens": tokens}, cache_len=0)
    assert _rel(_np(logits[:, -1:]), _np(last)) <= TOL
    for k in ("wkv", "tm_shift", "cm_shift"):
        assert state[k].shape == served[k].shape
        assert _rel(_np(state[k]), _np(served[k])) <= TOL, k


@pytest.mark.parametrize("arch", SPECS)
def test_params_spec_matches_reference(ref, arch):
    """The leaves of `params_spec`, in the reference's order, with its
    paths, stacked shapes and dtypes (f32 where its init keeps f32)."""
    cfg = get_config(arch.split("/")[0])
    if not arch.endswith("/full"):
        cfg = smoke_config(cfg)
    got = [f"{'/'.join(p)} {str(t.dtype).removeprefix('torch.')} "
           + " ".join(map(str, t.shape))
           for p, t in tree_items(build(cfg).params_spec())]
    assert got == list(ref[f"spec/{arch}"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _state(params, mesh):
    shards = train.shard_params_zero3(params, mesh)
    return {"params": shards, "opt": adamw_init(shards)}


def _run(api, params, dtype, sync=None, mesh=N, steps=STEPS, lr=LR,
         data=None):
    state = _state(params, mesh)
    step = train.make_manual_train_step(
        api, mesh, AdamWConfig(lr=lr),
        sync=sync or SyncConfig(strategy="plan", bucket_bytes=0,
                                params=PAPER_TABLE5),
        device="cpu", param_dtype=dtype)
    data = data or SyntheticLM(DataConfig(**DATA))
    losses, gnorms = [], []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch_at(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return {"losses": losses, "gnorms": gnorms, "step": step,
            "state": state}


@pytest.fixture(scope="module")
def runs(ref):
    ops.reset_launches()
    out = {}
    for tag in TRAIN_TAGS:
        _, arch, dtype = tag.split("/")
        api, dt = _api(arch), getattr(torch, dtype)
        out[tag] = _run(api, _params(ref, f"{tag}/init", api, dt), dt)
    out["launches"] = dict(ops.LAUNCHES)
    return out


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_steps_match_reference(ref, runs, tag):
    dtype = tag.split("/")[-1]
    run = runs[tag]
    want_l, want_g = ref[f"{tag}/losses"], ref[f"{tag}/gnorms"]
    assert want_l[-1] < want_l[0]
    np.testing.assert_allclose(run["losses"], want_l, rtol=STEP_TOL[dtype],
                               atol=0)
    np.testing.assert_allclose(run["gnorms"], want_g, rtol=STEP_TOL[dtype],
                               atol=0)


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_step_keeps_the_f32_leaves(runs, tag):
    """Under bf16 parameters the leaves the reference's init keeps in f32
    (`w0`, `u`; the SSM's `w_dt`, `dt_bias`, `log_a`, `d_skip`) stay f32
    shards, and the others take the parameter dtype."""
    _, arch, dtype = tag.split("/")
    f32 = {"w0", "u", "w_dt", "dt_bias", "log_a", "d_skip"}
    paths = [p for p, _ in tree_items(_api(arch).params_spec())]
    for path, s in zip(paths, runs[tag]["state"]["params"], strict=True):
        want = torch.float32 if path[-1] in f32 else getattr(torch, dtype)
        assert s.dtype == want, path


def test_no_kernel_launches_on_the_cpu(runs):
    assert not any(runs["launches"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_step_equals_per_leaf(arch):
    """The default bucketed step (GenModel's bucket) gives the per-leaf
    step's losses and gnorms, in f32."""
    api = _api(arch)
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32)
    out = {}
    for bb in (0, None):
        run = _run(api, params, torch.float32, steps=2, sync=SyncConfig(
            strategy="plan", bucket_bytes=bb, params=PAPER_TABLE5))
        assert (run["step"].bucket_plan is not None) == (bb is None)
        out[bb] = run["losses"] + run["gnorms"]
    np.testing.assert_allclose(out[None], out[0], rtol=1e-6)


def _direct(api, params, batch, n):
    """Each rank's loss on its slice of the batch and the mean over ranks
    of the norm of its shard of the rank-averaged gradient, by autograd on
    the whole parameters: what a step reports before its update."""
    items = tree_items(stack_layers(params))
    paths = [p for p, _ in items]
    total = [torch.zeros_like(t) for _, t in items]
    losses = []
    for r in range(n):
        b = {k: v[r * v.shape[0] // n:(r + 1) * v.shape[0] // n]
             for k, v in batch.items()}
        paths_, loss, grads = _grads(api, params, b, True)
        assert paths_ == paths
        losses.append(float(loss.detach()))
        total = [a + g for a, g in zip(total, grads)]
    sq = torch.zeros(n, dtype=torch.float64)
    for g in total:
        flat = (g / n).reshape(-1).double()
        size = -(-flat.numel() // n)
        rows = torch.nn.functional.pad(flat, (0, size * n - flat.numel()))
        sq += rows.reshape(n, size).square().sum(1)
    return float(np.mean(losses)), float(sq.sqrt().mean())


def _two_level_gathered(params, mesh):
    """The weights a two-level step gathers from `shard_params_zero3`'s
    shards: rank (p, d)'s shard lands at chunk d·P + p of each leaf (the
    reference's engine trains this chunk permutation of its init,
    `test_torch_train_mesh.py`)."""
    (_, P), (_, D) = mesh
    order = [p * D + d for d in range(D) for p in range(P)]

    def leaf(t):
        flat = t.reshape(-1)
        size = -(-flat.numel() // (P * D))
        rows = torch.nn.functional.pad(
            flat, (0, size * P * D - flat.numel())).reshape(P * D, size)
        return rows[order].reshape(-1)[:flat.numel()].reshape(t.shape)
    items = tree_items(stack_layers(params))
    return unstack_layers(tree_from_items((p, leaf(t)) for p, t in items))


@pytest.mark.parametrize("sync,mesh", [
    (SyncConfig(strategy="plan", bucket_bytes=0, params=PAPER_TABLE5), N),
    (SyncConfig(strategy="plan", params=PAPER_TABLE5), N),
    (SyncConfig(strategy="plan", params=PAPER_TABLE5),
     [("pod", 2), ("data", 4)])], ids=["per-leaf", "bucketed", "two-level"])
def test_32001_row_embedding_shards_and_lands(sync, mesh):
    """hymba's vocabulary of 32,001 rows at smoke width: its embedding and
    head shard over 8 ranks and land, gathered and reduce-scattered, where
    the step's loss and gnorm equal autograd's on the whole parameters
    (lr 0, so the step leaves the weights as they are)."""
    api = _api("hymba-1.5b", vocab=32001)
    params = api.init_params(torch.Generator().manual_seed(1),
                             torch.float32)
    numels = {p: t.numel() for p, t in tree_items(api.params_spec())}
    assert numels[("embed",)] == 32001 * 64
    data = SyntheticLM(DataConfig(vocab=32001, seq_len=16, global_batch=8,
                                  seed=3))
    run = _run(api, params, torch.float32, sync=sync, mesh=mesh, steps=1,
               lr=0.0, data=data)
    batch = {k: torch.from_numpy(v).long()
             for k, v in data.batch_at(0).items()}
    if isinstance(mesh, list):
        params = _two_level_gathered(params, mesh)
    loss, gnorm = _direct(api, params, batch, N)
    np.testing.assert_allclose(run["losses"], [loss], rtol=1e-5)
    assert run["step"].mesh == (mesh if isinstance(mesh, list)
                                else [("data", N)])
    np.testing.assert_allclose(run["gnorms"], [gnorm], rtol=1e-5)


@pytest.mark.parametrize("mesh", [N, [("pod", 2), ("data", 4)]],
                         ids=["one-axis", "two-level"])
@pytest.mark.parametrize("bucket_bytes", [0, None],
                         ids=["per-leaf", "bucketed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_step_shards_line_up(arch, bucket_bytes, mesh):
    """At the full configurations' leaves (meta tensors: nothing is
    allocated) the planned step builds per leaf, bucketed and on (pod 2,
    data 4): each leaf's reduce-scattered shard is its parameter shard
    (the step refuses otherwise)."""
    api = build(get_config(arch))
    step = train.make_manual_train_step(
        api, mesh, sync=SyncConfig(strategy="plan", bucket_bytes=bucket_bytes,
                                   params=PAPER_TABLE5), device="cpu")
    live = mesh if isinstance(mesh, list) else [("data", N)]
    assert step.mesh == live
    assert (step.bucket_plan is not None) == (
        bucket_bytes is None and len(live) == 1)
