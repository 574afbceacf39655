"""MoE training in the port against the JAX package's, on the CPU at
smoke size: the expert-parallel block, its differentiable exchange, one
step's per-rank gradients and three steps of the ZeRO-3 trainer on
deepseek-moe-16b (smoke: 8 experts, top 2, 1 shared).

The reference runs in JAX subprocesses with 8 forced host devices on
plain `jax.sharding.Mesh`es (its `run_training` and `launch/mesh.py`
build theirs with `jax.make_mesh`, which these tests avoid): (8,) as
("data",) with a size-1 "model" axis, and (2, 4) as ("pod", "data").
Five subprocesses run side by side (a trainer's first step compiles
its planned schedules for some 25 s): the block and gradient cases, and
each trainer run. Inputs are made from numpy seeds; the
trainer's runs start from the reference's own `init_params`, carried
over by `convert.params_from_jax` (bf16 leaves cross as f32, exactly;
the router stays f32 in either dtype, as the reference's `init_moe`).

- `layers._moe_ep_block` through `layers.moe_ep` on 8 ranks (EP over
  "data") and on (pod 2, data 4) (EP over "pod", 2 owners of 4 experts)
  against the reference's `_moe_ep` inside `shard_map` under its
  `expert_parallel`, with the flat exchange and with the planned
  all-to-all (`get_family_executable`, both sides), and against the
  reference's `_moe_sorted_block` on each device: within 1e-6 of the
  largest |value| (the reference's own bar, tests/test_families.py), on
  even routing and on routing skewed to expert 0, where 16 slots of
  every rank's 64 are dropped (asserted);
- `core.sync.ep_exchange`: its backward is the exchange of the
  cotangent, bit for bit, with and without a schedule, on both meshes;
- one step's per-rank gradients before the reduce-scatter
  (`train.ep_loss_and_grads`) against the reference's per-device
  `value_and_grad(loss_fn(moe_dispatch="ep"))` under `expert_parallel`,
  f32, within 1e-5 of each leaf's largest |value| (f32 products and sums
  in another order), the ranks' losses within 1e-6;
- in bf16 (the router f32), the port's per-rank gradients are no
  farther from the f32 gradients on the same weights than the
  reference's bf16 gradients are (measured 3.2-14.9 % of the norm
  against 4.5-17.6 %: this MoE model's bf16 rounding moves its gradients
  by that much on both sides, the port's less);
- the trainer's losses and gnorms for 3 steps against the reference's
  `make_manual_train_step` with `SyncConfig(strategy="plan",
  bucket_bytes=0, params=PAPER_TABLE5)` on both sides, on both meshes,
  at the tolerances of `test_torch_train.py` for the dense model (its
  docstring gives why): f32 within 1e-5 relative a step; bf16 within
  5e-3, but for the gnorms of steps 2 and 3, held within 2e-2. After one
  update the two bf16 runs hold different weights (AdamW moves an
  element about lr·sign(g), and the bf16 gradients above differ by
  5-15 %), and the gnorm of a smoke MoE model follows them further than
  the dense model's: measured 7.7e-3 and 1.2e-2 at step 3 and step 2 (the
  losses stay within 5e-3, the first gnorm within 3.6e-3);
- the bucketed EP step (each rank's gradient parts written at their
  offsets, `Zero3Bucket.write(start=)`) equals the per-leaf one;
- `run_training` on deepseek-moe-16b smoke under "plan" (bucketed by
  default) and "psum", as the reference's acceptance case
  (tests/test_families.py): finite losses, the EP layer used, the two
  within 1e-3 of each other;
- on the CPU no kernel launches (every count stays 0).

The refusals this slice removes are turned round in
`test_torch_moe.py`; where the experts do not split over the first live
axis MoE trains on the per-rank loop with the grouped sorted dispatch.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import sync
from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig, expert_parallel
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import layers, transformer
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import stack_layers, tree_items
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.planner.service import PlannerService

ARCH = "deepseek-moe-16b"
N = 8
MESHES = {"one": [("data", 8)], "two": [("pod", 2), ("data", 4)]}
DATA = dict(vocab=512, seq_len=32, global_batch=8, seed=0)
STEPS = 3
LR = 1e-3
BLOCK = dict(E=8, k=2, D=16, F=24, tokens=32)
BLOCK_TOL = 1e-6
GRAD_TOL = 1e-5
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# bf16 gnorms after the first update (module docstring)
BF16_LATER_GNORM_TOL = 2e-2

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import sync as sync_mod
from repro.core.compat import shard_map
from repro.core.cost_model import PAPER_TABLE5
from repro.core.lower import guard_schedule
from repro.core.sync import SyncConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch.train import make_manual_train_step, shard_params_zero3
from repro.models import layers, transformer
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import AdamWConfig, adamw_init
from repro.planner.service import PlannerService

out_path, in_path, spec = sys.argv[1], sys.argv[2], eval(sys.argv[3])
inp = dict(np.load(in_path))
res = {}
devs = np.array(jax.devices()[:8])
MESHES = {"one": (Mesh(devs.reshape(8, 1), ("data", "model")), "data",
                  ("data",)),
          "two": (Mesh(devs.reshape(2, 4), ("pod", "data")), "pod",
                  ("pod", "data"))}


def put(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)            # exact
        res[f"{prefix}/{key}" if key else prefix] = a


def sched_of(axis, n, size):
    return PlannerService().get_family_executable(
        "all_to_all", axis, n, size).schedule


# ---- the EP block on each device against the sorted block ----------------
b = spec["block"]
E, k, D = b["E"], b["k"], b["D"]
for tag in spec["parts"].get("block", []):
    mname, routing, exch = tag.split("/")
    mesh, axis, dp = MESHES[mname]
    p = {w: jnp.asarray(inp[f"block/{w}"]) for w in ("wi", "wg", "wo")}
    xt = jnp.asarray(inp["block/x"])
    ti = jnp.asarray(inp[f"block/{routing}/topi"])
    tv = jnp.asarray(inp[f"block/{routing}/topv"])
    n_ep = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    sched = sched_of(axis, n_ep, 4096.0) if exch == "plan" else None
    with sync_mod.expert_parallel(axis, n_ep, sched):
        f = jax.jit(shard_map(
            lambda x, i, v: layers._moe_ep(p, x[0], i[0], v[0], None, E, k,
                                           D, 1.25)[None],
            mesh=mesh, in_specs=(P(dp),) * 3, out_specs=P(dp),
            check_vma=False))
        res[f"block/{tag}"] = np.asarray(f(xt, ti, tv))
    if exch == "lax":
        g = jax.jit(shard_map(
            lambda x, i, v: layers._moe_sorted_block(
                x[0], i[0], v[0], p, E, k, D, 1.25)[None],
            mesh=mesh, in_specs=(P(dp),) * 3, out_specs=P(dp),
            check_vma=False))
        res[f"sorted/{mname}/{routing}"] = np.asarray(g(xt, ti, tv))

data = SyntheticLM(DataConfig(**spec["data"]))
sync = SyncConfig(strategy="plan", bucket_bytes=0, params=PAPER_TABLE5)


def api_of(dtype):
    cfg = smoke_config(get_config(spec["arch"]))
    return dataclasses.replace(
        build(cfg), init_params=lambda key, dtype=dtype:
        transformer.init_params(key, cfg, dtype))


def ep_sched(api, axis, n):
    total = sum(int(np.prod(l.shape)) * jnp.dtype(l.dtype).itemsize
                for l in jax.tree.leaves(api.params_spec())) / 4.0
    s = PlannerService().get_family_executable(
        "all_to_all", axis, n, total, params=PAPER_TABLE5).schedule
    return s


# ---- one step's per-device gradients --------------------------------------
# kind "float32": f32 weights; "bfloat16": bf16 weights (the router f32);
# "bf16w": those bf16 weights' values in f32
for tag in spec["parts"].get("grads", []):
    mname, kind = tag.split("/")
    mesh, axis, dp = MESHES[mname]
    api = api_of(jnp.float32 if kind == "float32" else jnp.bfloat16)
    params = api.init_params(jax.random.PRNGKey(0))
    if kind == "bf16w":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        api = api_of(jnp.float32)
    put(f"grads/{tag}/init", params)
    batch = jax.tree.map(jnp.asarray, data.batch_at(0))
    n_ep = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    sched = ep_sched(api, axis, n_ep)

    def per_device(p, b):
        with sync_mod.expert_parallel(axis, n_ep, sched):
            loss, g = jax.value_and_grad(
                lambda q: api.loss_fn(q, b, remat=True,
                                      moe_dispatch="ep"))(p)
        return loss[None], jax.tree.map(lambda x: x[None], g)

    f = jax.jit(shard_map(per_device, mesh=mesh,
                          in_specs=(P(), P(dp)), out_specs=(P(dp), P(dp)),
                          check_vma=False))
    loss, g = f(params, batch)
    put(f"grads/{tag}/loss", loss)
    put(f"grads/{tag}/g", g)


# ---- three steps of the trainer -------------------------------------------
for tag in spec["parts"].get("train", []):
    mname, dtype = tag.split("/")
    mesh, axis, dp = MESHES[mname]
    api = api_of(getattr(jnp, dtype))
    params = api.init_params(jax.random.PRNGKey(0))
    put(f"train/{tag}/init", params)
    state = {"params": shard_params_zero3(params, mesh),
             "opt": adamw_init(shard_params_zero3(params, mesh))}
    state["opt"] = {kk: jax.tree.map(
        lambda z, q: jax.device_put(z, q.sharding), state["opt"][kk],
        state["params"]) for kk in ("m", "v")}
    state["opt"]["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                          NamedSharding(mesh, P()))
    step = make_manual_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                                  sync=sync)
    losses, gnorms = [], []
    for s in range(spec["steps"]):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(s)))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res[f"train/{tag}/losses"] = np.asarray(losses)
    res[f"train/{tag}/gnorms"] = np.asarray(gnorms)
np.savez(out_path, **res)
"""


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _block_inputs() -> dict:
    """The EP block's weights, tokens and two routings, numpy from seeds:
    each rank's top 2 of a softmax over 8 experts (ties to the lower
    expert, as `lax.top_k`), renormalised; "skew" adds 5 to expert 0's
    logit, so every token sends it a slot and 16 of its 32 slots a rank
    overflow the capacity of 16."""
    b = BLOCK
    rng = np.random.default_rng(41)
    E, D, F, T = b["E"], b["D"], b["F"], b["tokens"]
    out = {"block/wi": rng.standard_normal((E, D, F)) * 0.1,
           "block/wg": rng.standard_normal((E, D, F)) * 0.1,
           "block/wo": rng.standard_normal((E, F, D)) * 0.1,
           "block/x": rng.standard_normal((N, T, D))}
    logits = rng.standard_normal((N, T, E))
    for routing, bias in (("even", 0.0), ("skew", 5.0)):
        lg = logits.copy()
        lg[..., 0] += bias
        probs = np.exp(lg - lg.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        topi = np.argsort(-probs, axis=-1, kind="stable")[..., :b["k"]]
        topv = np.take_along_axis(probs, topi, -1)
        out[f"block/{routing}/topi"] = topi.astype(np.int32)
        out[f"block/{routing}/topv"] = topv / topv.sum(-1, keepdims=True)
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in out.items()}


BLOCK_TAGS = [f"{m}/{r}/{e}" for m in MESHES for r in ("even", "skew")
              for e in ("lax", "plan")]
GRAD_TAGS = [f"{m}/float32" for m in MESHES] + ["one/bfloat16", "one/bf16w"]


def _spawn(d, name, inputs, parts):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr({"arch": ARCH, "block": BLOCK, "data": DATA, "lr": LR,
                 "steps": STEPS, "parts": parts})
    out = d / f"{name}.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(out), str(d / "inputs.npz"),
         spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


@pytest.fixture(scope="module")
def inputs():
    return _block_inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    """The reference cases, in five JAX subprocesses side by side."""
    d = tmp_path_factory.mktemp("torch_moe_train")
    np.savez(d / "inputs.npz", **inputs)
    jobs = [_spawn(d, "block", inputs, {"block": BLOCK_TAGS,
                                        "grads": GRAD_TAGS})]
    jobs += [_spawn(d, f"train-{m}-{dt}", inputs, {"train": [f"{m}/{dt}"]})
             for m in MESHES for dt in ("float32", "bfloat16")]
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


@pytest.fixture
def counted():
    """Every kernel launch counter zeroed before the test; the test reads
    them after."""
    ops.reset_launches()
    yield ops.LAUNCHES


def _api():
    return build(smoke_config(get_config(ARCH)))


def _cfg(**kw):
    return dataclasses.replace(smoke_config(get_config(ARCH)), **kw)


# ---------------------------------------------------------------------------
# the EP block
# ---------------------------------------------------------------------------
def _port_block(inputs, mname, routing, exch):
    """The reference's `_moe_ep` call through the port's `_moe_ep_block`
    (the route and the shared experts stubbed out: the block's own
    inputs are given), every rank at once."""
    b = BLOCK
    pairs = MESHES[mname]
    axis = pairs[0][0]
    n_ep = pairs[0][1]
    w = {k: torch.from_numpy(inputs[f"block/{k}"]) for k in ("wi", "wg",
                                                             "wo")}
    x = torch.from_numpy(inputs["block/x"])
    ti = torch.from_numpy(inputs[f"block/{routing}/topi"]).long()
    tv = torch.from_numpy(inputs[f"block/{routing}/topv"])
    sched = (PlannerService().get_family_executable(
        "all_to_all", axis, n_ep, 4096.0).schedule if exch == "plan"
        else None)
    el = b["E"] // n_ep
    stride = N // n_ep
    ws = [{k: v[(r // stride) * el:(r // stride + 1) * el]
           for k, v in w.items()} for r in range(N)]
    lead = [s for _, s in pairs]
    kw = {"mesh": pairs} if len(pairs) > 1 else {}

    def exchange(t):
        return sync.ep_exchange(t.reshape(*lead, -1), axis, **kw).reshape(
            t.shape)
    with expert_parallel(axis, n_ep, sched):
        outs = layers._moe_ep_block(list(x), list(ti), list(tv), ws, n_ep,
                                    b["E"], 1.25, exchange)
    return torch.stack(outs).numpy(), sched


@pytest.mark.parametrize("tag", BLOCK_TAGS)
def test_ep_block_matches_reference(ref, inputs, tag):
    mname, routing, exch = tag.split("/")
    got, sched = _port_block(inputs, mname, routing, exch)
    assert (sched is not None) == (exch == "plan")
    assert _rel(got, ref[f"block/{tag}"]) <= BLOCK_TOL
    assert _rel(got, ref[f"sorted/{mname}/{routing}"]) <= BLOCK_TOL


def test_skewed_routing_drops_slots(inputs):
    """16 of each rank's 64 slots overflow expert 0's capacity of 16; the
    even routing drops none."""
    cap = layers.moe_capacity(BLOCK["tokens"], BLOCK["k"], BLOCK["E"], 1.25)
    assert cap == 16

    def drops(routing):
        return [int(np.maximum(np.bincount(t.reshape(-1),
                                           minlength=BLOCK["E"]) - cap,
                               0).sum())
                for t in inputs[f"block/{routing}/topi"]]
    assert drops("skew") == [16] * N
    assert drops("even") == [0] * N


def test_moe_ep_equals_the_block_and_the_sorted_layer(inputs):
    """`layers.moe_ep` (router, block, shared experts) on 8 ranks, EP over
    either mesh, equals each rank's one-block sorted `moe`; it refuses
    to run without an EP context that splits the experts."""
    cfg = _cfg()
    rng = np.random.default_rng(43)
    api = _api()
    params = api.init_params(torch.Generator().manual_seed(3),
                             torch.float32)
    p = params["layers"][0]["moe"]
    p["router"] = torch.from_numpy(rng.standard_normal(
        p["router"].shape).astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((1, 32, cfg.d_model))
                           .astype(np.float32)) for _ in range(N)]
    want = [layers.moe(p, x, cfg, dispatch="local") for x in xs]
    for mname, pairs in MESHES.items():
        axis, n_ep = pairs[0]
        with expert_parallel(axis, n_ep, None):
            got = layers.moe_ep([p] * N, xs, cfg, mesh=pairs)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w.numpy()) <= BLOCK_TOL
    for ctx in (None, ("data", 3), ("pod", 2)):
        with (expert_parallel(*ctx, None) if ctx
              else contextlib.nullcontext()):
            with pytest.raises(ValueError):
                layers.moe_ep([p] * N, xs, cfg, mesh=MESHES["one"])


def test_one_rank_ep_under_a_context_raises(inputs):
    cfg = _cfg()
    p = _api().init_params(torch.Generator().manual_seed(3),
                           torch.float32)["layers"][0]["moe"]
    x = torch.zeros((1, 4, cfg.d_model))
    with expert_parallel("data", 8, None):
        with pytest.raises(ValueError, match="moe_ep"):
            layers.moe(p, x, cfg, dispatch="ep")
    # a context whose size does not split the experts: the sorted block
    with expert_parallel("data", 3, None):
        assert torch.equal(layers.moe(p, x, cfg, dispatch="ep"),
                           layers.moe(p, x, cfg, dispatch="local"))


# ---------------------------------------------------------------------------
# the exchange's backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exch", ["flat", "plan"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_exchange_backward_is_the_exchange_of_the_cotangent(mname, exch):
    pairs = MESHES[mname]
    axis, n_ep = pairs[0]
    lead = [s for _, s in pairs]
    kw = {"mesh": pairs} if len(pairs) > 1 else {}
    sched = (PlannerService().get_family_executable(
        "all_to_all", axis, n_ep, 4096.0).schedule if exch == "plan"
        else None)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((*lead, 64), generator=g).requires_grad_(True)
    cot = torch.randn((*lead, 64), generator=g)
    with expert_parallel(axis, n_ep, sched):
        before = dict(sync.EP_EXCHANGES)
        y = sync.ep_exchange(x, axis, **kw)
        (dx,) = torch.autograd.grad(y, x, cot)
        want = sync.ep_all_to_all(cot, axis, **kw)
        again = sync.ep_all_to_all(y.detach(), axis, **kw)
    assert torch.equal(y.detach(), sync.ep_all_to_all(x.detach(), axis,
                                                      **kw))
    assert torch.equal(dx, want)
    assert torch.equal(again, x.detach())       # its own inverse
    assert sync.EP_EXCHANGES["forward"] - before["forward"] == 1
    assert sync.EP_EXCHANGES["backward"] - before["backward"] == 1


# ---------------------------------------------------------------------------
# one step's per-rank gradients
# ---------------------------------------------------------------------------
def _port_params(ref, prefix, dtype):
    """The reference's init under `prefix` as the port's params, in
    `dtype` but for the f32 router."""
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix + "/"):
            node = tree
            *parents, last = k[len(prefix) + 1:].split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[last] = v
    params = params_from_jax(tree)

    def cast(t, path=()):
        if isinstance(t, dict):
            return {k: cast(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v, path) for v in t]
        return t.float() if path[-1] == "router" else t.to(dtype)
    return cast(params)


def _port_grads(ref, tag, dtype):
    """One step's per-rank losses and (n, numel) gradients of the port's
    EP forward and backward from the reference's init under `tag`, the
    exchange the planned all-to-all, and the step's exchanges."""
    api = _api()
    pairs = MESHES[tag.split("/")[0]]
    axis, n_ep = pairs[0]
    params = _port_params(ref, f"grads/{tag}/init", dtype)
    items = tree_items(stack_layers(params))
    full = [t for _, t in items]
    bufs = [torch.full((N, t.numel()), float("nan"), dtype=t.dtype)
            for t in full]

    def put(r, i, g, off=0):
        bufs[i][r, off:off + g.numel()].copy_(g)
    total = sum(t.numel() * t.element_size()
                for _, t in tree_items(api.params_spec()))
    sched = train._ep_schedule(axis, n_ep, SyncConfig(
        strategy="plan", params=PAPER_TABLE5, guard=False), total)
    assert sched is not None
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(DataConfig(**DATA)).batch_at(0).items()}
    with expert_parallel(axis, n_ep, sched):
        losses, ex = train.ep_loss_and_grads(api, full, batch, pairs, put)
    return (torch.stack(losses).numpy(), [p for p, _ in items],
            [b.float().numpy() for b in bufs], ex)


@pytest.mark.parametrize("mname", list(MESHES))
def test_step_rank_gradients_match_reference(ref, mname, counted):
    cfg = _api().cfg
    tag = f"{mname}/float32"
    losses, paths, grads, ex = _port_grads(ref, tag, torch.float32)
    assert ex == {"forward": 2 * cfg.n_layers, "recompute": 2 * cfg.n_layers,
                  "backward": 2 * cfg.n_layers}
    np.testing.assert_allclose(losses, ref[f"grads/{tag}/loss"], rtol=1e-6)
    n_ep = MESHES[mname][0][1]
    for path, g in zip(paths, grads):
        want = ref[f"grads/{tag}/g/" + "/".join(path)].reshape(N, -1)
        assert not np.isnan(g).any(), path
        assert _rel(g, want) <= GRAD_TOL, path
        if path in train.EXPERT_LEAVES:
            # each rank's gradient of the other owners' experts is zero
            L, E = cfg.n_layers, cfg.n_experts
            rows = g.reshape(N, L, E, -1)
            el = E // n_ep
            for r in range(N):
                e0 = (r // (N // n_ep)) * el
                mask = np.ones(E, dtype=bool)
                mask[e0:e0 + el] = False
                assert not rows[r][:, mask].any()
    assert not any(counted.values())


def test_bf16_rank_gradients_are_no_noisier_than_the_reference(ref):
    """bf16 weights (the router f32): each leaf's per-rank gradients of
    the port in bf16 are no farther, in norm, from the f32 gradients on
    the same weights than the reference's bf16 gradients are (measured:
    3.2-14.9 % against 4.5-17.6 %); the two f32 runs agree within
    GRAD_TOL. This MoE model's bf16 gradients are that far from f32 on
    both sides, so two bf16 runs part after one update by more than the
    dense model's (`test_steps_match_reference`)."""
    b16, paths, g16, _ = _port_grads(ref, "one/bfloat16", torch.bfloat16)
    f32, _, g32, _ = _port_grads(ref, "one/bf16w", torch.float32)
    np.testing.assert_allclose(f32, ref["grads/one/bf16w/loss"], rtol=1e-6)
    for path, a, b in zip(paths, g16, g32):
        key = "/".join(path)
        want16 = ref[f"grads/one/bfloat16/g/{key}"].reshape(N, -1)
        want32 = ref[f"grads/one/bf16w/g/{key}"].reshape(N, -1)
        assert _rel(b, want32) <= GRAD_TOL, path
        port = np.linalg.norm(a - b) / np.linalg.norm(b)
        jax_ = np.linalg.norm(want16 - want32) / np.linalg.norm(want32)
        assert port <= jax_, (path, port, jax_)


# ---------------------------------------------------------------------------
# the trainer, 3 steps
# ---------------------------------------------------------------------------
def _run(ref, mname, dtype, sync_cfg=None, steps=STEPS):
    api = _api()
    dt = getattr(torch, dtype)
    shards = train.shard_params_zero3(
        _port_params(ref, f"train/{mname}/{dtype}/init", dt),
        MESHES[mname])
    state = {"params": shards, "opt": adamw_init(shards)}
    step = train.make_manual_train_step(
        api, MESHES[mname], AdamWConfig(lr=LR),
        sync=sync_cfg or SyncConfig(strategy="plan", bucket_bytes=0,
                                    params=PAPER_TABLE5),
        device="cpu", param_dtype=dt)
    data = SyntheticLM(DataConfig(**DATA))
    losses, gnorms, ex = [], [], []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch_at(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        ex.append(m.get("ep_exchanges"))
    return {"losses": losses, "gnorms": gnorms, "step": step, "ex": ex,
            "state": state}


@pytest.fixture(scope="module")
def runs(ref):
    ops.reset_launches()
    out = {(m, d): _run(ref, m, d) for m in MESHES
           for d in ("float32", "bfloat16")}
    out["launches"] = dict(ops.LAUNCHES)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_steps_match_reference(ref, runs, mname, dtype):
    run = runs[(mname, dtype)]
    want_l = ref[f"train/{mname}/{dtype}/losses"]
    want_g = ref[f"train/{mname}/{dtype}/gnorms"]
    assert want_l[-1] < want_l[0]
    np.testing.assert_allclose(run["losses"], want_l, rtol=STEP_TOL[dtype],
                               atol=0)
    later = STEP_TOL[dtype] if dtype == "float32" else BF16_LATER_GNORM_TOL
    np.testing.assert_allclose(run["gnorms"][:1], want_g[:1],
                               rtol=STEP_TOL[dtype], atol=0)
    np.testing.assert_allclose(run["gnorms"][1:], want_g[1:], rtol=later,
                               atol=0)


@pytest.mark.parametrize("mname", list(MESHES))
def test_ep_step_takes_the_planned_exchange(runs, mname):
    """EP runs over the first live axis, its exchange the guarded planned
    all-to-all; a layer's two exchanges run in the forward, again in the
    recompute and once each as a transpose; on the CPU nothing
    launches."""
    run = runs[(mname, "float32")]
    step = run["step"]
    assert step.ep == MESHES[mname][0]
    cs = step.ep_schedule
    assert cs is not None and cs.inner.family == "all_to_all"
    assert cs.n == MESHES[mname][0][1]
    L = _api().cfg.n_layers
    assert run["ex"] == [{"forward": 2 * L, "recompute": 2 * L,
                          "backward": 2 * L}] * STEPS
    assert not any(runs["launches"].values())


def test_bf16_ep_keeps_a_f32_router(runs):
    """The router's shards stay f32 under bf16 parameters, as the
    reference's `init_moe` leaves it, and so do its updates."""
    paths = [p for p, _ in tree_items(_api().params_spec())]
    for path, s in zip(paths, runs[("one", "bfloat16")]["state"]["params"]):
        want = torch.float32 if path[-1] == "router" else torch.bfloat16
        assert s.dtype == want, path


def test_moe_trains_without_ep_where_experts_do_not_split(counted):
    """On 3 ranks 8 experts do not split (the reference's use_ep is
    false): each rank runs the grouped sorted dispatch alone."""
    api = _api()
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32)
    shards = train.shard_params_zero3(params, 3)
    state = {"params": shards, "opt": adamw_init(shards)}
    step = train.make_manual_train_step(
        api, 3, AdamWConfig(lr=LR), sync=SyncConfig(strategy="psum"),
        device="cpu", param_dtype=torch.float32)
    assert step.ep is None and step.ep_schedule is None
    calls = []
    real = transformer.moe

    def spy(p, x, cfg, **kw):
        calls.append(kw.get("dispatch", "sorted"))
        return real(p, x, cfg, **kw)
    transformer.moe = spy
    try:
        batch = {k: torch.from_numpy(v[:3]).long() for k, v in
                 SyntheticLM(DataConfig(**DATA)).batch_at(0).items()}
        state, m = step(state, batch)
    finally:
        transformer.moe = real
    assert np.isfinite(float(m["loss"])) and "ep_exchanges" not in m
    assert calls and set(calls) == {"sorted"}
    assert not any(counted.values())


@pytest.mark.parametrize("numel,cuts", [(37, [0, 5, 9, 30, 37]),
                                         (64, [0, 8, 16, 64]),
                                         (13, [0, 1, 2, 12, 13])])
def test_bucket_write_in_parts_equals_whole(numel, cuts):
    """`Zero3Bucket.write(start=)`, as the EP step lands a leaf a layer
    and an expert slice at a time: any cut of the leaf into parts writes
    the bucket matrix the whole leaf writes."""
    from repro_torch.core.bucketing import zero3_layout
    n, k = 8, 2
    numels = [11, numel, 5]
    (bk,) = zero3_layout(numels, [torch.float32] * 3, [4] * 3, 1 << 20, n, k)
    leaf = torch.arange(1.0, numel + 1)
    whole, parts = bk.matrix(n, "cpu"), bk.matrix(n, "cpu")
    for m in (whole, parts):
        m.fill_(-1.0)
    bk.write(whole[3], 1, leaf)
    for a, b in zip(cuts, cuts[1:]):
        bk.write(parts[3], 1, leaf[a:b], a)
    assert torch.equal(parts, whole)
    assert torch.equal(bk.read(whole, 1)[3], leaf)


def test_bucketed_ep_step_equals_per_leaf():
    """The EP step on the bucketed path (32 KiB pinned: each rank's
    gradient parts written into the bucket columns) gives the per-leaf
    path's losses and gnorms, in f32."""
    api = _api()
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32)
    data = SyntheticLM(DataConfig(**DATA))
    out = {}
    for bb in (0, 32768):
        shards = train.shard_params_zero3(params, N)
        state = {"params": shards, "opt": adamw_init(shards)}
        step = train.make_manual_train_step(
            api, N, AdamWConfig(lr=LR), sync=SyncConfig(
                strategy="plan", bucket_bytes=bb, params=PAPER_TABLE5),
            device="cpu", param_dtype=torch.float32)
        assert step.ep == ("data", N)
        assert (len(step.scatter_buckets) >= 3) == (bb > 0)
        got = []
        for s in range(2):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data.batch_at(s).items()}
            state, m = step(state, batch)
            got += [float(m["loss"]), float(m["gnorm"])]
        out[bb] = got
    np.testing.assert_allclose(out[32768], out[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# run_training, as the reference's acceptance case
# ---------------------------------------------------------------------------
def test_run_training_deepseek_plan_matches_psum(counted):
    calls = [0]
    real = transformer.moe_ep

    def spy(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    transformer.moe_ep = spy
    try:
        plan = train.run_training(train.TrainConfig(
            arch=ARCH, steps=2, engine="manual", sync="plan", seq_len=16,
            global_batch=8, device="cpu"), smoke=True, on_log=lambda s: None)
    finally:
        transformer.moe_ep = real
    psum = train.run_training(train.TrainConfig(
        arch=ARCH, steps=2, engine="manual", sync="psum", seq_len=16,
        global_batch=8, device="cpu"), smoke=True, on_log=lambda s: None)
    lp, ls = plan["losses"], psum["losses"]
    assert np.all(np.isfinite(lp)) and calls[0] > 0
    assert plan["bucket_plan"] is not None      # the default: bucketed
    assert max(abs(a - b) for a, b in zip(lp, ls)) < 1e-3
    assert not any(counted.values())
