"""The port's training half against the JAX package's, on the CPU at smoke
size: the data pipeline, AdamW, the ZeRO-3 shards, the axis plan, the
manual ZeRO-3 step on 8 local ranks in f32, and the trainer's scope and
entry points. `test_torch_train_model.py` holds the training forward,
loss and gradients, `test_torch_train_bf16.py` the step in bf16; they
share this file's reference subprocess and helpers, each running the
parts it needs, so that the three run side by side.

One subprocess with 8 forced host devices runs the reference cases: the
reference's `make_manual_train_step` on a plain `jax.sharding.Mesh` (its
`run_training` and `launch/mesh.py` build their meshes with
`jax.make_mesh`, which these tests avoid), with `SyncConfig(strategy=
"plan", bucket_bytes=0, params=PAPER_TABLE5)` on both sides, and for the
"bucketed/" parts (`test_torch_train_bucketed.py`) the bucketed path at
`BUCKETED`'s bucket_bytes. Both
packages train from the reference's own `init_params`, carried over by
`convert.params_from_jax`: in f32 (the reference casts each gathered
leaf to its `params_spec()` dtype, so its side is handed a ModelAPI
whose init is f32) and in bf16, its default. Inputs are made from seeds
with numpy; bf16 arrays cross as f32, which holds them exactly.

Tolerances, against the largest |value| of the compared tensor:
- the batches, the ZeRO-3 shards and the plan: exact;
- AdamW and clipping: 1e-6;
- forward, loss and gradients in f32: 1e-5 (f32 matmuls and sums in
  another order; measured at most 1.9e-6);
- the step's loss and gnorm in f32: 1e-5 relative at every step. After
  step 1 an element whose gradient the two packages round to opposite
  signs (|g| within f32 rounding of 0) moves 2·lr apart, AdamW's first
  update being about lr·sign(g); measured, steps 2 and 3 stay within
  1.1e-7 of the reference, so they are held to step 1's bound;
- the step's loss and gnorm in bf16: 5e-3 relative (a little over one
  bf16 rounding, 2^-8) at every step. The reference folds the reduce-
  scatter's bf16 rows in bf16, rounding after every add; the port folds
  in f32 and rounds once (`kernels/ops.py`); every bf16 matmul rounds
  its output after sums in another order. So the gradients differ by
  bf16 roundings, the gnorm by a share of one, and from step 2 on the
  sign flips above move elements 2·lr apart. Measured: loss 1.2e-4,
  gnorm 1.5e-3 at worst.
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
from repro_torch.core.sync import AxisPlan, SyncConfig, resolve_axis_plans
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import tree_from_items, tree_items
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)

ARCHS = ["stablelm-12b", "gemma2-27b"]
N = 8
DATA = dict(vocab=512, seq_len=32, global_batch=8, seed=0)
STEPS = 3
PROMPT = 48                     # longer than gemma2-27b's smoke window
LR = 1e-3
CLIP = {"active": 10.0, "inactive": 1e-3}   # gradient scale of each case
SPECS = ["stablelm-12b", "gemma2-27b", "stablelm-12b/full"]
# per-step loss and gnorm, relative (module docstring)
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# the bucketed step's bucket_bytes by dtype (`test_torch_train_bucketed.py`):
# pinned in f32 so that the smoke model splits into several buckets, the
# GenModel argmin (None) in bf16
BUCKETED = {"float32": 32768, "bfloat16": None}
# the per-leaf step's other sync labels (`test_torch_train_flat.py`)
FLAT_LABELS = ["ring", "rhd", "cps", "hcps", "gentree", "auto"]
# lossy wires in the trainer (`test_torch_train_bucketed.py`): (wire,
# bucket_bytes) on the one-axis mesh, f32 weights; 0 is the per-leaf path,
# 32 KiB a pinned bucket
LOSSY = [("fp8", 0), ("int8", 0), ("fp8", 32768), ("int8", 32768)]
# the two-level (pod 2, data 4) mesh (`test_torch_train_mesh.py`): (sync
# label, dtype, wire), per leaf
MESH = [("plan", "float32", "f32"), ("ring", "float32", "f32"),
        ("cps", "float32", "f32"), ("hcps", "float32", "f32"),
        ("gentree", "float32", "f32"), ("auto", "float32", "f32"),
        ("plan", "bfloat16", "f32"), ("plan", "float32", "fp8")]
# the checkpointed runs (`test_torch_train_ft.py`): the reference's
# `run_training` (manual engine, sync "plan", its default bucket) for
# FT["steps"] steps, a checkpoint every FT["ckpt_every"], under the card
# soak's fault plan without its payload corruption: (kind, at, target,
# magnitude), the reference soak's mix (tests/test_faults.py) at half its
# steps
FT = dict(steps=12, ckpt_every=3, events=[
    ("delay", 2, "", 0.02), ("device_loss", 4, "", 0.0),
    ("link_degrade", 7, "root_sw", 0.5), ("link_restore", 9, "root_sw", 0.0),
    ("file_corrupt", 10, "checkpoint", 0.0), ("device_loss", 11, "", 0.0)])

_CHILD = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.cost_model import PAPER_TABLE5
from repro.core.sync import SyncConfig, resolve_axis_plans
from repro.data import DataConfig, SyntheticLM
from repro.launch.train import make_manual_train_step, shard_params_zero3
from repro.models import transformer
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import (AdamWConfig, adamw_init, adamw_update,
                         clip_by_global_norm, warmup_cosine)

out_path, in_path, spec = sys.argv[1], sys.argv[2], eval(sys.argv[3])
inp = dict(np.load(in_path))
res = {}


def put(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)            # exact
        res[f"{prefix}/{key}" if key else prefix] = a


def tree(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node = out
            *parents, last = k[len(prefix) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(v)
    return out


def api_of(arch, dtype):
    cfg = smoke_config(get_config(arch))
    return dataclasses.replace(
        build(cfg), init_params=lambda key, dtype=dtype:
        transformer.init_params(key, cfg, dtype))


parts = spec["parts"]
data = SyntheticLM(DataConfig(**spec["data"]))
for k in range(4 if "data" in parts else 0):
    put(f"data/{k}", data.batch_at(k))

for arch in spec["archs"] if "model" in parts else []:
    api = api_of(arch, jnp.float32)
    params = api.init_params(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(inp[f"{arch}/tokens"]),
             "labels": jnp.asarray(inp[f"{arch}/labels"])}
    put(f"{arch}/params", params)
    put(f"{arch}/logits", api.forward(params, batch, remat=False))
    loss, grads = jax.value_and_grad(
        lambda p: api.loss_fn(p, batch, remat=True))(params)
    put(f"{arch}/loss", loss)
    put(f"{arch}/grads", grads)

for arch in spec["specs"] if "model" in parts else []:
    cfg = get_config(arch.split("/")[0])
    if not arch.endswith("/full"):
        cfg = smoke_config(cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(build(cfg).params_spec())
    res[f"spec/{arch}"] = np.array(
        ["/".join(str(p.key) for p in path) + " " + str(l.dtype) + " "
         + " ".join(map(str, l.shape)) for path, l in leaves])

for case in spec["clip"] if "optim" in parts else []:
    p, g = tree("opt/p"), tree(f"opt/g/{case}")
    opt = {"m": tree("opt/m"), "v": tree("opt/v"),
           "step": jnp.asarray(3, jnp.int32)}
    new_p, new_o, gn = adamw_update(p, g, opt, AdamWConfig(lr=1e-2))
    put(f"adamw/{case}/p", new_p)
    put(f"adamw/{case}/m", new_o["m"])
    put(f"adamw/{case}/v", new_o["v"])
    put(f"adamw/{case}/step", new_o["step"])
    put(f"adamw/{case}/gnorm", gn)
    clipped, gn = clip_by_global_norm(g, 1.0)
    put(f"clip/{case}/g", clipped)
    put(f"clip/{case}/gnorm", gn)
if "optim" in parts:
    put("schedule", jnp.stack([warmup_cosine(s, peak=1e-3, warmup=5,
                                             total=20) for s in range(25)]))

mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("data", "model"))
if "optim" in parts:
    put("shard/odd", shard_params_zero3(tree("odd"), mesh))
sync = SyncConfig(strategy="plan", bucket_bytes=0, params=PAPER_TABLE5)


def init_state(dtype, prefix, mesh=mesh):
    api = api_of("stablelm-12b", getattr(jnp, dtype))
    params = api.init_params(jax.random.PRNGKey(0))
    put(f"{prefix}/init", params)
    state = {"params": shard_params_zero3(params, mesh),
             "opt": adamw_init(shard_params_zero3(params, mesh))}
    put(f"{prefix}/shards", state["params"])
    # the moments and the step placed as the step returns them, so its
    # second call does not compile again
    state["opt"] = {k: jax.tree.map(lambda z, p: jax.device_put(z, p.sharding),
                                    state["opt"][k], state["params"])
                    for k in ("m", "v")}
    state["opt"]["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                          NamedSharding(mesh, P()))
    return api, state


# every rank's gathered copy of each leaf, as the reference's step gathers
# it (_gather_leaf under shard_map with the step's plans): (8, numel) rows
# in mesh order
def gathered(api, state, sync, prefix, mesh=mesh):
    from repro.core.compat import shard_map
    from repro.launch.mesh import axis_sizes, dp_axes
    from repro.launch.train import _gather_leaf
    dp, sizes = dp_axes(mesh), axis_sizes(mesh)
    axes = [(a, sizes[a]) for a in dp if sizes[a] > 1]
    leaves = jax.tree.leaves(state["params"])
    plans = resolve_axis_plans(axes, sync, sum(
        float(x.size) for x in leaves) / 8)
    sds = [(tuple(l.shape), l.dtype) for l in jax.tree.leaves(
        api.params_spec())]
    f = jax.jit(shard_map(
        lambda *xs: tuple(_gather_leaf(x[0], sd[0], sd[1], plans).reshape(
            -1)[None] for x, sd in zip(xs, sds)),
        mesh=mesh, in_specs=tuple(P(dp, None) for _ in leaves),
        out_specs=tuple(P(dp) for _ in leaves), check_vma=False))
    for i, o in enumerate(f(*leaves)):
        res[f"{prefix}/gathered/{i}"] = np.asarray(o).astype(np.float32)


def train(api, state, sync, prefix, mesh=mesh):
    step = make_manual_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                                  sync=sync)
    losses, gnorms = [], []
    for s in range(spec["steps"]):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(s)))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    put(f"{prefix}/final", state)
    res[f"{prefix}/losses"] = np.asarray(losses)
    res[f"{prefix}/gnorms"] = np.asarray(gnorms)


for dtype in ("float32", "bfloat16"):
    if f"train/{dtype}" not in parts and f"shards/{dtype}" not in parts:
        continue
    api, state = init_state(dtype, f"train/{dtype}")
    size = sum(float(x.size) for x in jax.tree.leaves(state["params"])) / 8
    (plan,) = resolve_axis_plans([("data", 8)], sync, size)
    res[f"plan/{dtype}/size"] = np.asarray(size)
    res[f"plan/{dtype}/describe"] = np.asarray(plan.schedule.describe())
    if f"train/{dtype}" in parts:
        train(api, state, sync, f"train/{dtype}")
# the bucketed path: SyncConfig's own bucket_bytes (None, the GenModel
# argmin) or a pinned one, and its default backward_overlap
for dtype, bucket_bytes in spec.get("bucketed", {}).items():
    if f"bucketed/{dtype}" not in parts:
        continue
    api, state = init_state(dtype, f"bucketed/{dtype}")
    train(api, state, SyncConfig(strategy="plan", bucket_bytes=bucket_bytes,
                                 params=PAPER_TABLE5), f"bucketed/{dtype}")
# the per-leaf path with the flat labels, "gentree" and "auto" (psum)
for label in spec.get("flat", []):
    if f"flat/{label}" not in parts:
        continue
    api, state = init_state("float32", f"flat/{label}/float32")
    train(api, state, SyncConfig(strategy=label, params=PAPER_TABLE5),
          f"flat/{label}/float32")
# lossy wires in the trainer: SyncConfig(strategy="plan", precision=wire,
# bucket_bytes=bucket_bytes) on the one-axis mesh, f32 weights; each rank's
# gathered copy of the init on the per-leaf path
for wire, bucket_bytes in spec.get("lossy", []):
    tag = f"lossy/{wire}/{bucket_bytes}"
    if f"{tag}/float32" not in parts:
        continue
    sync_w = SyncConfig(strategy="plan", bucket_bytes=bucket_bytes,
                        precision=wire, params=PAPER_TABLE5)
    api, state = init_state("float32", f"{tag}/float32")
    if bucket_bytes == 0:
        gathered(api, state, sync_w, f"{tag}/float32")
    train(api, state, sync_w, f"{tag}/float32")
# the two-level mesh: the reference's engine over ("pod", "data") on a
# plain Mesh, one plan a level; the chunk order of a gather over it
mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("pod", "data"))
if "mesh/order" in parts:
    from repro.core.compat import shard_map
    from repro.launch.train import _gather_leaf
    for label in ("ring", "plan"):
        plans = resolve_axis_plans([("pod", 2), ("data", 4)], SyncConfig(
            strategy=label, params=PAPER_TABLE5), 2.0)
        x = shard_params_zero3({"x": jnp.arange(16, dtype=jnp.float32)},
                               mesh2)["x"]
        f = jax.jit(shard_map(
            lambda v: _gather_leaf(v[0], (16,), jnp.float32, plans)[None],
            mesh=mesh2, in_specs=P(("pod", "data"), None),
            out_specs=P(("pod", "data")), check_vma=False))
        res[f"mesh/order/{label}"] = np.asarray(f(x))
for label, dtype, wire in spec.get("mesh", []):
    tag = f"mesh/{label}/{wire}/{dtype}"
    if tag not in parts:
        continue
    sync_m = SyncConfig(strategy=label, bucket_bytes=0,
                        precision=None if wire == "f32" else wire,
                        params=PAPER_TABLE5)
    api, state = init_state(dtype, tag, mesh2)
    res[f"{tag}/plans"] = np.array([
        f"{p.axis} {p.strategy} {p.factors} "
        + (p.schedule.describe() if p.schedule is not None else "")
        for p in resolve_axis_plans([("pod", 2), ("data", 4)], sync_m, sum(
            float(x.size) for x in jax.tree.leaves(state["params"])) / 8)])
    if wire != "f32":
        gathered(api, state, sync_m, tag, mesh2)
    train(api, state, sync_m, tag, mesh2)
# the checkpointed run under a fault plan: its init state saved as step 0
# (the state run_training builds), then run_training itself, whose
# checkpoints stay in ft/run
if "ft" in parts:
    from repro.checkpoint import CheckpointManager
    from repro.launch.train import TrainConfig, run_training
    from repro.runtime.faults import FaultEvent, FaultInjector, FaultPlan
    ft = spec["ft"]
    params = build(smoke_config(get_config("stablelm-12b"))).init_params(
        jax.random.PRNGKey(0))
    CheckpointManager(ft["dir"] + "/init", async_save=False).save(0, {
        "params": shard_params_zero3(params, mesh),
        "opt": adamw_init(shard_params_zero3(params, mesh))})
    lines = []
    plan = FaultPlan(seed=7, events=tuple(FaultEvent(*e)
                                          for e in ft["events"]))
    with FaultInjector(plan) as inj:
        out = run_training(TrainConfig(
            arch="stablelm-12b", steps=ft["steps"],
            seq_len=spec["data"]["seq_len"],
            global_batch=spec["data"]["global_batch"], lr=spec["lr"],
            engine="manual", sync="plan", ckpt_dir=ft["dir"] + "/run",
            ckpt_every=ft["ckpt_every"], log_every=1, observe_sync=False),
            mesh=mesh, on_log=lines.append)
    res["ft/losses"] = np.asarray(out["losses"])
    res["ft/steps"] = np.asarray([int(l.split()[1]) for l in lines
                                  if l.startswith("step ")])
    res["ft/fired"] = np.asarray([f"{k} {v}" for k, v in
                                  sorted(inj.stats()["fired"].items())])
np.savez(out_path, **res)
"""


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict of numpy leaves stored under `prefix/...`."""
    return tree_from_items(
        (tuple(k[len(prefix) + 1:].split("/")), v)
        for k, v in sorted(flat.items()) if k.startswith(prefix + "/"))


def _leaves(flat: dict, prefix: str) -> list:
    return [v for _, v in tree_items(_tree(flat, prefix))]


def _inputs() -> dict:
    """Every input the reference cases read, from numpy seeds."""
    rng = np.random.default_rng(11)
    out = {}
    for arch in ARCHS:
        vocab = smoke_config(get_config(arch)).vocab
        toks = rng.integers(0, vocab, (2, PROMPT + 1))
        out[f"{arch}/tokens"] = toks[:, :-1].astype(np.int32)
        out[f"{arch}/labels"] = toks[:, 1:].astype(np.int32)
    shapes = {"a": (3, 5), "b/c": (7,), "b/d": (2, 2, 3)}
    for name, shape in shapes.items():
        out[f"opt/p/{name}"] = rng.standard_normal(shape).astype(np.float32)
        out[f"opt/m/{name}"] = (rng.standard_normal(shape) * 0.1
                                ).astype(np.float32)
        out[f"opt/v/{name}"] = (np.abs(rng.standard_normal(shape)) * 0.01
                                ).astype(np.float32)
        g = rng.standard_normal(shape)
        for case, scale in CLIP.items():
            out[f"opt/g/{case}/{name}"] = (g * scale).astype(np.float32)
    # leaves whose sizes are multiples of neither n = 8 nor a schedule's
    # block count
    out["odd/x"] = rng.standard_normal((13,)).astype(np.float32)
    out["odd/y"] = rng.standard_normal((3, 7)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs: at smoke size eight
    threads a process only contend with the other test workers and the
    JAX subprocess (the steps run several times faster on two)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def run_reference(tmp_path_factory, inputs, parts) -> dict:
    """The reference cases of `parts` ("data", "model", "optim", and
    "shards/<dtype>" or "train/<dtype>" for dtype float32 or bfloat16,
    the init, its shards and its plan, and for "train/" the 3 steps;
    "bucketed/<dtype>", the init and 3 bucketed steps; "flat/<label>",
    the init and 3 f32 steps with `SyncConfig(strategy=label)`;
    "lossy/<wire>/<bucket_bytes>/float32" (LOSSY), the init, each rank's
    gathered copy of it (per leaf) and 3 f32 steps on that wire;
    "mesh/<label>/<wire>/<dtype>" (MESH), the same on the (pod 2, data 4)
    mesh; "mesh/order", the gathered vector of arange(16) on it; "ft",
    the reference's `run_training` under FT's plan, its init state saved
    as a step-0 checkpoint in `<ft/dir>/init` and its checkpoints left in
    `<ft/dir>/run`), run in one JAX subprocess."""
    d = tmp_path_factory.mktemp("torch_train")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr({"data": DATA, "archs": ARCHS, "specs": SPECS,
                 "clip": list(CLIP), "lr": LR, "steps": STEPS,
                 "bucketed": BUCKETED, "flat": FLAT_LABELS,
                 "lossy": LOSSY, "mesh": MESH,
                 "ft": {**FT, "dir": str(d / "ft")},
                 "parts": list(parts)})
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(d / "out.npz"),
         str(d / "inputs.npz"), spec],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    if "ft" in parts:
        out["ft/dir"] = str(d / "ft")
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    return run_reference(tmp_path_factory, inputs,
                         ("data", "optim", "shards/float32"))


def _api(arch):
    return build(smoke_config(get_config(arch)))


def _cast(tree, dtype):
    if isinstance(tree, list):
        return [_cast(t, dtype) for t in tree]
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _params(ref, prefix, dtype=torch.float32):
    """The reference's params under `prefix` as the port's (per-layer),
    in `dtype` (bf16 leaves crossed as f32, so the cast is exact)."""
    return _cast(params_from_jax(_tree(ref, prefix)), dtype)


def _batch(inputs, arch):
    return {k: torch.from_numpy(inputs[f"{arch}/{k}"]).long()
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", range(4))
def test_batch_at_matches_reference(ref, k):
    got = SyntheticLM(DataConfig(**DATA)).batch_at(k)
    assert sorted(got) == ["labels", "tokens"]
    for name, v in got.items():
        want = ref[f"data/{k}/{name}"]
        assert v.dtype == want.dtype and np.array_equal(v, want)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_families_do_not_train_yet(arch):
    """The recurrent families refused to train (ROADMAP §1 item 6a) until
    their training recurrences were ported: now `forward`, `loss_fn` and
    one step of `make_manual_train_step` run on a one-layer smoke model
    and give a finite loss (`test_torch_recurrent_train.py` holds them
    against the reference)."""
    api = build(dataclasses.replace(smoke_config(get_config(arch)),
                                    n_layers=1))
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32)
    data = SyntheticLM(DataConfig(vocab=api.cfg.vocab, seq_len=8,
                                  global_batch=N, seed=0))
    batch = {k: torch.from_numpy(v).long()
             for k, v in data.batch_at(0).items()}
    logits = api.forward(params, batch, remat=False)
    assert logits.shape == (N, 8, api.cfg.vocab)
    assert torch.isfinite(api.loss_fn(params, batch, remat=True))
    shards = train.shard_params_zero3(params, N)
    step = train.make_manual_train_step(
        api, N, AdamWConfig(lr=LR), sync=SyncConfig(strategy="psum"),
        device="cpu", param_dtype=torch.float32)
    _, m = step({"params": shards, "opt": adamw_init(shards)}, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt(inputs, what):
    return [torch.from_numpy(np.array(v)) for v in
            _leaves(inputs, f"opt/{what}")]


@pytest.mark.parametrize("case", list(CLIP))
def test_adamw_update_matches_reference(ref, inputs, case):
    p, g = _opt(inputs, "p"), _opt(inputs, f"g/{case}")
    opt = {"m": _opt(inputs, "m"), "v": _opt(inputs, "v"),
           "step": torch.tensor(3, dtype=torch.int32)}
    new_p, new_o, gn = adamw_update(p, g, opt, AdamWConfig(lr=1e-2))
    assert (float(gn) > 1.0) == (case == "active")
    assert _rel(_np(gn), ref[f"adamw/{case}/gnorm"]) <= 1e-6
    assert int(new_o["step"]) == int(ref[f"adamw/{case}/step"]) == 4
    for what, got in (("p", new_p), ("m", new_o["m"]), ("v", new_o["v"])):
        want = _leaves(ref, f"adamw/{case}/{what}")
        assert len(got) == len(want) == 3
        for t, w in zip(got, want):
            assert t.dtype == torch.float32 and _rel(_np(t), w) <= 1e-6


@pytest.mark.parametrize("case", list(CLIP))
def test_clip_by_global_norm_matches_reference(ref, inputs, case):
    clipped, gn = clip_by_global_norm(_opt(inputs, f"g/{case}"), 1.0)
    assert _rel(_np(gn), ref[f"clip/{case}/gnorm"]) <= 1e-6
    for t, w in zip(clipped, _leaves(ref, f"clip/{case}/g"), strict=True):
        assert _rel(_np(t), w) <= 1e-6


def test_warmup_cosine_matches_reference(ref):
    got = torch.stack([warmup_cosine(s, peak=1e-3, warmup=5, total=20)
                       for s in range(25)])
    assert _rel(_np(got), ref["schedule"]) <= 1e-6


def test_adamw_init_is_f32_zeros():
    params = [torch.ones((2, 3), dtype=torch.bfloat16), torch.ones(4)]
    st = adamw_init(params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    for m, v, p in zip(st["m"], st["v"], params, strict=True):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
        assert not m.any() and not v.any()


# ---------------------------------------------------------------------------
# ZeRO-3 layout and the plan
# ---------------------------------------------------------------------------
def check_shards(ref, dtype, prefix="train"):
    """The port's shards of the reference's init, leaf by leaf and in
    order, equal the reference's `shard_params_zero3` rows."""
    params = _params(ref, f"{prefix}/{dtype}/init", getattr(torch, dtype))
    got = train.shard_params_zero3(params, N)
    want = _leaves(ref, f"{prefix}/{dtype}/shards")
    assert len(got) == len(want) == 12
    for t, w in zip(got, want):
        assert t.dtype == getattr(torch, dtype)
        assert t.shape == w.shape and np.array_equal(_np(t), w)


def test_shard_params_zero3_matches_reference(ref, inputs):
    odd = {k: torch.from_numpy(v) for k, v in _tree(inputs, "odd").items()}
    got = train.shard_params_zero3(odd, N)
    for t, w in zip(got, _leaves(ref, "shard/odd"), strict=True):
        assert t.shape == w.shape and np.array_equal(_np(t), w)
    check_shards(ref, "float32")


def test_port_picks_the_reference_plan(ref):
    """One plan for every leaf, looked up at the summed element count of
    one rank's shards: the same size and the same schedule as the
    reference's."""
    step = train.make_manual_train_step(
        _api("stablelm-12b"), N, sync=SyncConfig(
            strategy="plan", bucket_bytes=0, params=PAPER_TABLE5),
        device="cpu")
    (plan,) = step.plans
    assert plan.strategy == "plan" and plan.schedule.blocks_per_shard == 1
    assert plan.schedule.describe() == str(ref["plan/float32/describe"])
    size = sum(-(-t.numel() // N) for _, t in
               tree_items(_api("stablelm-12b").params_spec()))
    assert size == float(ref["plan/float32/size"])


@pytest.mark.parametrize("numel", [13, 21, 64])
def test_gather_and_scatter_of_a_padded_leaf(numel):
    """A leaf of any size round-trips through the planned AllGather, and
    its per-rank gradients reduce-scatter to the shards of their sum."""
    sync = SyncConfig(strategy="plan", bucket_bytes=0, params=PAPER_TABLE5)
    plans = resolve_axis_plans([("data", N)], sync, float(numel))
    rng = np.random.default_rng(numel)
    x = torch.from_numpy(rng.standard_normal(numel).astype(np.float32))
    (shards,) = train.shard_params_zero3({"x": x}, N)
    full = train._gather_leaf(shards, numel, plans)
    assert full.shape == (N, numel) and torch.equal(full, x.expand(N, -1))
    g = torch.from_numpy(rng.standard_normal((N, numel)).astype(np.float32))
    got = train._scatter_leaf(g, plans)
    (want,) = train.shard_params_zero3({"s": g.double().sum(0)}, N)
    assert got.shape == shards.shape
    assert _rel(_np(got), _np(want)) <= 1e-6


def test_rank_batch_splits_or_replicates():
    batch = {"tokens": torch.arange(16).reshape(8, 2),
             "labels": torch.arange(12).reshape(6, 2)}
    got = train._rank_batch(batch, 3, N)
    assert torch.equal(got["tokens"], batch["tokens"][3:4])
    assert torch.equal(got["labels"], batch["labels"])


def test_plan_whose_shards_do_not_line_up_is_refused(monkeypatch):
    """A plan of 24 blocks over 8 ranks pads some leaf past its multiple
    of 8: its reduce-scattered shards would not be the parameter shards,
    so `make_manual_train_step` raises instead of padding."""
    sched = type("S", (), {"num_blocks": 24,
                           "describe": lambda self: "24 blocks"})()
    monkeypatch.setattr(train, "resolve_axis_plans",
                        lambda *a, **k: [AxisPlan("data", "plan",
                                                  schedule=sched)])
    with pytest.raises(ValueError, match="reduce-scatter shards hold"):
        train.make_manual_train_step(_api("stablelm-12b"), N, device="cpu")


def test_unequal_gathered_rows_are_refused(monkeypatch, ref):
    real = train._gather_leaf

    def skewed(shards, numel, plans):
        full = real(shards, numel, plans).clone()
        full[-1, 0] += 1.0
        return full
    monkeypatch.setattr(train, "_gather_leaf", skewed)
    step = train.make_manual_train_step(_api("stablelm-12b"), N,
                                        device="cpu")
    shards = train.shard_params_zero3(_params(ref, "train/float32/init"), N)
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(DataConfig(**DATA)).batch_at(0).items()}
    with pytest.raises(RuntimeError, match="gathered rows"):
        step({"params": shards, "opt": adamw_init(shards)}, batch)


# ---------------------------------------------------------------------------
# the ZeRO-3 step
# ---------------------------------------------------------------------------
def port_run(ref, dtype, sync=None, prefix="train", mesh=N) -> dict:
    """The port's 3 steps in `dtype` from the reference's init (under
    `prefix/dtype`) on the local mesh `mesh`, with every kernel-wrapper
    call counted; `sync` defaults to the per-leaf path."""
    counts = {}
    names = ("fused_reduce_into", "rmsnorm", "flash_attention", "wkv",
             "ssm_scan", "quantize", "dequantize_into", "quant_reduce_into")
    saved = {name: getattr(ops, name) for name in names}

    def counted(name):
        def wrapper(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **k)
        return wrapper
    for name in names:
        setattr(ops, name, counted(name))
    try:
        shards = train.shard_params_zero3(
            _params(ref, f"{prefix}/{dtype}/init", getattr(torch, dtype)),
            mesh)
        state = {"params": shards, "opt": adamw_init(shards)}
        step = train.make_manual_train_step(
            _api("stablelm-12b"), mesh, AdamWConfig(lr=LR),
            sync=sync or SyncConfig(strategy="plan", bucket_bytes=0,
                                    params=PAPER_TABLE5), device="cpu",
            param_dtype=getattr(torch, dtype))
        data = SyntheticLM(DataConfig(**DATA))
        losses, gnorms = [], []
        for s in range(STEPS):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data.batch_at(s).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
    finally:
        for name in names:
            setattr(ops, name, saved[name])
    return {"state": state, "losses": losses, "gnorms": gnorms,
            "step": step, "counts": counts}


def check_steps(ref, run, dtype, prefix="train"):
    """Per-step loss and gnorm within STEP_TOL[dtype] of the reference's;
    the reference's loss falls and every step clips (gnorm > 1)."""
    want_l = ref[f"{prefix}/{dtype}/losses"]
    want_g = ref[f"{prefix}/{dtype}/gnorms"]
    assert (want_g > 1.0).all() and want_l[-1] < want_l[0]
    np.testing.assert_allclose(run["losses"], want_l, rtol=STEP_TOL[dtype],
                               atol=0)
    np.testing.assert_allclose(run["gnorms"], want_g, rtol=STEP_TOL[dtype],
                               atol=0)


def check_launches(run):
    """Each leaf's AllGather and ReduceScatter launch one gathered reduce
    per fold phase of the schedule's halves (the shard reorder and
    unorder included), and the step calls no other kernel wrapper."""
    (plan,) = run["step"].plans
    cs = plan.schedule
    rs = cs.rs + ([cs.reorder] if cs.reorder is not None else [])
    ag = ([cs.unorder] if cs.unorder is not None else []) + cs.ag
    folds = sum(len(st.folds) for st in rs + ag)
    assert run["counts"] == {"fused_reduce_into": STEPS * 12 * folds}


# ---------------------------------------------------------------------------
# scope and entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sync", [
    SyncConfig(),
    SyncConfig(strategy="gentree", bucket_bytes=0),
    SyncConfig(strategy="ring", bucket_bytes=0),
    SyncConfig(strategy="psum", bucket_bytes=0),
    SyncConfig(strategy="plan", bucket_bytes=0, precision="fp8"),
    SyncConfig(strategy="plan", bucket_bytes=0, compress="int8"),
], ids=lambda s: f"{s.strategy}-{s.bucket_bytes}-{s.precision}-{s.compress}")
def test_out_of_scope_sync_raises(sync):
    """`compress` in the trainer raises with its roadmap item (9). The
    flat labels, "gentree" and the default "auto" raised until the flat
    collectives were ported, a bound precision until lossy wires were
    ported to the trainer; now they build the per-leaf step on the
    label's plan ("auto": psum), the fp8 one on the plan's schedule bound
    to the fp8 wire."""
    api = _api("stablelm-12b")
    if sync.compress is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
            train.make_manual_train_step(api, N, sync=sync, device="cpu")
        return
    step = train.make_manual_train_step(api, N, sync=sync, device="cpu")
    (plan,) = step.plans
    assert step.bucket_plan is None and plan.axis == "data"
    if sync.precision is not None:
        assert plan.strategy == "plan" and step.wire == sync.precision
        assert plan.schedule.wire.name == sync.precision
        return
    assert step.wire is None
    want = {"auto": "psum", "gentree": plan.strategy}.get(sync.strategy,
                                                           sync.strategy)
    assert plan.strategy == want in ("psum", "ring", "rhd", "cps", "hcps")


@pytest.mark.parametrize("strategy", ["gentree", "ring", "rhd", "cps",
                                      "hcps", "psum", "auto"])
def test_resolve_axis_plans_takes_plan_only(strategy):
    """Every label of the reference resolves (it raised until the flat
    collectives were ported): a flat label is the axis's plan as it is
    (hcps with the axis's first factorization), "auto" stays the label
    `sync_gradients` reads as one psum, "gentree" is the planner's label
    for the axis; an unknown label raises."""
    plans = resolve_axis_plans([("data", N), ("pod", 1)], SyncConfig(
        strategy=strategy, bucket_bytes=0, params=PAPER_TABLE5), 1e3)
    (plan,) = plans
    assert plan.axis == "data" and plan.schedule is None
    if strategy == "gentree":
        assert plan.strategy in ("ring", "rhd", "cps", "hcps")
        assert plan.predicted is not None
    else:
        assert plan.strategy == strategy
        assert plan.factors == ((2, 2, 2) if strategy == "hcps" else None)
    with pytest.raises(ValueError, match="unknown sync strategy"):
        resolve_axis_plans([("data", N)], SyncConfig(strategy="tree"), 1e3)


@pytest.mark.parametrize("field,value,item", [
    ("engine", "auto", "item"), ("sync", "gentree", "item 4"),
    ("sync", "auto", "item 4"), ("ckpt_dir", "ckpt", "item 5"),
    ("fault_plan", "seed=7,steps=20", "item 5"),
    # the multi-process executor was item 4b and is item 8; the ID stays
    pytest.param("observe_sync", True, "item 8",
                 id="observe_sync-True-item 4"),
])
def test_out_of_scope_train_config_raises(field, value, item, tmp_path,
                                          monkeypatch):
    """What the manual trainer still refuses raises with its roadmap item.
    `sync` "gentree" and "auto" raised (item 4) until the flat
    collectives were ported: with engine="manual" they now pass the scope
    check, and an unknown label raises ValueError. `ckpt_dir` and
    `fault_plan` raised (item 5) until checkpoints and the fault loop
    were ported: now the run trains and writes LATEST, or arms its plan
    and reports what fired. `engine` "auto" raised (item 8d) until the
    auto engine was ported: now it trains one step on the CPU, and an
    unknown engine raises ValueError."""
    tc = dataclasses.replace(train.TrainConfig(
        steps=1, engine="manual", sync="plan", device="cpu", seq_len=16),
        **{field: value})
    if field == "engine":
        logs = []
        out = train.run_training(tc, on_log=logs.append)
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
        assert out["plans"] == [] and out["bucket_plan"] is None
        assert logs[0].startswith("auto engine: one device (cpu)")
        with pytest.raises(ValueError, match="unknown engine"):
            train._check_train_scope(dataclasses.replace(tc, engine="pjit"))
        return
    if field == "sync":
        assert train._check_train_scope(tc) is None
        with pytest.raises(ValueError, match="unknown sync strategy"):
            train._check_train_scope(dataclasses.replace(tc, sync="tree"))
        return
    if field in ("ckpt_dir", "fault_plan"):
        from repro_torch.runtime.faults import ENV_VAR, FaultPlan
        monkeypatch.delenv(ENV_VAR, raising=False)
        monkeypatch.chdir(tmp_path)           # "ckpt" is a relative dir
        logs = []
        out = train.run_training(tc, on_log=logs.append)
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
        if field == "ckpt_dir":
            assert (tmp_path / value / "LATEST").read_text() \
                == "step_00000001"
        else:
            plan = FaultPlan.parse(value)
            assert f"chaos: armed fault plan {plan.key()} " \
                f"({len(plan.events)} events)" in logs
            assert "chaos: injector fired {}" in logs
        return
    with pytest.raises(NotImplementedError, match=item):
        train.run_training(tc, on_log=lambda *_: None)


def test_observe_sync_probe_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        train.observe_sync_probe(None, [("data", N)], 1e3)


def test_run_training_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tc = train.TrainConfig(steps=1, engine="manual", sync="plan")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_training(tc, on_log=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_manual_train_step(_api("stablelm-12b"), N)


def test_run_training_on_the_cpu():
    logs = []
    out = train.run_training(
        train.TrainConfig(steps=3, seq_len=32, engine="manual", sync="plan",
                          device="cpu", log_every=1),
        on_log=logs.append)
    assert len(out["losses"]) == len(out["gnorms"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert out["phase_ms"] == [None] * 3        # no card: no device time
    (plan,) = out["plans"]
    assert plan.strategy == "plan" and plan.schedule.demotions == 0
    assert any(line.startswith("planner cache:") for line in logs)
    shards = out["state"]["params"]
    assert len(shards) == 12
    assert all(s.dtype == torch.bfloat16 and s.shape[0] == N for s in shards)


def test_cli_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--engine", "manual", "--sync", "plan", "--smoke",
        "--steps", "2", "--seq-len", "16", "--device", "cpu"])
    train.main()
    out = capsys.readouterr().out
    assert "step     0" in out and "final loss:" in out
