"""What each rank of the process-mesh tests runs (`launch.mesh.launch`
spawns one process a rank and imports these by name, so this module
imports torch and the port only, never the JAX package).

Each worker builds its cases from the same seeds as the test file that
launches it, runs them as its rank and returns plain CPU results; the
test file holds them against the local mesh and the reference."""
import functools

import numpy as np
import torch

# the plans of tests/test_torch_lower.py: (builder, args), input seed
TOPOS = {"flat8": ("single_switch", (8,)),
         "two_level": ("symmetric_tree", (2, 4)),
         "flat6": ("single_switch", (6,))}
SEEDS = {"flat8": 1, "two_level": 2, "flat6": 3}
WIRES = [None, "bf16", "fp8", "int8"]
DTYPES = ["float32", "bfloat16"]
SIZE = 1000                          # AllReduce family, a rank
FAMILY_SIZE = {"all_to_all": 312, "p2p": 300}
KERNELS = ("fused_reduce", "quantize", "quant_reduce", "dequantize")


@functools.lru_cache(maxsize=None)
def schedules(name: str) -> dict:
    """The port's schedules of `name`: the GenTree AllReduce (Table 5
    params) and the flat all-to-all and p2p plans."""
    from repro_torch.core import plans, topology
    from repro_torch.core.cost_model import PAPER_TABLE5
    from repro_torch.core.gentree import gentree
    from repro_torch.core.lower import lower_plan
    builder, args = TOPOS[name]
    topo = getattr(topology, builder)(*args)
    n = topo.num_servers()
    return {"allreduce": lower_plan(gentree(topo, 1e6,
                                            params=PAPER_TABLE5).plan),
            "all_to_all": lower_plan(plans.alltoall_plan(n, 1e6)),
            "p2p": lower_plan(plans.p2p_plan(n, 1e6))}


def lower_inputs(name: str, family: str, n: int) -> np.ndarray:
    size = SIZE if family == "allreduce" else FAMILY_SIZE[family]
    seed = SEEDS[name] + (0 if family == "allreduce" else
                          10 * (1 + list(FAMILY_SIZE).index(family)))
    return np.random.default_rng(seed).standard_normal(
        (n, size)).astype(np.float32)


class Spies:
    """Counts the calls of the fold, quantize and landing wrappers (their
    plain versions run on the CPU, so `ops.LAUNCHES` stays 0): one call is
    one launch on a card."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, {k: 0 for k in KERNELS}
        self.real = {}

    def __enter__(self):
        for name, key in (("fused_reduce_into", "fused_reduce"),
                          ("quantize", "quantize"),
                          ("quant_reduce_into", "quant_reduce"),
                          ("dequantize_into", "dequantize")):
            fn = self.real[name] = getattr(self.ops, name)

            def spy(*a, _f=fn, _k=key, **kw):
                self.calls[_k] += 1
                return _f(*a, **kw)
            setattr(self.ops, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)

    def take(self) -> dict:
        out, self.calls = self.calls, {k: 0 for k in KERNELS}
        return out


def lower_worker(mesh, names) -> dict:
    """Every case of the named plans as this rank: each schedule (through
    the guard) in every wire and dtype, its results, its wrapper calls
    beside `dist_launches`; a schedule of another size on this axis."""
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.core.lower import LoweringError, guard_schedule

    ax, r = "data", mesh.rank
    m = mesh.index(ax)
    out = {}
    with Spies() as spies:
        for name in names:
            for family, cs in schedules(name).items():
                X = lower_inputs(name, family, cs.n)
                for wire in WIRES:
                    w = cs.with_wire(None if wire is None
                                     else PRECISIONS[wire])
                    g = guard_schedule(w)
                    for dt in DTYPES:
                        x = torch.from_numpy(X[r]).to(getattr(torch, dt))
                        if family == "allreduce":
                            sh = g.reduce_scatter(x, ax, mesh)
                            got = {"allreduce": g.allreduce(x, ax, mesh),
                                   "reduce_scatter": sh.clone(),
                                   "all_gather": g.all_gather(sh, ax, mesh)}
                        else:
                            got = {family: getattr(g, family)(x, ax, mesh)}
                        for entry, t in got.items():
                            out[(name, family, wire, dt, entry)] = t
                    # the wrapper calls of one f32 call of each entry
                    x = torch.from_numpy(X[r])
                    entries = (("allreduce", "reduce_scatter", "all_gather")
                               if family == "allreduce" else (family,))
                    for entry in entries:
                        arg = (g.reduce_scatter(x, ax, mesh)
                               if entry == "all_gather" else x)
                        spies.take()
                        getattr(g, entry)(arg, ax, mesh)
                        out[("launches", name, family, wire, entry)] = (
                            spies.take(), w.dist_launches(entry, m))
                    out[("guard", name, family, wire)] = (
                        dict(g.stats), g.demotions)
    other = schedules("flat6" if mesh.size == 8 else "flat8")["allreduce"]
    try:
        other.allreduce(torch.ones(10), ax, mesh)
        out["wrong_axis"] = None
    except LoweringError as e:
        out["wrong_axis"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_collectives.py
# ---------------------------------------------------------------------------
# (strategy, factors) by axis size; the sync configs (SyncConfig kwargs)
FLAT = {8: [("psum", None), ("ring", None), ("rhd", None), ("cps", None),
            ("hcps", (2, 4)), ("hcps", (4, 2)), ("hcps", (2, 2, 2))],
        4: [("psum", None), ("ring", None), ("rhd", None), ("cps", None),
            ("hcps", (2, 2))],
        2: [("psum", None), ("ring", None), ("rhd", None), ("cps", None)],
        6: [("psum", None), ("ring", None), ("rhd", None), ("cps", None),
            ("hcps", (2, 3)), ("hcps", (3, 2))]}
FLAT_SIZE = 1003                     # a rank: every strategy pads
SYNC = {"plan-per-leaf": dict(strategy="plan", bucket_bytes=0),
        "plan-bucketed": dict(strategy="plan"),
        "plan-4KiB-buckets": dict(strategy="plan", bucket_bytes=4096),
        "plan-bf16-wire": dict(strategy="plan", bucket_bytes=4096,
                               precision="bf16", tolerance=1e-2),
        "gentree": dict(strategy="gentree"), "ring": dict(strategy="ring"),
        "hcps": dict(strategy="hcps"), "auto": dict(strategy="auto")}
SYNC_LEAVES = [(64, 33), (1000,), (7, 5, 3), (513,)]
MESHES = {"data8": (("data", 8),), "pod2xdata4": (("pod", 2), ("data", 4)),
          "data6": (("data", 6),)}


def flat_inputs(R: int) -> np.ndarray:
    return np.random.default_rng(7).standard_normal(
        (R, FLAT_SIZE)).astype(np.float32)


def sync_inputs(R: int) -> list:
    rng = np.random.default_rng(11)
    return [rng.standard_normal((R,) + s).astype(np.float32)
            for s in SYNC_LEAVES]


def sync_axes(axes) -> list:
    """The axes leaf-first, as `sync_gradients` takes them."""
    return [tuple(a) for a in reversed(axes)]


def _collectives_case(mesh, key: str) -> dict:
    from repro_torch.core import collectives as C
    from repro_torch.core.sync import SyncConfig, sync_gradients

    R, r = mesh.size, mesh.rank
    out = {}
    X = flat_inputs(R)
    for dt in DTYPES:
        x = torch.from_numpy(X[r]).to(getattr(torch, dt))
        for ax in mesh.axis_names:
            for strat, fac in FLAT[mesh.axis_size(ax)]:
                case = (key, ax, strat, fac, dt)
                out[case + ("allreduce",)] = C.allreduce(
                    x, ax, strat, factors=fac, mesh=mesh)
                sh = C.reduce_scatter(x, ax, strat, factors=fac, mesh=mesh)
                out[case + ("reduce_scatter",)] = sh
                out[case + ("all_gather",)] = C.all_gather(
                    sh, ax, strat, factors=fac, mesh=mesh)
        out[(key, "psum-all", dt)] = C.psum(x, mesh.axis_names, mesh=mesh)
        x24 = x[:FLAT_SIZE - FLAT_SIZE % 24]
        for ax in mesh.axis_names:
            out[(key, "all_to_all", ax, dt)] = C.all_to_all(x24, ax,
                                                            mesh=mesh)
    for label, kw in SYNC.items():
        grads = {f"g{j}": torch.from_numpy(a[r])
                 for j, a in enumerate(sync_inputs(R))}
        stats = {}
        got = sync_gradients(grads, sync_axes(mesh.axes), SyncConfig(**kw),
                             stats=stats, mesh=mesh)
        out[(key, "sync", label)] = (got, stats.get("overlap_mode"))
    return out


def collectives_worker(mesh, keys) -> dict:
    """Every case of `_collectives_case` on this mesh and, where `keys`
    names a second one, on its axes over the same processes."""
    from repro_torch.launch.mesh import init_process_mesh
    out = {}
    for key in keys:
        m = mesh if MESHES[key] == mesh.axes else init_process_mesh(
            MESHES[key], mesh.backend, mesh.device)
        out.update(_collectives_case(m, key))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_train.py
# ---------------------------------------------------------------------------
DATA = dict(vocab=512, seq_len=32, global_batch=8, seed=0)
LR = 1e-3
STEPS = 3
# (label, mesh axes, dtype, bucket_bytes, wire): the reference runs those
# on ("data", 4) at full precision; the lossy wires are held against the
# local mesh alone (tests/test_torch_train_bucketed.py holds the local
# mesh's against the reference)
TRAIN_RUNS = [("f32-per-leaf", (("data", 4),), "float32", 0, None),
              ("f32-bucketed", (("data", 4),), "float32", None, None),
              ("bf16-per-leaf", (("data", 4),), "bfloat16", 0, None),
              ("pod2xdata2-per-leaf", (("pod", 2), ("data", 2)), "float32",
               0, None),
              ("fp8-per-leaf", (("data", 4),), "float32", 0, "fp8"),
              ("int8-bucketed", (("data", 4),), "float32", 32768, "int8")]


def init_params(inputs: dict, dtype: str):
    """The reference's init in `dtype` as the port's tree (bf16 leaves
    crossed as f32, so the cast is exact)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models.tree import tree_from_items
    prefix = f"init/{dtype}/"
    tree = tree_from_items((tuple(k[len(prefix):].split("/")), v)
                           for k, v in sorted(inputs.items())
                           if k.startswith(prefix))

    def cast(t):
        if isinstance(t, list):
            return [cast(x) for x in t]
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(getattr(torch, dtype))
    return cast(params_from_jax(tree))


def train_steps(mesh, inputs: dict, dtype: str, bucket_bytes, wire=None,
                digest: bool = False) -> dict:
    """STEPS steps of the smoke stablelm-12b's ZeRO-3 step on `mesh` (a
    local mesh, or a process mesh) from the reference's init and
    `SyntheticLM` batches, sync "plan" at Table 5: losses, gnorms, the
    final shards; on a process mesh step 1's gathered-copy digest."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import PAPER_TABLE5
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig, adamw_init

    api = build(smoke_config(get_config("stablelm-12b")))
    shards = T.shard_params_zero3(init_params(inputs, dtype), mesh)
    state = {"params": shards, "opt": adamw_init(shards)}
    step = T.make_manual_train_step(
        api, mesh, AdamWConfig(lr=LR), sync=SyncConfig(
            strategy="plan", bucket_bytes=bucket_bytes, precision=wire,
            params=PAPER_TABLE5),
        device="cpu", param_dtype=getattr(torch, dtype))
    data = SyntheticLM(DataConfig(**DATA))
    out = {"losses": [], "gnorms": [], "digest": None,
           "buckets": len(step.scatter_buckets)}
    for s in range(STEPS):
        step.digest = digest and s == 0
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch_at(s).items()}
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
        out["digest"] = m.get("digest", out["digest"])
    out["shards"] = [t.clone() for t in state["params"]]
    return out


def train_worker(mesh, npz: str) -> dict:
    """TRAIN_RUNS as this rank (the (pod, data) run on a second process
    mesh over the same processes); the schedule probe on both meshes;
    the CPS curve, alone and through `TorchProvider(mesh=)`;
    `run_training` on the mesh, as the CLI's ranks run it."""
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.planner.calibrate import (CalibrationConfig,
                                               TorchProvider,
                                               measure_dist_cps)

    inputs = dict(np.load(npz))
    meshes = {mesh.axes: mesh}
    out = {}
    for label, axes, dtype, bucket_bytes, wire in TRAIN_RUNS:
        if axes not in meshes:
            meshes[axes] = init_process_mesh(axes, mesh.backend,
                                             mesh.device)
        out[label] = train_steps(meshes[axes], inputs, dtype, bucket_bytes,
                                 wire, digest=True)
    for axes, m in meshes.items():
        lines = []
        obs = T.observe_sync_probe(None, m, None, 4096.0, lines.append)
        out[("probe", axes)] = ([(o["level"], o["predicted"], o["measured"])
                                 for o in obs], lines)
    out["cps"] = [a.tolist() for a in measure_dist_cps((2, 4, 8), (64, 256),
                                                       mesh)]
    out["provider_cps"] = [a.tolist() for a in TorchProvider(
        mesh=mesh).cps_curve("leaf", None, CalibrationConfig(
            ns=(2, 4), sizes=(128,), backend="torch"))]
    tc = T.TrainConfig(steps=2, engine="manual", sync="plan", device="cpu",
                       seq_len=16, log_every=1, observe_sync=True)
    out["run_training"] = T._train_rank(mesh, tc, True)
    return out
