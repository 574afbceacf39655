"""What each rank of the process-mesh tests runs (`launch.mesh.launch`
spawns one process a rank and imports these by name, so this module
imports torch and the port only, never the JAX package).

Each worker builds its cases from the same seeds as the test file that
launches it, runs them as its rank and returns plain CPU results; the
test file holds them against the local mesh and the reference."""
import contextlib
import functools
import itertools

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
                          ("fused_reduce", "fused_reduce"),
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


# ---------------------------------------------------------------------------
# tests/test_torch_dist_ep.py
# ---------------------------------------------------------------------------
EP_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
EP_DATA = dict(seq_len=32, global_batch=8, seed=0)
# (label, SyncConfig kwargs): the planned exchange per leaf, the flat copy
# program under a flat label
EP_SYNC = {"plan": dict(strategy="plan", bucket_bytes=0),
           "ring": dict(strategy="ring")}


def ep_train_steps(mesh, arch: str, label: str, inputs: dict | None = None,
                   steps: int = STEPS) -> dict:
    """`steps` f32 steps of the smoke `arch`'s ZeRO-3 step on `mesh` (a
    local mesh or a process mesh) from seeded weights (or the
    reference's f32 init in `inputs`) and `SyntheticLM` batches, sync
    EP_SYNC[label] at Table 5: losses, gnorms, the exchanges a step, the
    final shards."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import PAPER_TABLE5
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig, adamw_init

    api = build(smoke_config(get_config(arch)))
    params = (init_params(inputs, "float32") if inputs is not None else
              api.init_params(torch.Generator().manual_seed(0),
                              torch.float32))
    shards = T.shard_params_zero3(params, mesh)
    state = {"params": shards, "opt": adamw_init(shards)}
    step = T.make_manual_train_step(
        api, mesh, AdamWConfig(lr=LR),
        sync=SyncConfig(params=PAPER_TABLE5, **EP_SYNC[label]),
        device="cpu", param_dtype=torch.float32)
    data = SyntheticLM(T.data_config(api.cfg, **EP_DATA))
    out = {"losses": [], "gnorms": [], "ex": [], "ep": step.ep,
           "planned": step.ep_schedule is not None}
    for s in range(steps):
        state, m = step(state, T.batch_tensors(data.batch_at(s), "cpu"))
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
        out["ex"].append(m.get("ep_exchanges"))
    out["shards"] = [t.clone() for t in state["params"]]
    return out


EP_MESHES = {"data4": (("data", 4),),
             "pod2xdata2": (("pod", 2), ("data", 2))}


def ep_worker(mesh, cases, npz: str) -> dict:
    """Each (arch, label, from the reference's init, mesh key) of `cases`
    as this rank (the init read from `npz`; a mesh of other axes over
    the same processes)."""
    from repro_torch.launch.mesh import init_process_mesh
    inputs = dict(np.load(npz))
    meshes = {mesh.axes: mesh}
    out = {}
    for arch, label, ref, key in cases:
        axes = EP_MESHES[key]
        if axes not in meshes:
            meshes[axes] = init_process_mesh(axes, mesh.backend, mesh.device)
        out[(arch, label, key)] = ep_train_steps(
            meshes[axes], arch, label, inputs if ref else None)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_ft.py
# ---------------------------------------------------------------------------
# the checkpointed trainer's soak (tests/test_torch_train_ft.py's, at
# smoke size, bf16, the bucket pinned to 32 KiB) on 4 ranks: the fault
# plan's events (kind, at, target, magnitude), a payload corruption in
# the gather of bucket FT_PAYLOAD[1] of the first run of step 8, after
# FT_PAYLOAD[0] completed step calls
FT_RUN = dict(arch="stablelm-12b", steps=12, seq_len=32, global_batch=8,
              lr=1e-3, engine="manual", sync="plan", device="cpu",
              ckpt_every=3, log_every=1000, bucket_bytes=32768)
FT_EVENTS = [("delay", 2, "", 0.02), ("device_loss", 4, "", 0.0),
             ("link_degrade", 7, "root_sw", 0.5),
             ("link_restore", 9, "root_sw", 0.0),
             ("file_corrupt", 10, "checkpoint", 0.0),
             ("device_loss", 11, "", 0.0)]
FT_PAYLOAD = (9, 5)
FT_COUNTERS = ("ft_restarts_total", "ckpt_restore_fallbacks_total",
               "guarded_failures_total", "faults_files_corrupted_total")


def ft_config(ckpt_dir, **kw):
    from repro_torch.launch import train as T
    return T.TrainConfig(**{**FT_RUN, "ckpt_dir": str(ckpt_dir), **kw})


def ft_plan(payload_ordinal=None):
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    extra = () if payload_ordinal is None else (
        FaultEvent("payload_corrupt", payload_ordinal),)
    return FaultPlan(seed=7, events=tuple(FaultEvent(*e) for e in FT_EVENTS)
                     + extra)


def ft_run(mesh, ckpt_dir, plan, **kw) -> dict:
    """`run_training` with a checkpoint directory under `plan` (an empty
    plan masks any ambient one): its step calls, losses, final state
    (CPU copies), the resumes it logged, the injector's guarded-launch
    count and fired events, and the fault counters it moved."""
    from repro_torch.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.launch import train as T
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.runtime.metrics import default_metrics

    lines = []
    before = {k: default_metrics().counter(k).value for k in FT_COUNTERS}
    with FaultInjector(plan) as inj:
        out = T.run_training(ft_config(ckpt_dir, **kw), mesh=mesh,
                             on_log=lines.append)
    leaves, _ = tree_flatten(out["state"])
    step = out["step"]
    return {"steps": out["steps"], "losses": out["losses"],
            "state": tree_unflatten(out["state"], [
                x.detach().clone() if isinstance(x, torch.Tensor) else x
                for x in leaves]),
            "resumes": [ln for ln in lines if ln.startswith("ft: resume")],
            "launches": inj.stats()["launches"],
            "fired": inj.stats()["fired"],
            "delta": {k: default_metrics().counter(k).value - before[k]
                      for k in FT_COUNTERS},
            "buckets": (len(step.gather_buckets), len(step.scatter_buckets)),
            "restarts": out["loop"].restarts,
            "demotions": sum(pl.schedule.demotions for pl in out["plans"])}


def ft_worker(mesh, root: str, part_steps) -> dict:
    """As this rank: the fault-free soak, then the faulted one (its
    payload ordinal from the fault-free run's buckets); with
    `part_steps` a run of that many steps into root/part, which a fresh
    launch resumes (`ft_resume_worker`)."""
    import os
    from repro_torch.runtime.faults import FaultPlan

    out = {"clean": ft_run(mesh, os.path.join(root, "clean"), FaultPlan())}
    ag, rs = out["clean"]["buckets"]
    after, bucket = FT_PAYLOAD
    out["chaos"] = ft_run(mesh, os.path.join(root, "chaos"),
                          ft_plan(after * (ag + rs) + bucket))
    if part_steps:
        out["part"] = ft_run(mesh, os.path.join(root, "part"), FaultPlan(),
                             steps=part_steps)
    return out


def ft_resume_worker(mesh, root: str) -> dict:
    """A fresh launch's rank resuming root/part to FT_RUN's steps."""
    import os
    from repro_torch.runtime.faults import FaultPlan
    return ft_run(mesh, os.path.join(root, "part"), FaultPlan())


def ft_one_rank_fails_worker(mesh, root: str) -> None:
    """The fault loop where rank 1 alone fails a real (not injected)
    launch at its 40th fold: the run must end with that error."""
    import os
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import FaultPlan

    if mesh.rank == 1:
        real, calls = ops.fused_reduce_into, [0]

        def failing(*a, **kw):
            calls[0] += 1
            if calls[0] == 40:
                raise RuntimeError("rank 1's launch failed (simulated)")
            return real(*a, **kw)
        ops.fused_reduce_into = failing
    ft_run(mesh, os.path.join(root, "fails"), FaultPlan(), steps=4)


# ---------------------------------------------------------------------------
# tests/test_torch_dist_serve.py
# ---------------------------------------------------------------------------
SERVE = dict(arch="stablelm-12b", batch=2, prompt_len=8, max_new=4,
             cache_len=32, device="cpu")


def serve_worker(mesh) -> dict:
    """The smoke server as this rank of a ("model", n) process mesh: its
    tokens (rank 0's), self-check error, timings and the planner's
    observation of the decode plan."""
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.planner.service import default_service
    lines = []
    out = serve(ServeConfig(**SERVE), smoke=True, mesh=mesh,
                on_log=lines.append)
    return {"tokens": out["tokens"], "err": out["self_check_err"],
            "timings": out["timings"], "lines": lines,
            "algo": out["tp_exec"].algo,
            "stats": dict(out["tp_schedule"].stats),
            "observed": [ln for ln in lines if "observed decode" in ln]}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_planned.py
# ---------------------------------------------------------------------------
PLANNED_MESHES = {"data4": (("data", 4),),
                  "pod2xdata2": (("pod", 2), ("data", 2))}
PLANNED_SIZE = 1003                    # a rank: every route pads
# (route, allreduce_planned kwargs beside the service): the plan, the plan
# at two wires, the tolerance-priced wire, the bucket executor at a
# pinned 1 KiB bucket and at a bf16 wire, the flat-label fallback
PLANNED_ROUTES = {
    "plan": {}, "bf16-wire": {"precision": "bf16"},
    "fp8-wire": {"precision": "fp8"}, "tolerance": {"tolerance": 1e-2},
    "bucketed": {"bucketing": ("bucket", 1024)},
    "bucketed-bf16": {"bucketing": ("bucket", 1024), "precision": "bf16"},
    "fallback": {}}
INT8_SYNC = {"cps": dict(strategy="cps", compress="int8"),
             "hcps": dict(strategy="hcps", compress="int8")}


def planned_inputs(R: int) -> np.ndarray:
    return np.random.default_rng(23).standard_normal(
        (R, PLANNED_SIZE)).astype(np.float32)


def planned_service(route: str, n: int, size: int):
    """A fresh service at Table 5; for "fallback" one whose plan for the
    (n, size) axis carries no block annotations, so it cannot lower."""
    from repro_torch.core.cost_model import PAPER_TABLE5
    from repro_torch.core.sync import level_switch_topo
    from repro_torch.planner.service import PlannerService
    svc = PlannerService(params=PAPER_TABLE5)
    if route == "fallback":
        eff = svc._effective_axis_params()
        svc.get_plan(level_switch_topo(n, eff, "root_sw"), size * 4.0,
                     params=eff).plan.num_blocks = None
    return svc


def planned_kwargs(route: str) -> dict:
    from repro_torch.core.bucketing import BucketConfig
    kw = dict(PLANNED_ROUTES[route])
    if "bucketing" in kw:
        kw["bucketing"] = BucketConfig(bucket_bytes=kw["bucketing"][1])
    return kw


def _planned_case(mesh, key: str) -> dict:
    import warnings

    from repro_torch.core import collectives as C
    from repro_torch.core.sync import (SyncConfig, allreduce_int8_cps,
                                       sync_gradients)

    R, r = mesh.size, mesh.rank
    X = planned_inputs(R)
    out = {}
    with Spies() as spies:
        for ax in mesh.axis_names:
            n = mesh.axis_size(ax)
            for route in PLANNED_ROUTES:
                svc = planned_service(route, n, PLANNED_SIZE)
                st = {}
                x = torch.from_numpy(X[r])
                spies.take()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    got = C.allreduce_planned(x, ax, service=svc, stats=st,
                                              mesh=mesh,
                                              **planned_kwargs(route))
                out[(key, "planned", ax, route)] = (got, st, spies.take())
            x = torch.from_numpy(X[r])
            spies.take()
            out[(key, "int8", ax)] = (allreduce_int8_cps(x, ax, mesh=mesh),
                                      spies.take())
        for label, kw in INT8_SYNC.items():
            grads = {f"g{j}": torch.from_numpy(a[r])
                     for j, a in enumerate(sync_inputs(R))}
            out[(key, "sync-int8", label)] = sync_gradients(
                grads, sync_axes(mesh.axes), SyncConfig(**kw), mesh=mesh)
    return out


def planned_worker(mesh, keys, serve_too: bool) -> dict:
    """Every case of `_planned_case` on each mesh of `keys` over these
    processes; with `serve_too` the smoke server on ("model", n) too."""
    from repro_torch.launch.mesh import init_process_mesh
    out = {}
    for key in keys:
        m = mesh if PLANNED_MESHES[key] == mesh.axes else init_process_mesh(
            PLANNED_MESHES[key], mesh.backend, mesh.device)
        out.update(_planned_case(m, key))
    if serve_too:
        out["serve"] = serve_worker(init_process_mesh(
            (("model", mesh.size),), mesh.backend, mesh.device))
    return out


def ckpt_mismatch_worker(mesh, root: str):
    """A checkpoint of one leaf shape, restored on a process mesh into a
    tree of another: the class and message each rank raised."""
    from repro_torch.checkpoint import CheckpointManager, LeafMismatch
    mgr = CheckpointManager(root, keep=2, async_save=False, mesh=mesh)
    mgr.save(1, {"a": torch.full((4,), float(mesh.rank))})
    try:
        mgr.restore({"a": torch.zeros(5)})
    except LeafMismatch as e:
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# the auto engine (tests/test_torch_dist_auto.py)
# ---------------------------------------------------------------------------
AUTO_SEQ, AUTO_BATCH = 32, 8
AUTO_LR = 1e-3
AUTO_STEPS = 3
# the smoke stablelm-12b's vocabulary widened so that its embedding and
# head (64 × 4,096) reach REPLICATE_BELOW and shard (every smoke leaf
# replicates otherwise)
WIDE = {"vocab": 4096}
# (label, arch, dtype, mesh, fsdp, config overrides, batch): the mesh
# "4x1" is ("data", 4), "2x2x1" ("pod", 2) × ("data", 2); the batch
# "masked" is the dense one with rank 0's rows mostly masked out
AUTO_RUNS = [
    ("dense-fsdp", "stablelm-12b", "float32", "4x1", True, WIDE, "dense"),
    ("dense-zero1", "stablelm-12b", "float32", "4x1", False, WIDE, "dense"),
    ("dense-bf16", "stablelm-12b", "bfloat16", "4x1", True, WIDE, "dense"),
    ("dense-pod", "stablelm-12b", "float32", "2x2x1", True, WIDE, "dense"),
    ("dense-mask", "stablelm-12b", "float32", "4x1", True, WIDE, "masked"),
    ("moe-groups", "deepseek-moe-16b", "float32", "4x1", True, {}, "moe"),
    ("moe-global", "deepseek-moe-16b", "float32", "4x1", True,
     {"moe_groups": 0}, "moe"),
    ("moe-local", "deepseek-moe-16b", "float32", "4x1", True,
     {"moe_local": True}, "moe"),
]
AUTO_AXES = {"4x1": (("data", 4),), "2x2x1": (("pod", 2), ("data", 2))}
# the reference's test_manual_engines_match_auto, over 4 processes
AUTO_VS_MANUAL = dict(arch="rwkv6-1.6b", steps=8, seq_len=32,
                      global_batch=8, lr=1e-3, log_every=1000,
                      device="cpu")
AUTO_CKPT = dict(arch="stablelm-12b", steps=4, seq_len=32, global_batch=8,
                 lr=1e-3, ckpt_every=2, log_every=1000, device="cpu")


def auto_api(arch: str, overrides: dict):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    return build(dataclasses.replace(smoke_config(get_config(arch)),
                                     **overrides))


def auto_init(inputs: dict, label: str, dtype: str, api=None) -> dict:
    """The reference's init of run `label` as the port's tree, each leaf
    in the dtype the port's own init in `dtype` gives it (a MoE router
    and the SSM's f32 leaves stay f32; bf16 crossed as f32, exactly).
    `api` is the run's model (default its `AUTO_RUNS` entry's)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models.tree import tree_from_items
    if api is None:
        run = {r[0]: r for r in AUTO_RUNS}.get(label)
        api = auto_api(run[1] if run else label.split("/")[0],
                       run[5] if run else {})
    prefix = f"init/{label}/"
    tree = tree_from_items((tuple(k[len(prefix):].split("/")), v)
                           for k, v in sorted(inputs.items())
                           if k.startswith(prefix))

    def cast(t, like):
        if isinstance(t, list):
            return [cast(x, y) for x, y in zip(t, like, strict=True)]
        if isinstance(t, dict):
            return {k: cast(v, like[k]) for k, v in t.items()}
        return t.to(like.dtype)
    return cast(params_from_jax(tree), api.meta_params(getattr(torch, dtype)))


def auto_batch(inputs: dict, bkey: str, s: int) -> dict:
    from repro_torch.launch import train as T
    pre = f"batch/{bkey}/{s}/"
    return T.batch_tensors({k[len(pre):]: v for k, v in inputs.items()
                            if k.startswith(pre)}, "cpu")


def auto_steps(mesh, inputs: dict, label: str, arch: str, dtype: str,
               fsdp: bool, overrides: dict, bkey: str,
               steps: int = AUTO_STEPS) -> dict:
    """`steps` steps of the auto engine on `mesh` (None: one device, the
    CPU; or a process mesh) from the reference's init of `label`: losses,
    gnorms, the final parameters' local tensors."""
    from repro_torch.launch import train as T
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _local

    api = auto_api(arch, overrides)
    step, _, _ = T.make_train_step(api, mesh, AdamWConfig(lr=AUTO_LR),
                                   fsdp=fsdp, device="cpu")
    state = T.place_state(auto_init(inputs, label, dtype, api), mesh,
                          step.placements)
    out = {"losses": [], "gnorms": []}
    for s in range(steps):
        _, m = step(state, auto_batch(inputs, bkey, s))
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
    out["params"] = [_local(p).clone() for p in state["params"]]
    out["placements"] = [tuple(repr(p) for p in pl)
                         for pl in step.placements["params"]]
    out["moment_placements"] = [tuple(repr(p) for p in pl)
                                for pl in step.placements["opt"]["m"]]
    return out


def auto_local_dispatch_loss(mesh, inputs: dict, label: str, arch: str,
                             overrides: dict, bkey: str) -> float:
    """The first step's loss as a rank-local dispatch would give it (no
    mesh context: each rank blocks its own tokens), summed over the
    ranks as the auto step sums its losses."""
    from repro_torch.core.transport import all_gather_rows
    from repro_torch.launch import train as T

    api = auto_api(arch, overrides)
    batch = auto_batch(inputs, bkey, 0)
    line = mesh.line(mesh.axis_names)
    rows = T._rank_batch(batch, line.index, line.size)
    with torch.no_grad():
        loss = api.loss_fn(auto_init(inputs, label, "float32", api), rows)
    part = loss * rows["labels"].numel() / batch["labels"].numel()
    return float(all_gather_rows(mesh, line, part.reshape(1)).sum())


def gather_c10d_cases(meshes: dict) -> list:
    """`train.gather_c10d` against DTensor's own Shard → Replicate, for a
    (6, 8, 4) leaf at every placement of one or two sharded dims that
    split it evenly on both meshes: (mesh, placements, equal)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    x = torch.arange(6 * 8 * 4, dtype=torch.float32).reshape(6, 8, 4)
    out = []
    for name, pm in meshes.items():
        dm = M.device_mesh(pm)
        options = [Replicate(), Shard(1), Shard(2)] + (
            [Shard(0)] if pm.axes[0][1] == 2 else [])
        for pls in itertools.product(options, repeat=dm.ndim):
            ways = [1, 1, 1]
            for q, (_, n) in zip(pls, pm.axes):
                if isinstance(q, Shard):
                    ways[q.dim] *= n
            if all(isinstance(q, Replicate) for q in pls) or any(
                    x.shape[i] % w for i, w in enumerate(ways)):
                continue
            whole = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                       run_check=False)
            d = whole.redistribute(dm, list(pls))
            got = T.gather_c10d(d, pm)
            want = d.redistribute(dm, [Replicate()] * dm.ndim).to_local()
            out.append((name, repr(pls), torch.equal(got, want)
                        and torch.equal(got, x)))
    return out


def auto_worker(mesh, npz_init: str, npz_batches: str, root: str) -> dict:
    """AUTO_RUNS as this rank (the (pod, data) run on a second process
    mesh over the same processes); the rank-local dispatch's loss of the
    capacity-bound MoE run; the device mesh's names and shape; the
    reference's manual-against-auto comparison; a checkpoint restart."""
    import os

    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T

    inputs = {**dict(np.load(npz_init)), **dict(np.load(npz_batches))}
    meshes = {"4x1": mesh, "2x2x1": M.init_process_mesh(
        AUTO_AXES["2x2x1"], mesh.backend, mesh.device)}
    res = {}
    for label, arch, dtype, mname, fsdp, overrides, bkey in AUTO_RUNS:
        res[label] = auto_steps(meshes[mname], inputs, label, arch, dtype,
                                fsdp, overrides, bkey)
    res["moe-global-local-dispatch"] = auto_local_dispatch_loss(
        mesh, inputs, "moe-global", "deepseek-moe-16b", {"moe_groups": 0},
        "moe")
    dm = M.device_mesh(meshes["2x2x1"])
    res["device_mesh"] = (tuple(dm.mesh_dim_names), tuple(dm.shape),
                          tuple(dm.get_coordinate()))
    res["gather_c10d"] = gather_c10d_cases(meshes)

    def quiet(_msg):
        pass
    res["engines"] = {engine: T.run_training(T.TrainConfig(
        **AUTO_VS_MANUAL, engine=engine, sync="plan", bucket_bytes=0),
        mesh=mesh, on_log=quiet)["losses"] for engine in ("auto", "manual")}
    ck = {}
    for name, steps in (("full", 4), ("part", 2), ("resumed", 4)):
        out = T.run_training(T.TrainConfig(
            **{**AUTO_CKPT, "steps": steps}, engine="auto",
            ckpt_dir=os.path.join(root, "part" if name == "resumed"
                                  else name)), mesh=mesh, on_log=quiet)
        ck[name] = (out["losses"], out["steps"])
    res["ckpt"] = ck
    return res


# ---------------------------------------------------------------------------
# tensor parallelism on the auto engine's "model" axis
# (tests/test_torch_dist_tp.py, tests/test_torch_dist_tp_rest.py)
# ---------------------------------------------------------------------------
# the smoke models widened so that every kind of "model" spec occurs on a
# line of 2 or 4: the (2, 64, 2048) gate and up products on their output
# dim (column), the down product on its contraction dim (row), the
# (4096, 64) embedding on its hidden dim, the (64, 4096) head on its
# vocabulary; the attention leaves stay under REPLICATE_BELOW
# (replicated). A MoE model's (2, 8, 64, 256) experts shard as the MLP's
TP_DENSE = {"vocab": 4096, "d_ff": 2048}
TP_MOE = {"vocab": 4096, "d_ff_expert": 256}
TP_AXES = {"2x2": (("data", 2), ("model", 2)),
           "1x4": (("data", 1), ("model", 4)),
           "2x1x2": (("pod", 2), ("data", 1), ("model", 2))}
# (label, arch, dtype, mesh, fsdp, config overrides, batch)
TP_FAMILY = [(arch, arch, "float32", "2x2", True,
              TP_MOE if "moe" in arch or "mixtral" in arch else TP_DENSE,
              arch)
             for arch in ("stablelm-12b", "gemma2-27b", "qwen3-32b",
                          "gemma3-4b", "deepseek-moe-16b", "mixtral-8x22b",
                          "qwen2-vl-7b", "rwkv6-1.6b", "hymba-1.5b",
                          "whisper-large-v3")]
TP_RUNS = TP_FAMILY + [
    ("stablelm-bf16", "stablelm-12b", "bfloat16", "2x2", True, TP_DENSE,
     "stablelm-12b"),
    ("stablelm-zero1", "stablelm-12b", "float32", "2x2", False, TP_DENSE,
     "stablelm-12b"),
    ("stablelm-1x4", "stablelm-12b", "float32", "1x4", True, TP_DENSE,
     "stablelm-12b"),
    ("stablelm-pod", "stablelm-12b", "float32", "2x1x2", True, TP_DENSE,
     "stablelm-12b"),
    ("stablelm-mask", "stablelm-12b", "float32", "2x2", True, TP_DENSE,
     "masked"),
]
# the transformer families (test_torch_dist_tp.py) and the rest
TP_REST = ("rwkv6-1.6b", "hymba-1.5b", "whisper-large-v3")
# the step whose model-line traffic test_torch_dist_tp_rest.py reads:
# (label, arch, overrides, REPLICATE_BELOW or None for the rule's own):
# under a threshold of 64 the "model" line shards nearly every leaf, the
# norms, RWKV6's mixes, decay and bonus and the SSM's decays too, which
# the forward gathers where it uses them outside a product
TP_CENSUS = [("stablelm-12b", "stablelm-12b", TP_DENSE, None),
             ("qwen3-32b-all", "qwen3-32b", TP_DENSE, 64),
             ("mixtral-8x22b-all", "mixtral-8x22b", TP_MOE, 64),
             ("rwkv6-1.6b-all", "rwkv6-1.6b", TP_DENSE, 64),
             ("hymba-1.5b-all", "hymba-1.5b", TP_DENSE, 64)]
# a checkpointed run_training on ("data", 2) x ("model", 2): the smoke
# stablelm-12b, its leaves sharded on "model" under a threshold of 1,024
TP_CKPT = dict(arch="stablelm-12b", steps=4, seq_len=32, global_batch=8,
               lr=1e-3, ckpt_every=2, log_every=1000, device="cpu")
TP_CKPT_BELOW = 1024


def tp_meshes(mesh) -> dict:
    """TP_AXES' process meshes over the 4 processes of `mesh` ("2x2")."""
    from repro_torch.launch import mesh as M
    return {name: mesh if name == "2x2" else
            M.init_process_mesh(axes, mesh.backend, mesh.device)
            for name, axes in TP_AXES.items()}


@contextlib.contextmanager
def replicate_below(n):
    """`launch.sharding.REPLICATE_BELOW` at n for the block (None: as it
    is)."""
    from repro_torch.launch import sharding as shr
    old = shr.REPLICATE_BELOW
    shr.REPLICATE_BELOW = old if n is None else n
    try:
        yield
    finally:
        shr.REPLICATE_BELOW = old


def tp_census(mesh, inputs: dict, arch: str, overrides: dict,
              below) -> dict:
    """One auto step on `mesh` from the seeded f32 init, reading the
    model line: each call of the four operators of `core.transport`
    (op, the input's shape, the parameter leaf it is, or None), each
    torch call that takes a model-sharded parameter leaf (function, leaf,
    its shape, its whole shape), the bytes this rank sent over the line,
    the loss and gnorm."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.core import transport
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.models import actsharding
    from repro_torch.optim import AdamWConfig

    calls, uses = [], []

    def spy(name, fn):
        def wrapped(mesh_, line, x, *a):
            ctx = actsharding.tp_context()
            calls.append((name, tuple(x.shape), ctx.paths.get(id(x))))
            return fn(mesh_, line, x, *a)
        return wrapped

    class Uses(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            ctx = actsharding.tp_context()
            if ctx is not None:
                for a in args:
                    if isinstance(a, torch.Tensor) and ctx.dim(a) is not None:
                        uses.append((getattr(func, "__name__", str(func)),
                                     ctx.paths[id(a)], tuple(a.shape)))
            return func(*args, **(kwargs or {}))

    api = auto_api(arch, overrides)
    cfg = api.cfg
    real = {k: getattr(transport, k) for k in (
        "copy_to_line", "reduce_over_line", "gather_over_line",
        "slice_for_line")}
    with replicate_below(below):
        step, _, _ = T.make_train_step(api, mesh, AdamWConfig(lr=AUTO_LR),
                                       device="cpu")
        state = T.place_state(api.init_params(
            torch.Generator().manual_seed(0), torch.float32, "cpu"), mesh,
            step.placements)
    batch = T.batch_tensors(SyntheticLM(T.data_config(
        cfg, AUTO_SEQ, AUTO_BATCH)).batch_at(0), "cpu")
    line = mesh.line("model")
    sent = line.sent
    try:
        for k, fn in real.items():
            setattr(transport, k, spy(k, fn))
        with Uses():
            _, m = step(state, batch)
    finally:
        for k, fn in real.items():
            setattr(transport, k, fn)
    names = [a for a, _ in mesh.axes]
    whole = {}
    for (path, leaf), pl in zip(tree_items_of(api), step.placements["params"]):
        q = pl[names.index("model")]
        if q.is_shard():
            whole["/".join(path)] = (q.dim, tuple(leaf.shape))
    return {"calls": calls, "uses": uses, "sent": line.sent - sent,
            "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "sharded": whole, "m": line.size}


def tree_items_of(api) -> list:
    from repro_torch.models.tree import tree_items
    return tree_items(api.params_spec())


def tp_worker(mesh, npz_init: str, npz_batches: str, labels, root: str,
              extras: bool) -> dict:
    """TP_RUNS named in `labels` as this rank of the ("data", 2) x
    ("model", 2) launch (the (1, 4) and (pod, data, model) runs on
    process meshes of their own over the same processes); with `extras`
    TP_CENSUS (`tp_census`) and TP_CKPT's checkpoint restart."""
    import os

    from repro_torch.launch import train as T

    inputs = {**dict(np.load(npz_init)), **dict(np.load(npz_batches))}
    meshes = tp_meshes(mesh)
    res = {}
    for label, arch, dtype, mname, fsdp, overrides, bkey in TP_RUNS:
        if label in labels:
            res[label] = auto_steps(meshes[mname], inputs, label, arch,
                                    dtype, fsdp, overrides, bkey)
    if not extras:
        return res
    res["census"] = {label: tp_census(mesh, inputs, arch, ov, below)
                     for label, arch, ov, below in TP_CENSUS}

    def quiet(_msg):
        pass
    ck = {}
    with replicate_below(TP_CKPT_BELOW):
        for name, steps in (("full", 4), ("part", 2), ("resumed", 4)):
            out = T.run_training(T.TrainConfig(
                **{**TP_CKPT, "steps": steps}, engine="auto",
                ckpt_dir=os.path.join(root, "part" if name == "resumed"
                                      else name)), mesh=mesh, on_log=quiet)
            ck[name] = (out["losses"], out["steps"])
        ck["tp_leaves"] = sum(
            pl[-1].is_shard() for pl in out["step"].placements["params"])
    res["ckpt"] = ck
    return res


# the four operators under `layers.tp_dot` / `tp_ffn`, `embed`,
# `train_rmsnorm` and the vocabulary-parallel loss, in f64 on ("model", 2):
# case → the whole tensors' shapes, each weight's sharded dim
TP_OPS = {
    "column": ((3, 5, 8), [((8, 6), 1)]),
    "row": ((3, 5, 8), [((8, 6), 0)]),
    "batch": ((2, 7, 8), [((2, 8, 6), 0)]),
    "mlp": ((3, 5, 8), [((8, 12), 1), ((8, 12), 1), ((12, 8), 0)]),
    "mlp-row-first": ((3, 5, 8), [((8, 12), 0), ((8, 12), 0), ((12, 8), 1)]),
    "experts": ((2, 7, 8), [((2, 8, 12), 2), ((2, 8, 12), 2),
                            ((2, 12, 8), 1)]),
    "embed": ((3, 5), [((10, 8), 1)]),
    "norm": ((3, 5, 8), [((8,), 0)]),
    "nll": ((3, 5, 8), [((8, 12), 1)]),
}


def tp_op(case: str, x, ws):
    """The function of TP_OPS' `case` of x and the weights `ws` (whole, or
    this rank's slices under a TPContext)."""
    from repro_torch.models import layers, transformer
    if case in ("column", "row"):
        return layers.tp_dot(x, ws[0])
    if case == "batch":
        return layers.tp_dot(x, ws[0], torch.bmm)
    if case in ("mlp", "mlp-row-first"):
        return layers.mlp(dict(zip(("wg", "wi", "wo"), ws)), x)
    if case == "experts":
        return layers._experts(dict(zip(("wg", "wi", "wo"), ws)), x)
    if case == "embed":
        return layers.embed(ws[0], x)
    if case == "norm":
        return layers.train_rmsnorm(x, ws[0])
    return transformer._nll(layers.tp_dot(x, ws[0], gather=False),
                            {"labels": tp_labels(x)})


def tp_labels(x) -> torch.Tensor:
    """The nll case's labels: fixed, from the input's shape."""
    n = x.shape[0] * x.shape[1]
    return (torch.arange(n) * 5 % 12).reshape(x.shape[:2])


def tp_op_inputs(case: str) -> tuple:
    """TP_OPS' `case`: x, the whole weights and the output's cotangent,
    seeded, f64."""
    xs, wspecs = TP_OPS[case]
    g = torch.Generator().manual_seed(sorted(TP_OPS).index(case))
    x = (torch.randint(0, 10, xs, generator=g) if case == "embed" else
         torch.randn(xs, generator=g, dtype=torch.float64))
    ws = [torch.randn(s, generator=g, dtype=torch.float64) for s, _ in wspecs]
    return x, ws, g


def tp_ops_worker(mesh) -> dict:
    """TP_OPS on this rank of ("model", 2): each case's output and the
    gradients of (output · a seeded cotangent) with respect to x and to
    this rank's slices of the weights, computed on the slices under a
    TPContext."""
    from repro_torch.models import actsharding
    line = mesh.line("model")
    out = {}
    for case, (_, wspecs) in TP_OPS.items():
        x, ws, g = tp_op_inputs(case)
        local = []
        for w, (_, d) in zip(ws, wspecs):
            n = w.shape[d] // line.size
            local.append(w.narrow(d, line.index * n, n).clone()
                         .requires_grad_(True))
        xg = x if case == "embed" else x.clone().requires_grad_(True)
        actsharding.set_tp(actsharding.TPContext(
            mesh, line, 12, {id(w): d for w, (_, d) in zip(local, wspecs)},
            local))
        try:
            y = tp_op(case, xg, local)
            dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
            wrt = local if case == "embed" else [xg] + local
            grads = torch.autograd.grad((y * dy).sum(), wrt)
        finally:
            actsharding.set_tp(None)
        out[case] = (y.detach(), [t.detach() for t in grads])
    return out
