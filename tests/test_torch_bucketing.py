"""The port's bucketed sync against the JAX package's, on the CPU.

- `core.bucketing`'s pricing half (`partition`, `BucketConfig`, the time
  models) and `core.optimality`: equal to the reference's on seeded
  leaf lists and a grid;
- `PlannerService.get_bucket_plan`: the chosen bucket, K, precision and
  overlap mode equal to the reference service's, every sweep row within
  1e-12 relative, over params {PAPER_TABLE5, GPU_AXIS_BASIS} (passed
  explicitly to both), totals {1e3, 1e6, 791,687,680}, tolerances {None,
  1e-2, 0.1}, a pinned fp8, bucket_bytes {None, 1 MiB} and pipeline
  {True, False}; its memory hit, disk re-resolve and invalidation;
- `core.overlap`: `plan_merge`, `rounds_link_disjoint` and
  `occupancy_summary` equal to the reference's; `MergedSchedule.rs_ag`
  against the reference's `run_numpy_pair` (f32 within 1e-6 of the
  largest |value|, a wire within its error budget) and equal to the two
  halves run in sequence; its guard re-raises;
- `sync_bucketed`, `zero3_gather_bucketed` and `zero3_scatter_bucketed`
  (kernel wrappers on the CPU: their plain versions) against the column
  sum and against the reference's, run under `shard_map` on 8 forced
  host devices and a plain `jax.sharding.Mesh` in one subprocess: f32
  within 1e-6, the f32 gather exactly, a wire within its budget (plus
  1e-6 against the reference's own wire result); the issue order of the
  buckets, read from the tracer's spans, equal to the reference's;
- `sync_bucketed` over two live axes (the hierarchical bucket chain) on
  the (pod 2, data 4) mesh against the reference's
  `sync_gradients(strategy="plan")` on a plain 2 x 4 `Mesh`, at the
  default bucket, a pinned 1 KiB one, without the pipeline and on each
  wire: the same tolerances, the same issue order, exact launch
  counts.

Every input is made from a fixed numpy seed.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import bucketing as jb
from repro.core import optimality as jopt
from repro.core import overlap as jov
from repro.core import plans as jplans
from repro.core import topology as jtopo
from repro.core.cost_model import GenModelParams as JParams
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.core.gentree import gentree as jgentree
from repro.core.lower import lower_plan as jlower
from repro.planner.service import PlannerService as JService

from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.core import optimality as topt
from repro_torch.core import overlap as tov
from repro_torch.core import plans as tplans
from repro_torch.core import topology as ttopo
from repro_torch.core.cost_model import (GPU_AXIS_BASIS, PAPER_TABLE5,
                                         PRECISIONS)
from repro_torch.core.gentree import gentree as tgentree
from repro_torch.core.lower import LoweringError, lower_plan as tlower
from repro_torch.core.sync import AxisPlan, SyncConfig
from repro_torch.kernels import ops
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import tree_items
from repro_torch.planner.service import PlannerService
from repro_torch.runtime.metrics import default_metrics
from repro_torch.runtime.trace import Tracer, set_default_tracer

N = 8
FULL_F32_EQUIV = 791_687_680       # stablelm-12b, 2 layers, bf16 bytes / 4
J_GPU = {k: JParams(**dataclasses.asdict(v))
         for k, v in GPU_AXIS_BASIS.items()}
PARAMS = {"table5": (PAPER_TABLE5, J_TABLE5), "gpu": (GPU_AXIS_BASIS, J_GPU)}
# leaf sets: the smoke stablelm-12b's 12 parameter leaves, and leaves whose
# sizes are multiples of neither 8 nor each other, one of them empty
SMOKE = [tuple(t.shape) for _, t in tree_items(
    build(smoke_config(get_config("stablelm-12b"))).params_spec())]
ODD = [(13,), (3, 7), (0,), (5, 5, 5), (1000,), (2,), (64, 9)]
LEAVES = {"smoke": SMOKE, "odd": ODD}
SEEDS = {"smoke": 5, "odd": 6}
# sync_bucketed configurations (besides strategy="plan", PAPER_TABLE5)
SYNC = {"auto": {}, "b1k": {"bucket_bytes": 1024},
        "b1k_serial": {"bucket_bytes": 1024, "pipeline": False},
        "b1k_fwd": {"bucket_bytes": 1024, "backward_overlap": False},
        "bf16": {"bucket_bytes": 1024, "precision": "bf16"},
        "fp8": {"bucket_bytes": 4096, "precision": "fp8"},
        "int8": {"bucket_bytes": 4096, "precision": "int8"},
        "tol": {"tolerance": 0.1}}
SYNC_CASES = [("odd", c) for c in SYNC] + [("smoke", "auto")]
# sync_bucketed over two live axes: the "odd" leaves on the (pod 2, data 4)
# mesh, the reference's `sync_gradients` axes (leaf axis first)
TWO_AXIS = ["auto", "b1k", "b1k_serial", "bf16", "fp8", "int8"]
AXES2, MESH2 = [("data", 4), ("pod", 2)], [("pod", 2), ("data", 4)]
# ZeRO-3 halves: (leaf set, bucket_bytes, reverse)
ZERO3 = [("odd", 256, True), ("odd", 4096, False), ("smoke", 16384, True)]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)
                 / (np.abs(want).max(initial=0.0) + 1e-30))


def _leaves(name, rows=N) -> list[np.ndarray]:
    """Seeded (rows, *shape) f32 leaves of leaf set `name`."""
    rng = np.random.default_rng(SEEDS[name])
    return [rng.standard_normal((rows, *s)).astype(np.float32)
            for s in LEAVES[name]]


def _shards(name) -> list[np.ndarray]:
    """The ZeRO-3 (8, ⌈numel / 8⌉) shards of one seeded copy of each leaf
    of `name`, zero-padded as `shard_params_zero3` pads."""
    out = []
    for x in _leaves(name, rows=1):
        flat = x.reshape(-1)
        flat = np.pad(flat, (0, (-flat.size) % N))
        out.append(flat.reshape(N, -1))
    return out


def _sync_cfg(case):
    return SyncConfig(strategy="plan", params=PAPER_TABLE5, **SYNC[case])


def _axis_plan(size=1e4):
    resp = PlannerService().get_axis_executable("x", N, size,
                                                params=PAPER_TABLE5)
    return AxisPlan("x", "plan", schedule=resp.schedule)


_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.bucketing import (sync_bucketed, zero3_gather_bucketed,
                                  zero3_scatter_bucketed)
from repro.core.compat import shard_map
from repro.core.cost_model import PAPER_TABLE5
from repro.core.sync import AxisPlan, SyncConfig
from repro.planner.service import PlannerService, set_default_service
from repro.runtime.trace import default_tracer

out_path, in_path = sys.argv[1], sys.argv[2]
LEAVES, SYNC, SYNC_CASES, ZERO3, TWO_AXIS = eval(sys.argv[3])
inp = dict(np.load(in_path))
res = {}
mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
tracer = default_tracer()
tracer.enabled = True


def run(fn, arrays):
    f = jax.jit(shard_map(
        lambda *xs: tuple(o[None] for o in fn([x[0] for x in xs])),
        mesh=mesh, in_specs=tuple(P("x") for _ in arrays),
        out_specs=tuple(P("x") for _ in arrays), check_vma=False))
    return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in arrays])]


def spans():
    return np.array([f"{s.name} {(s.args or {}).get('bucket')} "
                     f"{(s.args or {}).get('drains')}"
                     for s in tracer.spans if s.name.startswith("bucket/")])


for name, case in SYNC_CASES:
    set_default_service(PlannerService())
    tracer.clear()
    cfg = SyncConfig(strategy="plan", params=PAPER_TABLE5, **SYNC[case])
    leaves = [inp[f"{name}/{i}"] for i in range(len(LEAVES[name]))]
    outs = run(lambda xs: sync_bucketed(xs, [("x", 8)], cfg), leaves)
    for i, o in enumerate(outs):
        res[f"sync/{name}/{case}/{i}"] = o
    res[f"sync/{name}/{case}/spans"] = spans()

# sync_gradients(strategy="plan") over two live axes on a plain 2 x 4 Mesh
from repro.core.sync import sync_gradients
mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("pod", "data"))
shapes = LEAVES["odd"]
for case in TWO_AXIS:
    set_default_service(PlannerService())
    tracer.clear()
    cfg = SyncConfig(strategy="plan", params=PAPER_TABLE5, **SYNC[case])
    leaves = [jnp.asarray(inp[f"odd/{i}"].reshape(2, 4, *s))
              for i, s in enumerate(shapes)]
    f = jax.jit(shard_map(
        lambda *xs: tuple(o[None, None] for o in sync_gradients(
            [x[0, 0] for x in xs], [("data", 4), ("pod", 2)], cfg)),
        mesh=mesh2, in_specs=tuple(P("pod", "data") for _ in leaves),
        out_specs=tuple(P("pod", "data") for _ in leaves), check_vma=False))
    for i, (o, s) in enumerate(zip(f(*leaves), shapes)):
        res[f"two/{case}/{i}"] = np.asarray(o).reshape(8, *s)
    res[f"two/{case}/spans"] = spans()

svc = PlannerService()
plan = AxisPlan("x", "plan", schedule=svc.get_axis_executable(
    "x", 8, 1e4, params=PAPER_TABLE5).schedule)
for name, bucket_bytes, reverse in ZERO3:
    tag = f"{name}/{bucket_bytes}/{int(reverse)}"
    shards = [inp[f"shards/{name}/{i}"] for i in range(len(LEAVES[name]))]
    specs = [(tuple(s), jnp.float32) for s in LEAVES[name]]
    tracer.clear()
    for i, o in enumerate(run(lambda xs: zero3_gather_bucketed(
            xs, specs, plan, bucket_bytes, 8), shards)):
        res[f"gather/{tag}/{i}"] = o
    fulls = [inp[f"{name}/{i}"] for i in range(len(LEAVES[name]))]
    for i, o in enumerate(run(lambda xs: zero3_scatter_bucketed(
            xs, plan, bucket_bytes, 8, reverse=reverse), fulls)):
        res[f"scatter/{tag}/{i}"] = o
    res[f"zero3/{tag}/spans"] = spans()
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def shard_map_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bucketing")
    inputs = {}
    for name in LEAVES:
        for i, x in enumerate(_leaves(name)):
            inputs[f"{name}/{i}"] = x
        for i, s in enumerate(_shards(name)):
            inputs[f"shards/{name}/{i}"] = s
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr((LEAVES, SYNC, SYNC_CASES, ZERO3, TWO_AXIS))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(d / "out.npz"),
                           str(d / "inputs.npz"), spec],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture
def tracer():
    t = Tracer(enabled=True)
    prev = set_default_tracer(t)
    yield t
    set_default_tracer(prev)


def _bucket_spans(tracer) -> list[str]:
    return [f"{s.name} {(s.args or {}).get('bucket')} "
            f"{(s.args or {}).get('drains')}"
            for s in tracer.spans if s.name.startswith("bucket/")]


# ---------------------------------------------------------------------------
# pricing half
# ---------------------------------------------------------------------------
def _buckets(bks) -> list:
    return [(b.indices, b.sizes, str(b.dtype)) for b in bks]


@pytest.mark.parametrize("bytes_cap", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_partition_matches_reference(seed, bytes_cap):
    """Mixed dtypes, empty leaves and leaves over the cap."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 40))
    sizes = [int(s) for s in rng.integers(0, 60, k)]
    for i in rng.integers(0, k, 3):
        sizes[i] = 0 if rng.random() < 0.5 else int(rng.integers(60, 400))
    dtypes = [str(d) for d in rng.choice(["float32", "bfloat16"], k)]
    itemsizes = [4 if d == "float32" else 2 for d in dtypes] \
        if bytes_cap else None
    cap = int(rng.integers(1, 128))
    got = tb.partition(sizes, dtypes, cap, itemsizes=itemsizes)
    want = jb.partition(sizes, dtypes, cap, itemsizes=itemsizes)
    assert _buckets(got) == _buckets(want)
    assert sorted(i for b in got for i in b.indices) == \
        [i for i, s in enumerate(sizes) if s > 0]


def test_time_models_and_optimality_match_reference():
    for t_rs in (0.0, 1e-6, 3.0):
        for t_ag in (0.0, 2e-6, 2.0):
            for k in (0, 1, 2, 7):
                assert tb.serial_time(t_rs, t_ag, k) == \
                    jb.serial_time(t_rs, t_ag, k)
                assert tb.pipelined_time(t_rs, t_ag, k) == \
                    jb.pipelined_time(t_rs, t_ag, k)
                for joint in (None, 0.0, 2.5, 10.0):
                    assert tb.contended_pipelined_time(t_rs, t_ag, k, joint) \
                        == jb.contended_pipelined_time(t_rs, t_ag, k, joint)
                    if joint is not None:
                        assert topt.overlap_certificate(
                            t_rs, t_ag, k, joint) == jopt.overlap_certificate(
                            t_rs, t_ag, k, joint)
    for n in (2, 6, 8, 16):
        for size in (1.0, 1e6):
            assert topt.delta_lower_bound_mem_ops(n, size) == \
                jopt.delta_lower_bound_mem_ops(n, size)
            for h in (0, 1, 3):
                assert topt.mem_ops_with_h_steps(n, size, h) == \
                    jopt.mem_ops_with_h_steps(n, size, h)
    for build_name in ("ring", "rhd", "cps", "reduce_broadcast"):
        for n in (4, 8, 16):
            tp = getattr(tplans, build_name)(n, 1e4)
            jp = getattr(jplans, build_name)(n, 1e4)
            assert topt.is_delta_optimal(tp) == jopt.is_delta_optimal(jp)
            for w_t in (2, 4, 9):
                assert topt.is_epsilon_optimal(tp, w_t) == \
                    jopt.is_epsilon_optimal(jp, w_t)
                assert topt.theorem2_holds(tp, w_t) == \
                    jopt.theorem2_holds(jp, w_t)


def test_bucket_config_matches_reference():
    for kw in ({}, {"bucket_bytes": 0}, {"bucket_bytes": 1 << 20},
               {"pipeline": False, "precision": "fp8", "tolerance": 0.1}):
        got, want = tb.BucketConfig(**kw), jb.BucketConfig(**kw)
        assert got.key() == want.key() and got.enabled == want.enabled
    for kw in ({"bucket_bytes": -1}, {"min_bucket_bytes": 0},
               {"precision": "fp4"}):
        with pytest.raises(ValueError):
            tb.BucketConfig(**kw)
        with pytest.raises(ValueError):
            jb.BucketConfig(**kw)


# ---------------------------------------------------------------------------
# get_bucket_plan
# ---------------------------------------------------------------------------
CONFIGS = {"auto": {}, "tol1e-2": {"tolerance": 1e-2},
           "tol0.1": {"tolerance": 0.1}, "fp8": {"precision": "fp8"},
           "1MiB": {"bucket_bytes": 1 << 20}, "serial": {"pipeline": False},
           "1MiB-serial-tol0.1": {"bucket_bytes": 1 << 20,
                                  "pipeline": False, "tolerance": 0.1}}


def _close(a, b) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b)) + 1e-30


def _same_bucket_plan(got, want):
    assert got.key == want.key
    assert (got.axes, got.bucket_floats, got.bucket_bytes, got.num_buckets,
            got.precision, got.pipeline, got.overlap.get("mode")) == (
        want.axes, want.bucket_floats, want.bucket_bytes, want.num_buckets,
        want.precision, want.pipeline, want.overlap.get("mode"))
    for f in ("predicted_pipelined", "predicted_serial",
              "predicted_contended"):
        assert _close(getattr(got, f), getattr(want, f)), f
    for f in ("t_joint", "t_pair_sequential", "t_pair_naive"):
        assert _close(got.overlap.get(f, 0.0), want.overlap.get(f, 0.0)), f
    assert sorted(got.sweep) == sorted(want.sweep)
    for b, row in want.sweep.items():
        assert sorted(got.sweep[b]) == sorted(row)
        for f, v in row.items():
            if isinstance(v, str):
                assert got.sweep[b][f] == v
            else:
                assert _close(got.sweep[b][f], v), (b, f)
    assert [pl.schedule.describe() for pl in got.axis_plans] == \
        [pl.schedule.describe() for pl in want.axis_plans]
    assert (got.merged_schedule is None) == (want.merged_schedule is None)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("total", [1e3, 1e6, FULL_F32_EQUIV])
@pytest.mark.parametrize("params", list(PARAMS))
def test_get_bucket_plan_matches_reference(params, total, config):
    tp, jp = PARAMS[params]
    got = PlannerService().get_bucket_plan(
        [("data", N)], total, params=tp,
        config=tb.BucketConfig(**CONFIGS[config]))
    want = JService().get_bucket_plan(
        [("data", N)], total, params=jp,
        config=jb.BucketConfig(**CONFIGS[config]))
    _same_bucket_plan(got, want)


def test_full_width_default_is_one_bucket():
    """The trainer's full-width default under the uncalibrated GPU basis:
    the monolithic candidate, one bucket, sequential issuance."""
    bp = PlannerService().get_bucket_plan([("data", N)], FULL_F32_EQUIV)
    assert bp.num_buckets == 1 and bp.bucket_floats == FULL_F32_EQUIV
    assert bp.overlap["mode"] == "sequential" and bp.precision == "f32"
    assert bp.axis_plans[0].schedule.blocks_per_shard == 1


def test_two_axes_and_per_leaf_baseline_match_reference():
    axes = [("data", 4), ("one", 1), ("pod", 2)]
    leaf_sizes = [50000] * 30 + [1000] * 5 + [0]
    got = PlannerService().get_bucket_plan(axes, 2e6, params=PAPER_TABLE5,
                                           leaf_sizes=leaf_sizes)
    want = JService().get_bucket_plan(axes, 2e6, params=J_TABLE5,
                                      leaf_sizes=leaf_sizes)
    _same_bucket_plan(got, want)
    assert _close(got.predicted_per_leaf, want.predicted_per_leaf)
    assert len(got.axis_plans) == 2


def test_bucket_plan_cache_and_invalidation_match_reference():
    t, j = PlannerService(), JService()
    cfg = {"bucket_bytes": 1 << 16}
    a = t.get_bucket_plan([("data", N)], 1e6, params=PAPER_TABLE5,
                          config=tb.BucketConfig(**cfg))
    j.get_bucket_plan([("data", N)], 1e6, params=J_TABLE5,
                      config=jb.BucketConfig(**cfg))
    assert a.source == "cold"
    b = t.get_bucket_plan([("data", N)], 1e6, params=PAPER_TABLE5,
                          config=tb.BucketConfig(**cfg))
    assert b.source == "memory" and b.key == a.key
    assert b.axis_plans[0].schedule is a.axis_plans[0].schedule
    count = t.executable_count()
    assert count == j.executable_count() >= 2     # the plan + its schedule
    assert t.invalidate_executables() == j.invalidate_executables() == count
    assert t.executable_count() == 0
    c = t.get_bucket_plan([("data", N)], 1e6, params=PAPER_TABLE5,
                          config=tb.BucketConfig(**cfg))
    assert c.source == "cold"
    assert c.axis_plans[0].schedule is not a.axis_plans[0].schedule
    assert tb.invalidate_schedules(t) == count


def test_bucket_plan_reresolves_from_disk(tmp_path):
    path = str(tmp_path / "plans.json")
    cfg = tb.BucketConfig(tolerance=0.1)
    t = PlannerService(cache_path=path)
    a = t.get_bucket_plan([("data", N)], 1e6, params=PAPER_TABLE5,
                          config=cfg)
    t.save()
    b = PlannerService(cache_path=path).get_bucket_plan(
        [("data", N)], 1e6, params=PAPER_TABLE5, config=cfg)
    assert b.source == "disk" and b.key == a.key
    assert (b.bucket_floats, b.num_buckets, b.precision, b.overlap) == (
        a.bucket_floats, a.num_buckets, a.precision, a.overlap)
    assert b.axis_plans[0].schedule.describe() == \
        a.axis_plans[0].schedule.describe()
    assert (b.axis_plans[0].schedule.wire is None) == (a.precision == "f32")


def test_contended_price_matches_reference():
    t, j = PlannerService(), JService()
    for n, level, size in ((8, "root_sw", 1e6), (4, "cross_dc", 3e5)):
        for prec in (None, "fp8"):
            tp = PRECISIONS[prec] if prec else None
            from repro.core.cost_model import PRECISIONS as JPREC
            jp = JPREC[prec] if prec else None
            assert _close(
                t._axis_contended_time(n, level, size, "float32",
                                       PAPER_TABLE5, precision=tp),
                j._axis_contended_time(n, level, size, "float32", J_TABLE5,
                                       precision=jp))
    g = default_metrics().gauge("planner_contended_busiest_link_units")
    assert g.value > 0.0


# ---------------------------------------------------------------------------
# merged schedules
# ---------------------------------------------------------------------------
TOPOS = {"flat8": ("single_switch", (8,)),
         "two_level": ("symmetric_tree", (2, 4)),
         "flat6": ("single_switch", (6,))}
MERGE_CASES = list(TOPOS) + ["ring8", "rhd8"]


def _plans(name):
    """(port plan, reference plan, port topology, reference topology)."""
    if name in TOPOS:
        builder, args = TOPOS[name]
        tt = getattr(ttopo, builder)(*args)
        jt = getattr(jtopo, builder)(*args)
        return (tgentree(tt, 1e6, params=PAPER_TABLE5).plan,
                jgentree(jt, 1e6, params=J_TABLE5).plan, tt, jt)
    build_name = name[:-1]
    tt, jt = ttopo.single_switch(8), jtopo.single_switch(8)
    return (getattr(tplans, build_name)(8, 1e6),
            getattr(jplans, build_name)(8, 1e6), tt, jt)


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_analysis_matches_reference(name):
    tp, jp, tt, jt = _plans(name)
    pairs = {"self": ((tlower(tp),) * 2, (jlower(jp),) * 2),
             "halves": (tuple(tlower(h) for h in tplans.family_halves(tp)),
                        tuple(jlower(h) for h in jplans.family_halves(jp)))}
    for (ta, tb_), (ja, jb_) in pairs.values():
        assert dataclasses.asdict(tov.plan_merge(ta, tb_)) == \
            dataclasses.asdict(jov.plan_merge(ja, jb_))
        for sa, sja in zip(tov._rs_steps(ta), jov._rs_steps(ja)):
            for sb, sjb in zip(tov._ag_steps(tb_), jov._ag_steps(jb_)):
                for ra, rja in zip(sa.rounds, sja.rounds):
                    for rb, rjb in zip(sb.rounds, sjb.rounds):
                        assert tov.rounds_link_disjoint(ra, rb) == \
                            jov.rounds_link_disjoint(rja, rjb)
    trs, tag = tplans.family_halves(tp)
    jrs, jag = jplans.family_halves(jp)
    assert tov.occupancy_summary(tt, trs.steps[0], tag.steps[0]) == \
        jov.occupancy_summary(jt, jrs.steps[0], jag.steps[0])


def test_plan_merge_rejects_what_the_reference_rejects():
    rs, ag = (tlower(h) for h in tplans.family_halves(_plans("flat8")[0]))
    for a, b in ((ag, ag), (rs, rs), (tlower(_plans("flat8")[0]),
                                      tlower(_plans("flat6")[0]))):
        with pytest.raises(LoweringError):
            tov.plan_merge(a, b)
    nb = tlower(tplans.reduce_broadcast(8, 1e4))
    with pytest.raises(LoweringError, match="canonical"):
        tov.plan_merge(nb, nb)


def _pair_inputs(cs, seed, size=173, chunks=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((cs.n, size)).astype(np.float32)
    S = rng.standard_normal((cs.n, cs.blocks_per_shard * chunks)
                            ).astype(np.float32)
    return X, S


@pytest.mark.parametrize("wire", [None, "bf16", "fp8", "int8"])
@pytest.mark.parametrize("name", MERGE_CASES)
def test_merged_rs_ag_matches_run_numpy_pair(name, wire):
    tp, jp, _, _ = _plans(name)
    tcs, jcs = tlower(tp), jlower(jp)
    if wire is not None:
        tcs = tcs.with_wire(PRECISIONS[wire])
    X, S = _pair_inputs(tcs, seed=len(name))
    rs, ag = tov.merge_schedules(tcs, tcs).rs_ag(torch.from_numpy(X),
                                                 torch.from_numpy(S))
    want_rs, want_ag = jov.merge_schedules(jcs, jcs).run_numpy_pair(
        X.astype(np.float64), S.astype(np.float64))
    budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget
    assert _rel(rs.numpy(), want_rs) <= budget
    assert _rel(ag.numpy(), want_ag) <= budget
    # the same values as the two halves run in sequence
    assert torch.equal(rs, tcs.run_local_reduce_scatter(torch.from_numpy(X)))
    assert torch.equal(ag, tcs.run_local_all_gather(torch.from_numpy(S)))


def _count(monkeypatch, fail_with=None):
    counts = {}
    for name in ("fused_reduce_into", "quant_reduce_into", "dequantize_into",
                 "quantize"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            if fail_with is not None:
                raise fail_with
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    return counts


def _folds(steps) -> int:
    return sum(len(st.folds) for st in steps)


def test_merged_launches_one_fold_kernel_a_phase(monkeypatch, tracer):
    cs = tlower(_plans("ring8")[0])
    ms = tov.merge_schedules(cs, cs)
    counts = _count(monkeypatch)
    X, S = _pair_inputs(cs, seed=3)
    ms.rs_ag(torch.from_numpy(X), torch.from_numpy(S))
    assert counts == {"fused_reduce_into": _folds(tov._rs_steps(cs))
                      + _folds(tov._ag_steps(cs))}
    assert ms.stats == {"launches": 1, "failures": 0} and ms.demotions == 0
    steps = [s for s in tracer.spans if s.name == "overlap/step"]
    assert len(steps) == max(len(tov._rs_steps(cs)), len(tov._ag_steps(cs)))


@pytest.mark.parametrize("wire", [None, "fp8"])
def test_merged_launch_failure_is_raised_never_demoted(monkeypatch, tracer,
                                                        wire):
    cs = tlower(_plans("flat8")[0])
    if wire is not None:
        cs = cs.with_wire(PRECISIONS[wire])
    ms = tov.MergedSchedule(cs, cs)
    counts = _count(monkeypatch, RuntimeError("cudaError 98"))
    X, S = _pair_inputs(cs, seed=4)
    for launch in (1, 2):
        with pytest.raises(RuntimeError, match="cudaError 98"):
            ms.rs_ag(torch.from_numpy(X), torch.from_numpy(S))
        assert ms.stats == {"launches": launch, "failures": launch}
        # the first kernel call raised: no sequential path ran after it
        assert sum(counts.values()) == launch
    assert ms.demotions == 0
    assert [s.name for s in tracer.spans].count("overlap/failure") == 2


def test_merge_schedules_is_memoized():
    cs = tlower(_plans("flat8")[0])
    ms = tov.merge_schedules(cs, cs)
    assert tov.merge_schedules(cs, cs) is ms
    assert "merge(" in ms.describe() and ms.n == 8


# ---------------------------------------------------------------------------
# sync_bucketed
# ---------------------------------------------------------------------------
def _port_sync(name, case, stats=None):
    leaves = [torch.from_numpy(x) for x in _leaves(name)]
    return tb.sync_bucketed(leaves, [("x", N)], _sync_cfg(case),
                            service=PlannerService(), stats=stats)


@pytest.mark.parametrize("name,case", SYNC_CASES)
def test_sync_bucketed_matches_column_sum(name, case):
    stats = {}
    got = _port_sync(name, case, stats)
    prec = stats["precision"]
    budget = 1e-6 if prec == "f32" else PRECISIONS[prec].error_budget
    for g, x in zip(got, _leaves(name), strict=True):
        assert g.shape == x.shape and g.dtype == torch.float32
        want = np.broadcast_to(x.astype(np.float64).sum(0), x.shape)
        assert _rel(g.numpy(), want) <= budget
    assert stats["num_buckets"] >= 1 and stats["bucket_bytes"] > 0
    if "precision" in SYNC[case]:
        assert prec == SYNC[case]["precision"]


@pytest.mark.parametrize("name,case", SYNC_CASES)
def test_sync_bucketed_matches_shard_map(name, case, shard_map_results,
                                         tracer):
    stats = {}
    got = _port_sync(name, case, stats)
    prec = stats["precision"]
    for i, g in enumerate(got):
        want = shard_map_results[f"sync/{name}/{case}/{i}"]
        if prec == "f32":
            assert _rel(g.numpy(), want) <= 1e-6
        else:
            assert _rel(g.numpy(), want) <= \
                PRECISIONS[prec].error_budget + 1e-6
    assert _bucket_spans(tracer) == \
        list(shard_map_results[f"sync/{name}/{case}/spans"])


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
def test_sync_bucketed_issue_order(tracer, pipeline, overlap):
    """The buckets' reduce-scatters go out last first under
    backward_overlap; pipelined, RS(k) goes out before AG(k−1) drains
    (in one merged launch where the argmin chose it, as at this size);
    unpipelined, each bucket's AG follows its RS."""
    cfg = dataclasses.replace(_sync_cfg("b1k"), pipeline=pipeline,
                              backward_overlap=overlap)
    stats = {}
    tb.sync_bucketed([torch.from_numpy(x) for x in _leaves("odd")],
                     [("x", N)], cfg, service=PlannerService(), stats=stats)
    spans = [s.split() for s in _bucket_spans(tracer)]
    rs = [int(b) for name, b, _ in spans
          if name in ("bucket/rs", "bucket/rs_ag")]
    k = len(rs)
    assert k >= 3
    assert rs == (list(range(k - 1, -1, -1)) if overlap else list(range(k)))
    names = [name for name, _, _ in spans]
    if not pipeline:
        assert names == ["bucket/rs", "bucket/ag"] * k
    elif stats["overlap_mode"] == "merged":
        assert names == ["bucket/rs"] + ["bucket/rs_ag"] * (k - 1) \
            + ["bucket/ag"]
    else:
        assert names == ["bucket/rs"] + ["bucket/rs", "bucket/ag"] * (k - 1) \
            + ["bucket/ag"]
    assert stats["overlap_mode"] == ("merged" if pipeline else "sequential")


@pytest.mark.parametrize("case", ["b1k", "fp8", "int8"])
def test_sync_bucketed_launches(monkeypatch, case):
    """Per bucket: one fold kernel a fold phase of the RS and AG halves
    (quant_reduce or dequantize on a scaled wire, one quantize a live
    round there)."""
    counts = _count(monkeypatch)
    stats = {}
    _port_sync("odd", case, stats)
    svc = PlannerService()
    cs = svc.get_bucket_plan(
        [("x", N)], stats["bucket_floats"], params=PAPER_TABLE5,
        config=tb.BucketConfig(bucket_bytes=stats["bucket_bytes"])
    ).axis_plans[0].schedule
    steps = tov._rs_steps(cs) + tov._ag_steps(cs)
    k = len(tb.partition([int(np.prod(s)) for s in ODD], ["f"] * len(ODD),
                         stats["bucket_bytes"],
                         itemsizes=[4] * len(ODD)))
    if case == "b1k":
        assert counts == {"fused_reduce_into": k * _folds(steps)}
        return
    rounds = sum(1 for st in steps for rd in st.rounds if rd.perm)
    landings = 0
    for st in steps:
        for fd in st.folds:
            act = fd.blk >= 0
            landings += int(not fd.include_self[act].any() and bool(
                ((fd.ops[act] >= 0).sum(axis=1) == 1).all()))
    assert counts == {"quantize": k * rounds,
                      "dequantize_into": k * landings,
                      "quant_reduce_into": k * (_folds(steps) - landings)}


def test_sync_bucketed_merged_and_allreduce_branches(tracer):
    """The merged branch (a MergedSchedule built directly, whatever the
    argmin picks) and the whole-AllReduce branch (a schedule without
    canonical shards) give the column sum."""
    leaves = [torch.from_numpy(x) for x in _leaves("odd")]
    sizes = [int(np.prod(s)) for s in ODD]
    buckets = tb.partition(sizes, ["f32"] * len(sizes), 256,
                           itemsizes=[4] * len(sizes))
    cs = tlower(_plans("flat8")[0])
    nb = tlower(tplans.reduce_broadcast(8, 1e4))
    for plan, merged in ((cs, tov.merge_schedules(cs, cs)), (nb, None)):
        tracer.clear()
        got = tb.execute_buckets(leaves, buckets,
                                 [AxisPlan("x", "plan", schedule=plan)],
                                 merged=merged, reverse=True)
        for g, x in zip(got, _leaves("odd")):
            want = np.broadcast_to(x.astype(np.float64).sum(0), x.shape)
            assert _rel(g.numpy(), want) <= 1e-6
        names = {s.split()[0] for s in _bucket_spans(tracer)}
        assert names == ({"bucket/rs", "bucket/rs_ag", "bucket/ag"}
                         if merged else {"bucket/allreduce"})
    assert tov.merge_schedules(cs, cs).stats["launches"] == len(buckets) - 1


def test_sync_bucketed_bf16_leaves():
    leaves = [torch.from_numpy(x).to(torch.bfloat16) for x in _leaves("odd")]
    got = tb.sync_bucketed(leaves, [("x", N)], _sync_cfg("b1k"),
                           service=PlannerService())
    for g, x in zip(got, leaves):
        assert g.dtype == torch.bfloat16
        want = np.broadcast_to(x.double().sum(0).numpy(), x.shape)
        assert _rel(g.float().numpy(), want) <= 2e-2


def test_sync_bucketed_counts_its_metrics():
    m = default_metrics()
    before = m.counter("sync_bucketed_total").value
    _port_sync("odd", "b1k")
    assert m.counter("sync_bucketed_total").value == before + 1
    assert m.histogram("sync_buckets_per_step").count >= 1
    assert 0.5 <= m.gauge("bucket_pipeline_occupancy").value <= 1.0


def test_sync_bucketed_refuses_two_live_axes():
    """Two live axes were refused until the hierarchical bucket chain was
    ported; now leaves leading with the live axes' sizes (the default
    mesh: `axes` in their order) reduce over both, every rank's copy the
    sum over the mesh. Rows that do not lead with the mesh's sizes still
    raise, one live axis among size-1 axes runs as before, and no live
    axis is a no-op."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((4, 2, 37)).astype(np.float32))
    (got,) = tb.sync_bucketed([z], [("data", 4), ("pod", 2)],
                              _sync_cfg("auto"), service=PlannerService())
    want = np.broadcast_to(z.double().sum((0, 1)).numpy(), z.shape)
    assert got.shape == z.shape and _rel(got.numpy(), want) <= 1e-6
    with pytest.raises(ValueError, match="per-rank rows"):
        tb.sync_bucketed([torch.zeros((N, 4))], [("data", 4), ("pod", 2)],
                         _sync_cfg("auto"), service=PlannerService())
    leaves = [torch.zeros((N, 4))]
    # one live axis among size-1 axes is fine; no live axis is a no-op
    tb.sync_bucketed(leaves, [("data", N), ("pod", 1)], _sync_cfg("auto"),
                     service=PlannerService())
    assert tb.sync_bucketed(leaves, [("pod", 1)], _sync_cfg("auto"))[0] \
        is leaves[0]
    with pytest.raises(ValueError, match="per-rank rows"):
        tb.sync_bucketed([torch.zeros((4, 4))], [("data", N)],
                         _sync_cfg("auto"), service=PlannerService())


def _port_sync2(case, stats=None):
    """The port's sync_bucketed over AXES2 on MESH2: the "odd" leaves as
    (2, 4, ...) local-mesh tensors, rank (p, d) row 4p + d."""
    leaves = [torch.from_numpy(x.reshape(2, 4, *x.shape[1:]))
              for x in _leaves("odd")]
    got = tb.sync_bucketed(leaves, AXES2, _sync_cfg(case),
                           service=PlannerService(), stats=stats,
                           mesh=MESH2)
    return [g.reshape(N, *g.shape[2:]) for g in got]


@pytest.mark.parametrize("case", TWO_AXIS)
def test_two_axis_sync_bucketed_matches_shard_map(case, shard_map_results,
                                                  tracer):
    """The hierarchical bucket chain against the reference's
    `sync_gradients(strategy="plan")` under shard_map on a plain (pod 2,
    data 4) Mesh: f32 within 1e-6, a wire within its budget plus 1e-6;
    the column sum over both axes within the same; the buckets issued as
    the reference issues them (merged issuance stays one-axis only)."""
    stats = {}
    got = _port_sync2(case, stats)
    prec = stats["precision"]
    assert prec == SYNC[case].get("precision", "f32")
    assert stats["axes"] == AXES2
    tol = 1e-6 if prec == "f32" else PRECISIONS[prec].error_budget + 1e-6
    for i, (g, x) in enumerate(zip(got, _leaves("odd"), strict=True)):
        assert g.shape == x.shape and g.dtype == torch.float32
        want = shard_map_results[f"two/{case}/{i}"]
        assert _rel(g.numpy(), want) <= tol
        assert _rel(g.numpy(), np.broadcast_to(x.astype(np.float64).sum(0),
                                               x.shape)) <= tol
    spans = _bucket_spans(tracer)
    assert spans == list(shard_map_results[f"two/{case}/spans"])
    assert not any(sp.startswith("bucket/rs_ag") for sp in spans)


def _launches(cs, steps) -> dict:
    """Kernel launches of one run of `steps` of schedule `cs` at its wire:
    a fold kernel a fold phase (fused_reduce_into at full precision and
    on the bf16 wire; on a scaled wire quant_reduce_into, or
    dequantize_into where the phase only lands copies) and, on a scaled
    wire, a quantize a live round."""
    folds = _folds(steps)
    if cs.wire is None or not cs.wire.scale_block:
        return {"fused_reduce_into": folds}
    rounds = sum(1 for st in steps for rd in st.rounds if rd.perm)
    landings = 0
    for st in steps:
        for fd in st.folds:
            act = fd.blk >= 0
            landings += int(not fd.include_self[act].any() and bool(
                ((fd.ops[act] >= 0).sum(axis=1) == 1).all()))
    return {"quantize": rounds, "dequantize_into": landings,
            "quant_reduce_into": folds - landings}


@pytest.mark.parametrize("case", TWO_AXIS)
def test_two_axis_sync_bucketed_launches(monkeypatch, case):
    """Per bucket, per axis of the chain, one launch a fold phase (and a
    quantize a live round on a scaled wire) of the axis schedule's RS and
    AG halves, once a group of the other axis (`_per_group`: 2 groups
    on "data", 4 on "pod")."""
    counts = _count(monkeypatch)
    stats = {}
    _port_sync2(case, stats)
    cfg = _sync_cfg(case)
    bp = PlannerService().get_bucket_plan(
        AXES2, sum(int(np.prod(s)) for s in ODD), dtype="float32",
        params=PAPER_TABLE5, config=tb.BucketConfig(
            bucket_bytes=cfg.bucket_bytes, pipeline=cfg.pipeline,
            precision=cfg.precision, tolerance=cfg.tolerance))
    assert bp.key == stats["key"] and len(bp.axis_plans) == 2
    k = len(tb.partition([int(np.prod(s)) for s in ODD], ["f"] * len(ODD),
                         stats["bucket_bytes"], itemsizes=[4] * len(ODD)))
    want: dict = {}
    for pl in bp.axis_plans:
        cs = pl.schedule
        groups = N // cs.n
        for name, c in _launches(cs, tov._rs_steps(cs)
                                 + tov._ag_steps(cs)).items():
            want[name] = want.get(name, 0) + k * groups * c
    assert counts == {name: c for name, c in want.items() if c}


def test_guarded_sync_records_and_raises(monkeypatch):
    _count(monkeypatch, RuntimeError("cudaError 700"))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _port_sync("odd", "b1k")


# ---------------------------------------------------------------------------
# ZeRO-3 halves
# ---------------------------------------------------------------------------
def _specs(name):
    return [(s, torch.float32) for s in LEAVES[name]]


@pytest.mark.parametrize("name,bucket_bytes,reverse", ZERO3)
def test_zero3_gather_matches_shard_map(name, bucket_bytes, reverse,
                                        shard_map_results):
    tag = f"{name}/{bucket_bytes}/{int(reverse)}"
    shards = [torch.from_numpy(s) for s in _shards(name)]
    got = tb.zero3_gather_bucketed(shards, _specs(name), _axis_plan(),
                                   bucket_bytes, N)
    one = tb.zero3_gather_bucketed(shards, _specs(name), _axis_plan(),
                                   bucket_bytes, N, shared=True)
    for i, (g, o, x) in enumerate(zip(got, one, _leaves(name, rows=1))):
        want = shard_map_results[f"gather/{tag}/{i}"]
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(o.numpy(), x[0])
        np.testing.assert_array_equal(want[3], x[0])


@pytest.mark.parametrize("name,bucket_bytes,reverse", ZERO3)
def test_zero3_scatter_matches_shard_map(name, bucket_bytes, reverse,
                                         shard_map_results, tracer):
    tag = f"{name}/{bucket_bytes}/{int(reverse)}"
    fulls = [torch.from_numpy(x) for x in _leaves(name)]
    got = tb.zero3_scatter_bucketed(fulls, _axis_plan(), bucket_bytes, N,
                                    reverse=reverse)
    for i, (g, x) in enumerate(zip(got, _leaves(name))):
        want = shard_map_results[f"scatter/{tag}/{i}"]
        assert g.shape == want.shape
        assert _rel(g.numpy(), want) <= 1e-6
        flat = np.pad(x.astype(np.float64).sum(0).reshape(-1),
                      (0, (-x[0].size) % N))
        assert _rel(g.numpy(), flat.reshape(N, -1)) <= 1e-6
    assert [s for s in _bucket_spans(tracer)
            if s.startswith("bucket/zero3_rs")] == \
        [s for s in shard_map_results[f"zero3/{tag}/spans"]
         if s.startswith("bucket/zero3_rs")]


def test_zero3_bucket_layout_round_trips():
    """A bucket of a schedule with 3 blocks a shard: member columns,
    padding zeroed, write and read inverse, the reduce-scatter rows the
    members' shards."""
    numels = [13, 0, 21, 8]
    layout = tb.zero3_layout(numels, [torch.float32] * 4, [4] * 4, 1 << 20,
                             4, 3)
    (bk,) = layout
    assert bk.indices == (0, 2, 3) and bk.chunks == (4, 6, 2)
    assert bk.offsets == (0, 4, 10) and bk.width == 12
    mat = torch.full((4, 4 * 12), 7.0)
    bk_mat = bk.matrix(4, "cpu")
    assert bk_mat.shape == (4, 48)
    rng = np.random.default_rng(0)
    srcs = [torch.from_numpy(rng.standard_normal((4, m)).astype(np.float32))
            for m in bk.numels]
    for j, s in enumerate(srcs):
        bk.write(bk_mat, j, s)
        bk.write(mat, j, s)
        assert torch.equal(bk.read(bk_mat, j), s)
    # the padding of the matrix is zero, that of `mat` untouched
    written = torch.zeros_like(bk_mat, dtype=torch.bool)
    for j, s in enumerate(srcs):
        bk.write(written, j, torch.ones_like(s, dtype=torch.bool))
    assert not bk_mat[~written].any() and (mat[~written] == 7.0).all()
    shards = bk.shards(torch.arange(4 * 12.).reshape(4, 12))
    assert [tuple(s.shape) for s in shards] == [(4, 4), (4, 6), (4, 2)]
    assert shards[1][2, 0] == 2 * 12 + 4


# ---------------------------------------------------------------------------
# the executor's in-place reduce-scatter, and wires in resolve_axis_plans
# ---------------------------------------------------------------------------
def test_overwriting_reduce_scatter_matches_the_private_copy():
    from repro_torch.core.lower import guard_schedule
    cs = tlower(_plans("flat8")[0])
    X = torch.from_numpy(_pair_inputs(cs, seed=9, size=8 * 38)[0])
    want = cs.run_local_reduce_scatter(X)
    work = X.clone()
    got = guard_schedule(cs).run_local_reduce_scatter(work, overwrite=True)
    assert torch.equal(got, want) and not torch.equal(work, X)
    for bad in (X[:, :300], X[:, ::2]):
        with pytest.raises(LoweringError, match="overwritable"):
            cs.run_local_reduce_scatter(bad, overwrite=True)


@pytest.mark.parametrize("precision,tolerance,wire", [
    ("fp8", None, "fp8"), ("fp8", 1e-3, None), ("bf16", 0.1, "bf16"),
    (None, 0.1, None)])
def test_resolve_axis_plans_binds_the_wire(precision, tolerance, wire):
    from repro_torch.core.sync import resolve_axis_plans
    (plan,) = resolve_axis_plans([("data", N)], SyncConfig(
        strategy="plan", bucket_bytes=0, precision=precision,
        tolerance=tolerance, params=PAPER_TABLE5), 1e4)
    got = plan.schedule.wire
    assert (got.name if got is not None else None) == wire
