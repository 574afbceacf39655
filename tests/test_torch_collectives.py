"""The port's flat collectives and gradient sync on the local mesh
(`repro_torch.core.collectives`, `repro_torch.core.sync`) against the
JAX package's.

One subprocess with 8 forced host devices runs every reference case
under `shard_map` on a plain `jax.sharding.Mesh` (never `jax.make_mesh`)
and saves the outputs; the port runs the same numpy inputs on the CPU,
where each fold is the kernel's plain version (`kernels/ref.py`). Every
case of `tests/test_collectives.py` has its counterpart here: the
allreduce of each strategy and factor set, the reduce-scatter's values
and its flat-shard shape contract, rhd on 3, 5, 6 and 7 ranks, the
padded 8 × 13, int8 CPS, `sync_gradients` with "gentree" and the
(pod 2, data 4) two-axis sync, and the top-k AllReduce. Beyond them:
`hcps_shard_index`, `all_to_all` / `ep_all_to_all` with and without a
lowered schedule, `allreduce_planned`'s stats on the plan, bucketed and
flat-label routes, and no kernel launch on the CPU.

Tolerances: f32 results within 1e-6 of the largest |value| of the
reference's output (the same f32 adds, possibly in another order:
XLA's sums against the kernel's operand order); movements (all-gather,
all-to-all) exactly; int8 CPS within one int8 step of the shard's
scale (max |sum| / 127) of the reference's output, and within the
reference test's 0.05 of the exact sum; top-k exactly on the sparse
case and within 1e-6 on distinct magnitudes.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.core import sync as S
from repro_torch.core.bucketing import BucketConfig
from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.lower import lower_plan
from repro_torch.core.plans import alltoall_plan
from repro_torch.kernels import ops
from repro_torch.planner.service import PlannerService

N = 8
ALLREDUCE = [("psum", None), ("ring", None), ("rhd", None), ("cps", None),
             ("hcps", (4, 2)), ("hcps", (2, 4)), ("hcps", (2, 2, 2))]
RS = [("psum", None), ("ring", None), ("rhd", None), ("cps", None),
      ("hcps", (4, 2)), ("hcps", (2, 4)), ("hcps", (2, 2, 2))]
NPO2 = (3, 5, 6, 7)
FACTOR_SETS = [(8,), (4, 2), (2, 4), (2, 2, 2), (2, 3), (3, 2), (2, 2)]
TWO_AXIS = [("hcps", (2, 2)), ("ring", None), ("rhd", None), ("cps", None),
            ("psum", None), ("auto", None)]

_CHILD = r"""
import os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import collectives as C
from repro.core.bucketing import BucketConfig
from repro.core.compat import shard_map
from repro.core.cost_model import PAPER_TABLE5
from repro.core.lower import lower_plan
from repro.core.plans import alltoall_plan
from repro.core.sync import (SyncConfig, allreduce_int8_cps, allreduce_topk,
                             ep_all_to_all, expert_parallel,
                             level_switch_topo, resolve_axis_plans,
                             sync_gradients)
from repro.planner.service import PlannerService

ALLREDUCE, RS, NPO2, FACTOR_SETS, TWO_AXIS = eval(sys.argv[2])
inp = dict(np.load(sys.argv[3]))
res = {}
mesh = Mesh(np.array(jax.devices()[:8]), ("x",))


def run(fn, x, m=mesh, spec=P("x")):
    f = jax.jit(shard_map(fn, mesh=m, in_specs=spec, out_specs=spec))
    return np.asarray(f(jnp.asarray(x)))


x = inp["x"]
for strat, fac in ALLREDUCE:
    res[f"allreduce/{strat}/{fac}"] = run(
        lambda v: C.allreduce(v[0], "x", strat, factors=fac)[None], x)
for strat, fac in RS:
    res[f"rs/{strat}/{fac}"] = run(
        lambda v: C.reduce_scatter(v[0], "x", strat, factors=fac)[None], x)
    res[f"rs_ag/{strat}/{fac}"] = run(
        lambda v: C.all_gather(C.reduce_scatter(v[0], "x", strat,
                                                factors=fac),
                               "x", strat, factors=fac)[None], x)
for n in NPO2:
    sub = Mesh(np.array(jax.devices()[:n]), ("x",))
    res[f"rhd/{n}"] = run(lambda v: C.allreduce(v[0], "x", "rhd")[None],
                          inp[f"npo2/{n}"], sub)
res["pad"] = run(lambda v: C.allreduce(v[0], "x", "hcps",
                                       factors=(2, 4))[None], inp["pad"])
res["int8"] = run(lambda v: allreduce_int8_cps(v[0], "x")[None],
                  inp["int8"])
for name in ("sparse", "distinct"):
    res[f"topk/{name}"] = run(
        lambda v: allreduce_topk(v[0], "x", k_frac=0.01)[None], inp[name])
for fac in FACTOR_SETS:
    res[f"shard_index/{fac}"] = np.asarray(C.hcps_shard_index(fac))

cfg = SyncConfig(strategy="gentree", params=PAPER_TABLE5)
(pl,) = resolve_axis_plans([("x", 8)], cfg, 107.0)
res["gentree/plan"] = np.array([pl.strategy, str(pl.factors)])


def sync(g):
    out = sync_gradients({k: v[0] for k, v in g.items()}, [("x", 8)], cfg)
    return {k: v[None] for k, v in out.items()}


f = jax.jit(shard_map(sync, mesh=mesh, in_specs=P("x"), out_specs=P("x")))
for k, v in f({"a": jnp.ones((8, 100)), "b": jnp.full((8, 7), 2.0)}).items():
    res[f"gentree/{k}"] = np.asarray(v)

mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("pod", "data"))
for strat, fac in TWO_AXIS:
    def sync2(v, strat=strat, fac=fac):
        out = sync_gradients({"g": v[0, 0]}, [("data", 4), ("pod", 2)],
                             SyncConfig(strategy=strat, factors=fac))
        return out["g"][None, None]
    res[f"two_axis/{strat}/{fac}"] = run(sync2, inp["z"], mesh2,
                                         P("pod", "data"))

# all-to-all, plain and from the lowered plan, and through the EP context
a2a = lower_plan(alltoall_plan(8, 1e6))
res["a2a/plain"] = run(lambda v: C.all_to_all(v[0], "x")[None], inp["a2a"])
res["a2a/plan"] = run(lambda v: C.all_to_all(v[0], "x", schedule=a2a)[None],
                      inp["a2a"])
def ep(v, sched):
    with expert_parallel("x", 8, sched):
        return ep_all_to_all(v[0], "x")[None]
res["ep/plain"] = run(lambda v: ep(v, None), inp["a2a"])
res["ep/plan"] = run(lambda v: ep(v, a2a), inp["a2a"])

# allreduce_planned: the plan route, the bucketed route, the fallback
svc = PlannerService(params=PAPER_TABLE5)
for route, kw in (("plan", {}),
                  ("bucketed", {"bucketing": BucketConfig(bucket_bytes=128)}),
                  ("tolerance", {"tolerance": 1e-2})):
    st = {}
    res[f"planned/{route}"] = run(lambda v: C.allreduce_planned(
        v[0], "x", service=svc, stats=st, **kw)[None], inp["planned"])
    res[f"planned/{route}/stats"] = np.array(repr(sorted(st.items())))
fsvc = PlannerService(params=PAPER_TABLE5)
eff = fsvc._effective_axis_params()
resp = fsvc.get_plan(level_switch_topo(8, eff, "root_sw"), 133 * 4.0,
                     params=eff)
resp.plan.num_blocks = None          # an unannotated cache entry
for route, kw in (("fallback", {}),
                  ("fallback_bucketed",
                   {"bucketing": BucketConfig(bucket_bytes=128)})):
    st = {}
    C._planned_fallback_warned = False
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        res[f"planned/{route}"] = run(lambda v: C.allreduce_planned(
            v[0], "x", service=fsvc, stats=st, **kw)[None], inp["planned"])
    res[f"planned/{route}/stats"] = np.array(repr(sorted(st.items())))
    res[f"planned/{route}/warns"] = np.asarray(
        sum("flat plan-type labels" in str(w.message) for w in wl))
np.savez(sys.argv[1], **res)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(24)
    out = {"x": np.arange(N * 40, dtype=np.float32).reshape(N, 40) / 7.0,
           "pad": np.arange(N * 13, dtype=np.float32).reshape(N, 13),
           "int8": rng.standard_normal((N, 1000)).astype(np.float32),
           "z": rng.standard_normal((2, 4, 24)).astype(np.float32),
           "a2a": rng.standard_normal((N, 48)).astype(np.float32),
           "planned": np.arange(N * 133, dtype=np.float32).reshape(N, 133)}
    for n in NPO2:
        out[f"npo2/{n}"] = np.arange(n * 19, dtype=np.float32).reshape(
            n, 19) / 3.0
    sparse = np.zeros((N, 1000), np.float32)
    sparse[:, :5] = rng.standard_normal((N, 5))
    out["sparse"] = sparse
    # distinct magnitudes within and across ranks, random signs
    mags = rng.permutation(N * 1000).reshape(N, 1000).astype(np.float32)
    out["distinct"] = ((mags + 1.0) / 1000.0 * np.where(
        rng.random((N, 1000)) < 0.5, -1.0, 1.0)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("torch_collectives")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr((ALLREDUCE, RS, NPO2, FACTOR_SETS, TWO_AXIS))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(d / "out.npz"), spec,
         str(d / "inputs.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _ids(cases):
    return [f"{s}-{f}" for s, f in cases]


# ---------------------------------------------------------------------------
# tests/test_collectives.py's cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy,factors", ALLREDUCE, ids=_ids(ALLREDUCE))
def test_allreduce_matches_reference(ref, inputs, strategy, factors):
    x = inputs["x"]
    got = C.allreduce(_t(x), "x", strategy, factors=factors)
    want = ref[f"allreduce/{strategy}/{factors}"]
    assert _rel(got, want) <= 1e-6
    assert _rel(want, np.tile(x.astype(np.float64).sum(0), (N, 1))) <= 1e-6


@pytest.mark.parametrize("strategy,factors", RS, ids=_ids(RS))
def test_reduce_scatter_matches_reference(ref, inputs, strategy, factors):
    """Values and the shape contract: every strategy, psum included, hands
    back the flat (chunk,) shard, rank i slice i of the sum; its
    all-gather gives back the whole sum."""
    x = inputs["x"]
    got = C.reduce_scatter(_t(x), "x", strategy, factors=factors)
    want = ref[f"rs/{strategy}/{factors}"]
    assert tuple(got.shape) == want.shape == (N, x.shape[1] // N)
    assert _rel(got, want) <= 1e-6
    full = C.all_gather(got, "x", strategy, factors=factors)
    assert torch.equal(full, got.reshape(1, -1).expand(N, -1))
    assert _rel(full, ref[f"rs_ag/{strategy}/{factors}"]) <= 1e-6


@pytest.mark.parametrize("n", NPO2)
def test_rhd_on_axes_that_are_not_powers_of_two(ref, inputs, n):
    """The fold-in and fold-out of the χ(N) extras (3, 5, 6, 7 ranks)."""
    y = inputs[f"npo2/{n}"]
    got = C.allreduce(_t(y), "x", "rhd")
    assert _rel(got, ref[f"rhd/{n}"]) <= 1e-6


def test_padded_allreduce_matches_reference(ref, inputs):
    got = C.allreduce(_t(inputs["pad"]), "x", "hcps", factors=(2, 4))
    assert got.shape == (N, 13)
    assert _rel(got, ref["pad"]) <= 1e-6


def test_int8_cps_matches_reference(ref, inputs):
    """Within one int8 step of the shard's scale of the reference's
    output, and within 0.05 of the exact sum (the reference test's)."""
    g = inputs["int8"]
    got = S.allreduce_int8_cps(_t(g), "x").numpy()
    want = ref["int8"]
    exact = g.astype(np.float64).sum(0)
    step = np.abs(exact).max() / 127.0
    assert np.abs(got - want).max() <= 1.01 * step
    assert np.abs(got[0] - exact).max() / np.abs(exact).max() < 0.05
    assert (got == got[0]).all()


def test_sync_gradients_gentree_matches_reference(ref):
    cfg = S.SyncConfig(strategy="gentree", params=PAPER_TABLE5)
    (pl,) = S.resolve_axis_plans([("x", N)], cfg, 107.0)
    assert [pl.strategy, str(pl.factors)] == list(ref["gentree/plan"])
    stats = {}
    out = S.sync_gradients({"a": torch.ones((N, 100)),
                            "b": torch.full((N, 7), 2.0)}, [("x", N)], cfg,
                           stats)
    for k in ("a", "b"):
        assert torch.equal(out[k], _t(ref[f"gentree/{k}"]))
    assert stats["axis_plans"][0][:2] == ("x", pl.strategy)


@pytest.mark.parametrize("strategy,factors", TWO_AXIS, ids=_ids(TWO_AXIS))
def test_two_axis_sync_matches_reference(ref, inputs, strategy, factors):
    """The hierarchical sync over the (pod 2, data 4) mesh, leaf axis
    first: the (2, 4, 24) local mesh against the reference's shard_map."""
    z = inputs["z"]
    got = S.sync_gradients({"g": _t(z)}, [("data", 4), ("pod", 2)],
                           S.SyncConfig(strategy=strategy, factors=factors),
                           mesh=[("pod", 2), ("data", 4)])["g"]
    want = ref[f"two_axis/{strategy}/{factors}"]
    assert _rel(got, want) <= 1e-6
    assert _rel(got, np.broadcast_to(z.astype(np.float64).sum((0, 1)),
                                     z.shape)) <= 1e-6


@pytest.mark.parametrize("case", ["sparse", "distinct"])
def test_topk_allreduce_matches_reference(ref, inputs, case):
    """Exact where k covers every nonzero (the reference test's sparse
    case); within 1e-6 where the magnitudes are distinct (no ties)."""
    g = inputs[case]
    got = S.allreduce_topk(_t(g), "x", k_frac=0.01)
    want = ref[f"topk/{case}"]
    if case == "sparse":
        assert np.array_equal(got.numpy(), want)
        assert np.allclose(got[0].numpy(), g.sum(0), rtol=1e-5, atol=1e-6)
    else:
        assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# beyond the reference tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factors", FACTOR_SETS, ids=str)
def test_hcps_shard_index_matches_reference(ref, factors):
    assert C.hcps_shard_index(factors) == list(
        ref[f"shard_index/{factors}"])


@pytest.mark.parametrize("factors", [(4, 2), (2, 4), (2, 2, 2)], ids=str)
def test_hcps_reduce_scatter_is_natural_without_the_reorder_copy(factors):
    """reduce_scatter's hcps shards are in natural order (rank i slice i);
    the reorder is the last fold's output rows, not a copy."""
    x = torch.randn((N, 64), generator=torch.Generator().manual_seed(3))
    got = C.reduce_scatter(x, "x", "hcps", factors=factors)
    want = x.double().sum(0).reshape(N, -1)
    assert _rel(got, want) <= 1e-6
    prog = C.flat_program("hcps", "reduce_scatter", (N,), (0,),
                          tuple(factors), order=True)
    assert prog.folds == len(factors) and prog.copies == 0


@pytest.mark.parametrize("what", ["a2a/plain", "a2a/plan", "ep/plain",
                                  "ep/plan"])
def test_all_to_all_matches_reference(ref, inputs, what):
    """all_to_all and ep_all_to_all, each with and without the lowered
    all-to-all plan: exactly the reference's exchange."""
    x = _t(inputs["a2a"])
    sched = lower_plan(alltoall_plan(N, 1e6)) if what.endswith("plan") \
        else None
    if what.startswith("a2a"):
        got = C.all_to_all(x, "x", schedule=sched)
    else:
        with S.expert_parallel("x", N, sched) as ctx:
            assert S.ep_context() is ctx
            got = S.ep_all_to_all(x, "x")
        assert S.ep_context() is None
    assert np.array_equal(got.numpy(), ref[what])


def _stats(st: dict) -> dict:
    return {k: v for k, v in st.items() if k not in ("source",)}


@pytest.mark.parametrize("route,kw", [
    ("plan", {}), ("bucketed", {"bucketing": BucketConfig(bucket_bytes=128)}),
    ("tolerance", {"tolerance": 1e-2})], ids=["plan", "bucketed",
                                              "tolerance"])
def test_allreduce_planned_matches_reference(ref, inputs, route, kw):
    """The plan route (its stats but the cache source: mode, algo,
    precision), the bucketed route (the bucket count and pipeline flag)
    and the tolerance-priced precision, with the values."""
    svc = PlannerService(params=PAPER_TABLE5)
    st = {}
    got = C.allreduce_planned(_t(inputs["planned"]), "x", service=svc,
                              stats=st, **kw)
    want_st = dict(eval(str(ref[f"planned/{route}/stats"])))
    assert _stats(st) == _stats(want_st)
    tol = 1e-6 if st.get("precision", "f32") == "f32" else 2e-2
    assert _rel(got, ref[f"planned/{route}"]) <= tol


@pytest.mark.parametrize("route,kw", [
    ("fallback", {}),
    ("fallback_bucketed", {"bucketing": BucketConfig(bucket_bytes=128)})],
    ids=["direct", "bucketed"])
def test_allreduce_planned_flat_label_fallback(ref, inputs, route, kw):
    """A plan that does not lower: the flat label the service picks, its
    reason and the ignored bucketing in `stats`, one warning a process,
    the reference's values."""
    from repro_torch.core.sync import level_switch_topo
    svc = PlannerService(params=PAPER_TABLE5)
    eff = svc._effective_axis_params()
    resp = svc.get_plan(level_switch_topo(N, eff, "root_sw"), 133 * 4.0,
                        params=eff)
    resp.plan.num_blocks = None
    st = {}
    C._planned_fallback_warned = False
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        got = C.allreduce_planned(_t(inputs["planned"]), "x", service=svc,
                                  stats=st, **kw)
        C.allreduce_planned(_t(inputs["planned"]), "x", service=svc)
    want_st = dict(eval(str(ref[f"planned/{route}/stats"])))
    assert st["mode"] == want_st["mode"] == "flat-label"
    assert st["strategy"] == want_st["strategy"]
    assert st["bucketing_ignored"] == want_st["bucketing_ignored"] \
        == ("bucketing" in kw)
    assert "no block annotations" in st["fallback_reason"]
    assert sum("flat plan-type labels" in str(w.message) for w in wl) \
        == int(ref[f"planned/{route}/warns"]) == 1
    assert _rel(got, ref[f"planned/{route}"]) <= 1e-6


def test_cpu_path_counts_no_launch(inputs):
    """On the CPU every fold is the plain version: no kernel launch is
    counted, whatever the strategy."""
    before = dict(ops.LAUNCHES)
    x = _t(inputs["x"])
    for strategy, factors in ALLREDUCE:
        C.allreduce(x, "x", strategy, factors=factors)
        C.reduce_scatter(x, "x", strategy, factors=factors)
    S.allreduce_int8_cps(_t(inputs["int8"]), "x")
    S.sync_gradients({"g": x}, [("x", N)], S.SyncConfig(strategy="ring"))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("strategy,n,folds,copies", [
    ("ring", 8, 7, 7), ("rhd", 8, 3, 3), ("rhd", 6, 3, 3), ("cps", 8, 1, 1),
    ("psum", 8, 1, 1), ("hcps", 8, 3, 3)])
def test_fold_and_copy_counts(strategy, n, folds, copies):
    """The structure each strategy's launches are counted by: ring n − 1
    folds and n − 1 copies; rhd log2 p each, plus the fold-in and the
    fold-out at n ≠ p; cps and psum one of each; hcps one a stage."""
    fac = (2, 2, 2) if strategy == "hcps" else None
    if strategy == "psum":
        progs = [C.flat_program("psum", "allreduce", (n,), (0,))]
    else:
        progs = [C.flat_program(strategy, h, (n,), (0,), fac)
                 for h in ("reduce_scatter", "all_gather")]
    assert sum(p.folds for p in progs) == folds
    assert sum(p.copies for p in progs) == copies


def test_unknown_strategy_and_missing_factors_raise():
    x = torch.zeros((N, 16))
    with pytest.raises(ValueError, match="unknown strategy"):
        C.allreduce(x, "x", "tree")
    with pytest.raises(ValueError, match="factors"):
        C.allreduce(x, "x", "hcps")
    with pytest.raises(ValueError, match="not in the mesh"):
        C.allreduce(x, "y", "ring", mesh=[("x", N)])
    with pytest.raises(ValueError, match="leads with"):
        C.allreduce(x, "x", "ring", mesh=[("x", 4)])


def test_bucketed_sync_over_two_live_axes_raises():
    """`sync_gradients` with "plan" and buckets over two live axes takes
    the bucketed path, the reference's hierarchical bucket chain (it
    raised until the chain was ported); it agrees with the per-leaf
    two-axis sync (`bucket_bytes=0`) within 1e-6, at the default bucket
    (one) and at a pinned 64 bytes (a bucket a leaf)."""
    z = torch.randn((2, 4, 24), generator=torch.Generator().manual_seed(5))
    y = torch.randn((2, 4, 3, 7), generator=torch.Generator().manual_seed(6))
    axes, mesh = [("data", 4), ("pod", 2)], [("pod", 2), ("data", 4)]
    per_leaf = S.sync_gradients({"g": z, "h": y}, axes, S.SyncConfig(
        strategy="plan", bucket_bytes=0, params=PAPER_TABLE5), mesh=mesh)
    for x, k in ((z, "g"), (y, "h")):
        assert _rel(per_leaf[k], np.broadcast_to(
            x.double().sum((0, 1)).numpy(), x.shape)) <= 1e-6
    for bucket_bytes in (None, 64):
        stats = {}
        got = S.sync_gradients({"g": z, "h": y}, axes, S.SyncConfig(
            strategy="plan", bucket_bytes=bucket_bytes,
            params=PAPER_TABLE5), stats=stats, mesh=mesh)
        assert stats["axes"] == axes
        if bucket_bytes is None:
            assert stats["num_buckets"] == 1
        else:
            assert stats["bucket_bytes"] == bucket_bytes
        for k in ("g", "h"):
            assert got[k].shape == per_leaf[k].shape
            assert _rel(got[k], per_leaf[k].numpy()) <= 1e-6
