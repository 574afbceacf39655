"""The port's whole-step plans against the JAX package's, on the CPU.

`PlannerService.get_step_plan` on the reference tests' mix (`MIX`,
tests/test_families.py) over one data axis of 8 and on the MoE census of
benchmarks/step_bench.py (`MOE_MIX`) over its 32 × 16 mesh, with and
without a tolerance or a pinned wire:
- every family's quote (count, size, per-call total, the coalesced
  per-term breakdown and total, the pipelined and contended times, the
  overlap certificate, the regime and its total, the precision), the
  three totals, `ratio`, the chosen precision and the cache key within
  1e-9 relative of the reference service's;
- the pricing-consistency invariant (tests/test_families.py): Σ each
  family's coalesced terms is its total, and Σ families is `total_joint`;
- `schedules[family]`: the structure of the reference's schedule
  (rounds, folds, shards, placement), bound to the same wire;
- a memory hit and a disk re-resolve return the same plan;
- a census (`ModuleStats`) of collective calls prices the reference's
  plan for the same fields.

Both packages price with the params passed to both (`PAPER_TABLE5`, or
`GPU_AXIS_BASIS`, the port's uncalibrated axis basis).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.cost_model import GenModelParams as JParams
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.planner.service import PlannerService as JService

from repro_torch.core.cost_model import GPU_AXIS_BASIS, PAPER_TABLE5
from repro_torch.planner.service import PlannerService, StepPlan

REL = 1e-9
J_GPU = {k: JParams(**dataclasses.asdict(v))
         for k, v in GPU_AXIS_BASIS.items()}
PARAMS = {"table5": (PAPER_TABLE5, J_TABLE5), "gpu": (GPU_AXIS_BASIS, J_GPU)}
# tests/test_families.py's MIX
MIX = {"allreduce": {"count": 4, "size_floats": 1 << 20},
       "reduce_scatter": {"count": 2, "size_floats": 1 << 18},
       "allgather": {"count": 2, "size_floats": 1 << 18},
       "all_to_all": {"count": 6, "size_floats": 1 << 16},
       "p2p": {"count": 1, "size_floats": 1 << 14}}
# benchmarks/step_bench.py's MESH and MOE_MIX
MOE_MESH = [("data", 32), ("pod", 16)]
MOE_MIX = {"allreduce": {"count": 24, "size_floats": 2_500_000},
           "reduce_scatter": {"count": 24, "size_floats": 2_500_000},
           "allgather": {"count": 24, "size_floats": 2_500_000},
           "all_to_all": {"count": 52, "size_floats": 131_072},
           "p2p": {"count": 1, "size_floats": 1_048_576}}
CASES = {"mix": ([("data", 8)], MIX), "moe": (MOE_MESH, MOE_MIX)}
VARIANTS = {"auto": {}, "tol1e-2": {"tolerance": 1e-2},
            "tol0.1": {"tolerance": 0.1}, "fp8": {"precision": "fp8"},
            "bf16_tol1e-2": {"precision": "bf16", "tolerance": 1e-2},
            "dtype_bf16": {"dtype": "bfloat16"}}


def _close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b)) + 1e-300


def _same_value(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k, v in want.items():
            _same_value(got[k], v, (where, k))
    elif isinstance(want, (bool, str, type(None))):
        assert got == want, where
    else:
        assert _close(float(got), float(want)), (where, got, want)


def _same_step(tst, jst):
    assert tst.n_slots == jst.n_slots
    assert len(tst.rounds) == len(jst.rounds)
    for tr, jr in zip(tst.rounds, jst.rounds):
        assert tr.perm == jr.perm
        np.testing.assert_array_equal(tr.send_blks, jr.send_blks)
        np.testing.assert_array_equal(tr.recv_off, jr.recv_off)
    assert len(tst.folds) == len(jst.folds)
    for tf, jf in zip(tst.folds, jst.folds):
        np.testing.assert_array_equal(tf.blk, jf.blk)
        np.testing.assert_array_equal(tf.ops, jf.ops)
        np.testing.assert_array_equal(tf.include_self, jf.include_self)


def _same_schedule(ts, js):
    assert ts.describe() == js.describe()
    assert (ts.n, ts.num_blocks, ts.blocks_per_shard, ts.placement,
            ts.family, ts.perm_pairs) == (js.n, js.num_blocks,
                                          js.blocks_per_shard, js.placement,
                                          js.family, js.perm_pairs)
    assert (ts.wire and ts.wire.name) == (js.wire and js.wire.name)
    np.testing.assert_array_equal(ts.owner_of_block, js.owner_of_block)
    for th, jh in ((ts.rs, js.rs), (ts.ag, js.ag)):
        assert len(th) == len(jh)
        for tst, jst in zip(th, jh):
            _same_step(tst, jst)
    for tx, jx in ((ts.reorder, js.reorder), (ts.unorder, js.unorder)):
        assert (tx is None) == (jx is None)
        if tx is not None:
            _same_step(tx, jx)


def _same_step_plan(got, want):
    assert isinstance(got, StepPlan)
    assert got.key == want.key
    assert (got.axes, got.precision, got.source) == (
        want.axes, want.precision, want.source)
    for f in ("total_per_call", "total_joint", "total_best", "ratio"):
        assert _close(getattr(got, f), getattr(want, f)), f
    assert sorted(got.quotes) == sorted(want.quotes)
    for fam, q in want.quotes.items():
        _same_value(got.quotes[fam], q, fam)
    assert sorted(got.schedules) == sorted(want.schedules)
    for fam, js in want.schedules.items():
        _same_schedule(got.schedules[fam], js)


def _plans(case, variant, params="table5"):
    axes, mix = CASES[case]
    tp, jp = PARAMS[params]
    kw = dict(VARIANTS[variant])
    got = PlannerService().get_step_plan(axes, mix, params=tp, **kw)
    want = JService().get_step_plan(axes, mix, params=jp, **kw)
    return got, want


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(CASES))
def test_step_plan_matches_reference(case, variant):
    got, want = _plans(case, variant)
    _same_step_plan(got, want)


@pytest.mark.parametrize("variant", ["auto", "tol0.1"])
@pytest.mark.parametrize("case", list(CASES))
def test_uncalibrated_basis_matches_reference_given_it(case, variant):
    axes, mix = CASES[case]
    got = PlannerService().get_step_plan(axes, mix, **VARIANTS[variant])
    want = JService().get_step_plan(axes, mix, params=J_GPU,
                                    **VARIANTS[variant])
    _same_step_plan(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_step_plan_pricing_consistency(case):
    """Σ per-family joint terms equals the joint total (1e-9), the
    per-call regime bounds the argmin, and every family has a schedule."""
    axes, mix = CASES[case]
    sp = PlannerService().get_step_plan(axes, mix)
    total = 0.0
    for fam, q in sp.quotes.items():
        assert q["joint"], fam
        fam_total = sum(q["joint"].values())
        assert abs(fam_total - q["joint_total"]) <= \
            1e-9 * max(1.0, q["joint_total"]), (fam, fam_total, q)
        total += fam_total
    assert abs(total - sp.total_joint) <= 1e-9 * max(1.0, sp.total_joint)
    assert 0.0 < sp.ratio <= 1.0 + 1e-12
    assert sp.total_best <= sp.total_per_call * (1 + 1e-12)
    assert sorted(sp.schedules) == sorted(mix)


def test_step_plan_aliases_and_tuples_match_reference():
    mix = {"all-reduce": (3, 4096.0), "all_reduce": {"count": 1,
                                                     "size_floats": 1024},
           "all-to-all": (2, 512.0), "collective-permute": (1, 64.0),
           "reduce-scatter": (0, 100.0), "all-gather": (2, 0.0)}
    got = PlannerService().get_step_plan([("data", 4)], mix,
                                         params=PAPER_TABLE5)
    want = JService().get_step_plan([("data", 4)], mix, params=J_TABLE5)
    _same_step_plan(got, want)
    assert sorted(got.quotes) == ["all_to_all", "allreduce", "p2p"]
    assert got.quotes["allreduce"]["count"] == 4


def test_step_plan_without_live_axes_or_mix_matches_reference():
    for axes, mix in (([("data", 1)], MIX), ([("data", 8)], {})):
        got = PlannerService().get_step_plan(axes, mix, params=PAPER_TABLE5)
        want = JService().get_step_plan(axes, mix, params=J_TABLE5)
        _same_step_plan(got, want)
        assert got.quotes == {} and got.schedules == {}


def test_step_plan_memory_and_disk(tmp_path):
    path = str(tmp_path / "plans.json")
    axes, mix = CASES["mix"]
    t = PlannerService(cache_path=path)
    a = t.get_step_plan(axes, mix, tolerance=0.1)
    b = t.get_step_plan(axes, mix, tolerance=0.1)
    assert (a.source, b.source) == ("cold", "memory") and b.key == a.key
    assert b.schedules["allreduce"] is a.schedules["allreduce"]
    t.save()
    c = PlannerService(cache_path=path).get_step_plan(axes, mix,
                                                      tolerance=0.1)
    assert c.source == "disk" and c.key == a.key
    assert (c.precision, c.ratio, c.total_best) == (a.precision, a.ratio,
                                                    a.total_best)
    for fam, cs in a.schedules.items():
        _same_schedule(c.schedules[fam], cs)
    # a different mix or tolerance is a different entry
    assert t.get_step_plan(axes, mix).key != a.key


def test_census_mix_is_not_ported():
    """A census (`launch.analysis.census` of collective calls on the local
    mesh: two all-reduces, a reduce-scatter and an all-gather of a
    gradient, an all-to-all) prices the same step plan as the
    reference's service on the same `ModuleStats` fields."""
    import torch

    from repro.launch.hlo_analysis import ModuleStats as JStats
    from repro_torch.core import collectives
    from repro_torch.launch import analysis

    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 3000)).astype(np.float32))
    with analysis.census(8) as c:
        for x in (g, g[:, :1000]):
            collectives.allreduce(x, "data", "ring")
        shard = collectives.reduce_scatter(g, "data", "psum")
        collectives.all_gather(shard, "data", "psum")
        collectives.all_to_all(g[:, :2048], "data")
    stats = c.stats()
    assert stats.coll_counts == {"all-reduce": 2, "reduce-scatter": 1,
                                 "all-gather": 1, "all-to-all": 1}
    jstats = JStats(**dataclasses.asdict(stats))
    axes = [("data", 8)]
    got = PlannerService().get_step_plan(axes, stats, params=PAPER_TABLE5)
    want = JService().get_step_plan(axes, jstats, params=J_TABLE5)
    _same_step_plan(got, want)
    assert set(got.schedules) == set(want.schedules) == {
        "allreduce", "reduce_scatter", "allgather", "all_to_all"}
