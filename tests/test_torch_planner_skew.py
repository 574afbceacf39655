"""The port's arrival-skew pricing against the JAX package's, on the CPU.

- `planner.skew`: `draw_offsets` equal arrays for every distribution and
  seed; `SkewModel.key` and `from_offsets` equal; `arrival_gated_time`,
  `gated_times` and `expected_time` within 1e-12 relative on the
  reference tests' topologies and plans; `pick_plan_under_skew` the same
  winner and cost;
- `PlannerService.get_plan` under a skew model: the same `algo`,
  `plan_to_json`, `predicted_time`, `expected_skewed_time` (1e-12) and
  cache key as the reference service's, the skew model in the key;
- `observe_arrivals` / `adopt_empirical_skew`: None without arrivals,
  then the reference's model key, and `get_plan` / `get_bucket_plan`
  re-keyed as the reference's are.

Both packages price with `PAPER_TABLE5`, passed explicitly.
"""
import numpy as np
import pytest

from repro.core import plans as jplans
from repro.core import topology as jtopo
from repro.core.bucketing import BucketConfig as JBucketConfig
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.core.gentree import baseline_plan as jbaseline
from repro.core.gentree import gentree as jgentree
from repro.planner import skew as jskew
from repro.planner.cache import plan_to_json as jplan_to_json
from repro.planner.service import PlannerService as JService

from repro_torch.core import plans as tplans
from repro_torch.core import topology as ttopo
from repro_torch.core.bucketing import BucketConfig as TBucketConfig
from repro_torch.core.cost_model import PAPER_TABLE5 as T_TABLE5
from repro_torch.core.gentree import baseline_plan as tbaseline
from repro_torch.core.gentree import gentree as tgentree
from repro_torch.planner import skew as tskew
from repro_torch.planner.cache import plan_to_json as tplan_to_json
from repro_torch.planner.service import PlannerService

REL = 1e-12
# (dist, scale, frac, draws, seed, offsets) of the models compared
MODELS = {
    "exp": ("exponential", 0.1, 1.0, 8, 0, None),
    "exp_half": ("exponential", 0.05, 0.5, 5, 7, None),
    "uniform": ("uniform", 0.02, 1.0, 6, 3, None),
    "none": ("none", 0.1, 1.0, 8, 0, None),
    "zero_scale": ("exponential", 0.0, 1.0, 8, 0, None),
    "empirical": ("empirical", 0.3, 1.0, 8, 1,
                  (0.0, 0.0, 0.05, 0.1, 0.1, 0.2, 0.3)),
}
# the reference tests' topologies (tests/test_simfast.py, test_planner.py)
TOPOS = {
    "flat12": ("single_switch", (12,), {}),
    "flat15": ("single_switch", (15,), {}),
    "flat8": ("single_switch", (8,), {}),
    "tree4x6": ("symmetric_tree", (4, 6), {}),
    "tree2x4": ("symmetric_tree", (2, 4), {}),
    "cross_dc": ("cross_dc", (), dict(dc0_middle=2, dc0_servers=4,
                                      dc1_middle=2, dc1_servers=3)),
}


def _model(mod, name):
    dist, scale, frac, draws, seed, offs = MODELS[name]
    return mod.SkewModel(dist=dist, scale=scale, frac=frac, draws=draws,
                         seed=seed, offsets=offs)


def _topos(name):
    fn, args, kw = TOPOS[name]
    return getattr(jtopo, fn)(*args, **kw), getattr(ttopo, fn)(*args, **kw)


def _close(a, b, rel=REL) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-300


def _plans(name, size):
    """(label, reference plan, port plan) of ring, cps and GenTree."""
    jt, tt = _topos(name)
    out = [(k, jbaseline(k, jt, size), tbaseline(k, tt, size))
           for k in ("ring", "cps")]
    out.append(("gentree", jgentree(jt, size, J_TABLE5).plan,
                tgentree(tt, size, T_TABLE5).plan))
    return jt, tt, out


# ---- SkewModel and draw_offsets ---------------------------------------------
@pytest.mark.parametrize("n", [8, 15])
@pytest.mark.parametrize("name", list(MODELS))
def test_draw_offsets_match_reference(name, n):
    j, t = _model(jskew, name), _model(tskew, name)
    assert t.key() == j.key()
    got, want = tskew.draw_offsets(t, n), jskew.draw_offsets(j, n)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offsets", [[2.0, 2.1, 2.5], [0.0] * 10 + [
    0.05, 0.1, 0.1, 0.2, 0.3], [0.4]])
def test_from_offsets_matches_reference(offsets):
    j = jskew.SkewModel.from_offsets(offsets, draws=6, seed=2)
    t = tskew.SkewModel.from_offsets(offsets, draws=6, seed=2)
    assert t.key() == j.key()
    assert (t.dist, t.scale, t.offsets) == (j.dist, j.scale, j.offsets)


def test_skew_model_refuses_what_the_reference_refuses():
    for kw in ({"dist": "zipf"}, {"dist": "empirical"}):
        with pytest.raises(ValueError):
            jskew.SkewModel(**kw)
        with pytest.raises(ValueError):
            tskew.SkewModel(**kw)
    with pytest.raises(ValueError):
        tskew.SkewModel.from_offsets([])


# ---- arrival-gated pricing --------------------------------------------------
@pytest.mark.parametrize("model", ["exp", "uniform", "empirical"])
@pytest.mark.parametrize("topo", ["flat12", "tree4x6", "cross_dc"])
def test_gated_times_match_reference(topo, model):
    jt, tt, plans = _plans(topo, 1e6)
    n = jt.num_servers()
    offs = jskew.draw_offsets(_model(jskew, model), n)
    for label, jp, tp in plans:
        want = jskew.gated_times(jp, jt, J_TABLE5, offs)
        got = tskew.gated_times(tp, tt, T_TABLE5, offs)
        assert got.shape == want.shape
        for g, w in zip(got, want):
            assert _close(g, w), (label, g, w)
        for o, w in zip(offs, want):
            assert _close(tskew.arrival_gated_time(tp, tt, T_TABLE5, o),
                          jskew.arrival_gated_time(jp, jt, J_TABLE5, o))
        assert _close(tskew.gated_times(tp, tt, T_TABLE5)[0],
                      jskew.gated_times(jp, jt, J_TABLE5)[0])
        assert _close(
            tskew.expected_time(tp, tt, _model(tskew, model), T_TABLE5),
            jskew.expected_time(jp, jt, _model(jskew, model), J_TABLE5))


@pytest.mark.parametrize("unit_bytes", [2, 4])
def test_expected_time_units_match_reference(unit_bytes):
    jt, tt, plans = _plans("tree2x4", 1 << 20)
    for label, jp, tp in plans:
        assert _close(
            tskew.expected_time(tp, tt, _model(tskew, "exp"), T_TABLE5,
                                unit_bytes=unit_bytes),
            jskew.expected_time(jp, jt, _model(jskew, "exp"), J_TABLE5,
                                unit_bytes=unit_bytes)), label


@pytest.mark.parametrize("model", ["zero_scale", "exp", "empirical",
                                   "uniform"])
@pytest.mark.parametrize("engine", ["fast", "reference"])
def test_pick_plan_under_skew_matches_reference(model, engine):
    # the reference's winner flip: n = 15 on the paper's ToR, ring against
    # cps, synchronized and skewed
    n, s = 15, 1.8e8
    jparams = {k: J_TABLE5[k] for k in ("middle_sw", "server")}
    tparams = {k: T_TABLE5[k] for k in ("middle_sw", "server")}
    jt, tt = jtopo.single_switch(n), ttopo.single_switch(n)
    jc = [("ring", jplans.ring(n, s)), ("cps", jplans.cps(n, s))]
    tc = [("ring", tplans.ring(n, s)), ("cps", tplans.cps(n, s))]
    jname, _, jcost = jskew.pick_plan_under_skew(
        jc, jt, _model(jskew, model), jparams, engine=engine)
    tname, tplan, tcost = tskew.pick_plan_under_skew(
        tc, tt, _model(tskew, model), tparams, engine=engine)
    assert tname == jname and tplan.name == jname
    assert _close(tcost, jcost)
    with pytest.raises(ValueError):
        tskew.pick_plan_under_skew([], tt, _model(tskew, model))


# ---- the service's re-ranking -----------------------------------------------
def _same_response(got, want):
    assert got.key == want.key
    assert (got.algo, got.source, got.nbytes_bucket) == (
        want.algo, want.source, want.nbytes_bucket)
    assert tplan_to_json(got.plan) == jplan_to_json(want.plan)
    assert _close(got.predicted_time, want.predicted_time)
    assert (got.expected_skewed_time is None) == (
        want.expected_skewed_time is None)
    if want.expected_skewed_time is not None:
        assert _close(got.expected_skewed_time, want.expected_skewed_time)
    assert got.decisions == want.decisions


@pytest.mark.parametrize("nbytes", [1 << 16, 1 << 22, 1 << 26])
@pytest.mark.parametrize("model", ["exp", "uniform", "empirical", "none"])
@pytest.mark.parametrize("topo", ["flat8", "flat15", "tree2x4"])
def test_service_get_plan_under_skew_matches_reference(topo, model, nbytes):
    jt, tt = _topos(topo)
    j = JService(params=J_TABLE5, skew=_model(jskew, model))
    t = PlannerService(params=T_TABLE5, skew=_model(tskew, model))
    want, got = j.get_plan(jt, nbytes), t.get_plan(tt, nbytes)
    _same_response(got, want)
    if MODELS[model][0] != "none":
        assert got.expected_skewed_time is not None
        assert got.algo in ("gentree", "cps", "ring", "rhd")
    # a memory hit returns the same answer, the skewed price included
    again = t.get_plan(tt, nbytes)
    assert again.source == "memory" and again.algo == got.algo
    assert again.expected_skewed_time == got.expected_skewed_time
    # the skew model is part of the key: without it the entry is cold
    plain = PlannerService(params=T_TABLE5, cache=t.cache).get_plan(tt,
                                                                    nbytes)
    assert plain.source == "cold" and plain.key != got.key
    assert plain.expected_skewed_time is None


def test_service_baseline_kinds_match_reference():
    # rhd only at a power of two; a baseline win empties the decisions
    for n in (6, 8):
        jt, tt = jtopo.single_switch(n), ttopo.single_switch(n)
        kw = dict(baseline_kinds=("rhd", "ring"))
        j = JService(params=J_TABLE5, skew=_model(jskew, "exp"), **kw)
        t = PlannerService(params=T_TABLE5, skew=_model(tskew, "exp"), **kw)
        _same_response(t.get_plan(tt, 1 << 24), j.get_plan(jt, 1 << 24))


def test_service_reranks_to_a_baseline_like_the_reference():
    # heavy skew on the two-level tree: a baseline beats GenTree, and its
    # per-switch decisions are dropped
    jt, tt = jtopo.symmetric_tree(2, 4), ttopo.symmetric_tree(2, 4)
    picks = set()
    for scale in (1e-4, 1e-2, 1.0):
        j = JService(params=J_TABLE5,
                     skew=jskew.SkewModel(scale=scale, draws=8, seed=0))
        t = PlannerService(params=T_TABLE5,
                           skew=tskew.SkewModel(scale=scale, draws=8,
                                                seed=0))
        got = t.get_plan(tt, 1 << 20)
        _same_response(got, j.get_plan(jt, 1 << 20))
        picks.add(got.algo)
        if got.algo != "gentree":
            assert got.decisions == {}
    assert picks - {"gentree"}, picks


# ---- measured arrivals ------------------------------------------------------
ARRIVALS = [0.0, 0.01, 0.05, 0.0, 0.0, 0.2, 0.0, 0.02]


def test_adopt_empirical_skew_matches_reference():
    j, t = JService(params=J_TABLE5), PlannerService(params=T_TABLE5)
    assert t.adopt_empirical_skew() is None
    assert j.adopt_empirical_skew() is None
    jt, tt = jtopo.single_switch(8), ttopo.single_switch(8)
    jcfg, tcfg = JBucketConfig(), TBucketConfig()
    before = t.get_plan(tt, 1 << 20)
    bp_before = t.get_bucket_plan([("data", 8)], 1e6, params=T_TABLE5,
                                  config=tcfg)
    assert bp_before.key == j.get_bucket_plan(
        [("data", 8)], 1e6, params=J_TABLE5, config=jcfg).key
    for k in range(3):
        arr = [a * (k + 1) for a in ARRIVALS]
        t.observe_arrivals(arr)
        j.observe_arrivals(arr)
    # one collective is not enough when more are asked for
    assert t.adopt_empirical_skew(min_collectives=4) is None
    tm = t.adopt_empirical_skew(draws=6, seed=3)
    jm = j.adopt_empirical_skew(draws=6, seed=3)
    assert tm is not None and t.skew is tm and tm.dist == "empirical"
    assert tm.key() == jm.key()
    after = t.get_plan(tt, 1 << 20)
    assert after.key != before.key and after.source == "cold"
    _same_response(after, j.get_plan(jt, 1 << 20))
    bp_after = t.get_bucket_plan([("data", 8)], 1e6, params=T_TABLE5,
                                 config=tcfg)
    assert bp_after.key != bp_before.key and bp_after.source == "cold"
    assert bp_after.key == j.get_bucket_plan(
        [("data", 8)], 1e6, params=J_TABLE5, config=jcfg).key
