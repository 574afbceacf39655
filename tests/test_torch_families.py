"""The port's collective families on the local mesh against the JAX
package's.

Plans come from each package's own GenTree on the same topology with the
same explicit params (the paper's Table 5): reduce-scatter and all-gather
are the halves of the AllReduce plan (`plans.family_halves`), all-to-all
and p2p the flat builders. Each `run_local_*` entry point (kernel
wrappers on the CPU, i.e. their plain versions) is held against the
reference's `reduce_scatter` / `all_gather` / `all_to_all` / `p2p` run
under `shard_map` on 8 forced host devices and a plain
`jax.sharding.Mesh` (one subprocess runs every case), and against a
plain numpy statement of the family. The port's `get_family_executable`
and its degraded-link repricing are held against the reference service.

Tolerances: f32 reduce-scatter within 1e-6 of the largest |value| (the
same f32 adds, possibly in another order); the f32 movement families
exactly; a compressed wire within its `Precision.error_budget` plus 1e-6
of the reference's own wire result, and within its budget of the exact
answer; predicted times within 1e-9 relative.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import plans as jplans
from repro.core import topology as jtopo
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.core.gentree import gentree as jgentree
from repro.core.lower import lower_plan as jlower
from repro.planner.service import PlannerService as JService

from repro_torch.core import plans as tplans
from repro_torch.core import topology as ttopo
from repro_torch.core.cost_model import PAPER_TABLE5 as T_TABLE5, PRECISIONS
from repro_torch.core.gentree import gentree as tgentree
from repro_torch.core.lower import (LoweringError, guard_schedule,
                                    lower_plan as tlower)
from repro_torch.kernels import ops
from repro_torch.planner.service import FAMILY_ALIASES, PlannerService

TOPOS = {  # name -> (builder args); flat n=8, the two-level tree, n=6
    "flat8": ("single_switch", (8,)),
    "two_level": ("symmetric_tree", (2, 4)),
    "flat6": ("single_switch", (6,)),
}
FAMILIES = ["reduce_scatter", "allgather", "all_to_all", "p2p"]
WIRES = ["bf16", "fp8", "int8"]
SEEDS = {"flat8": 1, "two_level": 2, "flat6": 3}
FAMILY_SEED = {f: 10 * i for i, f in enumerate(FAMILIES)}
# per-rank sizes: reduce-scatter a size the n=6 plans must pad;
# all-gather a shard of whole blocks; all-to-all 312 = 8 · 39 = 6 · 52
SIZES = {"reduce_scatter": 1000, "allgather": 40, "all_to_all": 312,
         "p2p": 300}
ENTRY = {"reduce_scatter": "run_local_reduce_scatter",
         "allgather": "run_local_all_gather",
         "all_to_all": "run_local_all_to_all", "p2p": "run_local_p2p"}

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import plans, topology
from repro.core.compat import shard_map
from repro.core.cost_model import PAPER_TABLE5, PRECISIONS
from repro.core.gentree import gentree
from repro.core.lower import lower_plan

TOPOS, FAMILIES, WIRES, SEEDS, FAMILY_SEED, SIZES = eval(sys.argv[2])
res = {}
for name, (builder, args) in TOPOS.items():
    topo = getattr(topology, builder)(*args)
    n = topo.num_servers()
    rs, ag = plans.family_halves(gentree(topo, 1e6,
                                         params=PAPER_TABLE5).plan)
    scheds = {"reduce_scatter": lower_plan(rs), "allgather": lower_plan(ag),
              "all_to_all": lower_plan(plans.alltoall_plan(n, 1e6)),
              "p2p": lower_plan(plans.p2p_plan(n, 1e6))}
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    for fam in FAMILIES:
        cs = scheds[fam]
        X = np.random.default_rng(SEEDS[name] + FAMILY_SEED[fam]
                                  ).standard_normal(
            (n, SIZES[fam])).astype(np.float32)
        for wire in [None] + WIRES:
            s = cs if wire is None else cs.with_wire(PRECISIONS[wire])
            method = {"reduce_scatter": s.reduce_scatter,
                      "allgather": s.all_gather,
                      "all_to_all": s.all_to_all, "p2p": s.p2p}[fam]
            f = jax.jit(shard_map(lambda v, m=method: m(v[0], "x")[None],
                                  mesh=mesh, in_specs=P("x"),
                                  out_specs=P("x")))
            res[f"{name}/{fam}/{wire}"] = np.asarray(f(jnp.asarray(X)))
np.savez(sys.argv[1], **res)
"""

def _inputs(name, family, n):
    rng = np.random.default_rng(SEEDS[name] + FAMILY_SEED[family])
    return rng.standard_normal((n, SIZES[family])).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _halves(mod_plans, gentree, topo_mod, params, name):
    builder, args = TOPOS[name]
    return mod_plans.family_halves(
        gentree(getattr(topo_mod, builder)(*args), 1e6, params=params).plan)


def _schedules(name):
    """{family: (reference schedule, port schedule)} on topology `name`."""
    jrs, jag = _halves(jplans, jgentree, jtopo, J_TABLE5, name)
    trs, tag = _halves(tplans, tgentree, ttopo, T_TABLE5, name)
    n = trs.n
    return {"reduce_scatter": (jlower(jrs), tlower(trs)),
            "allgather": (jlower(jag), tlower(tag)),
            "all_to_all": (jlower(jplans.alltoall_plan(n, 1e6)),
                           tlower(tplans.alltoall_plan(n, 1e6))),
            "p2p": (jlower(jplans.p2p_plan(n, 1e6)),
                    tlower(tplans.p2p_plan(n, 1e6)))}


def _run(cs, family, X):
    return getattr(cs, ENTRY[family])(torch.from_numpy(X)).numpy()


def _exact(cs, family, X):
    """The family's answer, stated plainly in numpy (f64)."""
    n = X.shape[0]
    X = X.astype(np.float64)
    if family == "reduce_scatter":
        pad = (-X.shape[1]) % cs.num_blocks
        return np.pad(X, ((0, 0), (0, pad))).sum(0).reshape(n, -1)
    if family == "allgather":
        return np.broadcast_to(X.reshape(-1), (n, X.size))
    if family == "all_to_all":
        return X.reshape(n, n, -1).transpose(1, 0, 2).reshape(n, -1)
    out = X.copy()
    for s, d in cs.perm_pairs:
        out[d] = X[s]
    return out


@pytest.fixture(scope="module")
def shard_map_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_families") / "jax_families.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr((TOPOS, FAMILIES, WIRES, SEEDS, FAMILY_SEED, SIZES))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(out), spec],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


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
    np.testing.assert_array_equal(ts.owner_of_block, js.owner_of_block)
    for th, jh in ((ts.rs, js.rs), (ts.ag, js.ag)):
        assert len(th) == len(jh)
        for tst, jst in zip(th, jh):
            _same_step(tst, jst)
    for tx, jx in ((ts.reorder, js.reorder), (ts.unorder, js.unorder)):
        assert (tx is None) == (jx is None)
        if tx is not None:
            _same_step(tx, jx)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(TOPOS))
def test_family_schedule_structure_matches_jax(name, family):
    js, ts = _schedules(name)[family]
    _same_schedule(ts, js)


@pytest.mark.parametrize("wire", [None] + WIRES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(TOPOS))
def test_family_matches_shard_map(name, family, wire, shard_map_results):
    _, ts = _schedules(name)[family]
    X = _inputs(name, family, ts.n)
    cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
    got = _run(cs, family, X)
    want = shard_map_results[f"{name}/{family}/{wire}"]
    if wire is None:
        if family == "reduce_scatter":
            assert _rel(got, want) <= 1e-6
        else:
            np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= PRECISIONS[wire].error_budget + 1e-6


@pytest.mark.parametrize("wire", [None] + WIRES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(TOPOS))
def test_family_matches_numpy(name, family, wire):
    _, ts = _schedules(name)[family]
    X = _inputs(name, family, ts.n)
    cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
    got = _run(cs, family, X)
    want = _exact(ts, family, X)
    if wire is not None:
        assert _rel(got, want) <= PRECISIONS[wire].error_budget
    elif family == "reduce_scatter":
        assert _rel(got, want) <= 1e-6
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_families_keep_bf16_buffers(family):
    _, ts = _schedules("two_level")[family]
    X = torch.from_numpy(_inputs("two_level", family, ts.n)).to(
        torch.bfloat16)
    for wire in (None, "fp8"):
        cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
        got = getattr(cs, ENTRY[family])(X)
        assert got.dtype == torch.bfloat16
        want = _exact(ts, family, X.float().numpy())
        budget = 2e-2 if wire is None else PRECISIONS[wire].error_budget
        assert _rel(got.float().numpy(), want) <= budget


def test_allreduce_schedule_answers_reduce_scatter_and_all_gather():
    """The AllReduce schedule itself runs both halves (the reference's
    contract), with the same canonical shards as the split plans."""
    trs, _ = _halves(tplans, tgentree, ttopo, T_TABLE5, "flat6")
    ar = tlower(tgentree(ttopo.single_switch(6), 1e6,
                         params=T_TABLE5).plan)
    X = _inputs("flat6", "reduce_scatter", 6)
    shards = _run(ar, "reduce_scatter", X)
    assert _rel(shards, _run(tlower(trs), "reduce_scatter", X)) <= 1e-6
    full = _run(ar, "allgather", shards)
    assert _rel(full, np.broadcast_to(
        _exact(ar, "reduce_scatter", X).reshape(-1), full.shape)) <= 1e-6


@pytest.mark.parametrize("family,entry", [
    ("p2p", "run_local_all_to_all"), ("all_to_all", "run_local_p2p"),
    ("allgather", "run_local_reduce_scatter"),
    ("reduce_scatter", "run_local_all_gather"),
    ("all_to_all", "run_local")])
def test_entry_points_check_the_family(family, entry):
    _, ts = _schedules("flat8")[family]
    with pytest.raises(LoweringError, match="only runs"):
        getattr(ts, entry)(torch.zeros(8, 64))


def test_entry_points_check_shapes():
    sc = _schedules("flat8")
    with pytest.raises(LoweringError):
        sc["all_to_all"][1].run_local_all_to_all(torch.zeros(8, 12))
    with pytest.raises(LoweringError):
        sc["p2p"][1].run_local_p2p(torch.zeros(4, 12))
    with pytest.raises(TypeError):
        sc["reduce_scatter"][1].run_local_reduce_scatter(
            torch.zeros(8, 12, dtype=torch.float64))


def _spy(monkeypatch):
    """Records (wrapper, batch shape) of every gathered launch."""
    calls = []
    for name in ("fused_reduce_into", "quant_reduce_into",
                 "dequantize_into"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            table = next(a for a in args if isinstance(a, ops.RowTable))
            calls.append((_name, tuple(table.rows.shape)))
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    return calls


def _steps(cs, family):
    if family == "reduce_scatter":
        return cs.rs + ([cs.reorder] if cs.reorder is not None else [])
    if family == "allgather":
        return ([cs.unorder] if cs.unorder is not None else []) + cs.ag
    return cs.ag


@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_landing_is_one_dequantize_launch(monkeypatch, family, wire):
    """On a scaled wire each landing phase (one operand a rank, no
    partial) is one gathered dequantize and each fold phase one gathered
    quant_reduce, batched over all ranks of the phase."""
    _, ts = _schedules("two_level")[family]
    calls = _spy(monkeypatch)
    _run(ts.with_wire(PRECISIONS[wire]), family,
         _inputs("two_level", family, ts.n))
    want = []
    for st in _steps(ts, family):
        for fd in st.folds:
            act = fd.blk >= 0
            landing = not fd.include_self[act].any() and bool(
                ((fd.ops[act] >= 0).sum(axis=1) == 1).all())
            want.append(("dequantize_into", (int(act.sum()), 1)) if landing
                        else ("quant_reduce_into",
                              (int(act.sum()), fd.ops.shape[1])))
    assert calls == want
    kinds = {k for k, _ in calls}
    assert kinds == ({"dequantize_into", "quant_reduce_into"}
                     if family == "reduce_scatter" else {"dequantize_into"})


def test_f32_and_bf16_wires_never_dequantize(monkeypatch):
    _, ts = _schedules("flat8")["allgather"]
    calls = _spy(monkeypatch)
    for wire in (None, "bf16"):
        cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
        _run(cs, "allgather", _inputs("flat8", "allgather", 8))
    assert calls and {k for k, _ in calls} == {"fused_reduce_into"}


@pytest.mark.parametrize("wire", [None, "bf16", "fp8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_guard_raises_when_a_kernel_fails(monkeypatch, family, wire):
    """A kernel that fails to launch surfaces through the guarded family
    entry point: recorded, raised, never demoted."""
    def fail(*args, **kw):
        raise RuntimeError("kernel launch failed with cudaError 98")

    for name in ("fused_reduce_into", "quant_reduce_into",
                 "dequantize_into"):
        monkeypatch.setattr(ops, name, fail)
    _, ts = _schedules("flat8")[family]
    g = guard_schedule(ts if wire is None
                       else ts.with_wire(PRECISIONS[wire]))
    X = torch.from_numpy(_inputs("flat8", family, 8))
    with pytest.raises(RuntimeError, match="cudaError 98"):
        getattr(g, ENTRY[family])(X)
    assert g.stats == {"launches": 1, "failures": 1}
    assert g.demotions == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_guard_runs_each_family(family):
    _, ts = _schedules("flat6")[family]
    g = guard_schedule(ts.with_wire(PRECISIONS["int8"]))
    X = _inputs("flat6", family, 6)
    got = getattr(g, ENTRY[family])(torch.from_numpy(X)).numpy()
    assert _rel(got, _exact(ts, family, X)) <= \
        PRECISIONS["int8"].error_budget
    assert g.stats == {"launches": 1, "failures": 0} and g.demotions == 0


# ---- the planner service ----------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES + ["allreduce"])
def test_get_family_executable_matches_reference(family):
    j, t = JService(), PlannerService()
    jr = j.get_family_executable(family, "x", 8, 1e6, params=J_TABLE5)
    tr = t.get_family_executable(family, "x", 8, 1e6, params=T_TABLE5)
    assert (tr.key, tr.algo, tr.plan.family) == (jr.key, jr.algo,
                                                 jr.plan.family)
    assert abs(tr.predicted_time - jr.predicted_time) \
        <= 1e-9 * jr.predicted_time
    _same_schedule(tr.schedule, jr.schedule)


def test_family_aliases_resolve():
    t = PlannerService(params=T_TABLE5)
    for alias, family in FAMILY_ALIASES.items():
        resp = t.get_family_executable(alias, "x", 4, 4096.0)
        assert resp.schedule.family == family
    with pytest.raises(ValueError, match="unknown collective family"):
        t.get_family_executable("gather", "x", 4, 4096.0)


def test_family_schedules_are_memoized_and_invalidated():
    t = PlannerService(params=T_TABLE5)
    a = t.get_family_executable("all_to_all", "x", 8, 1e6).schedule
    assert t.get_family_executable("all-to-all", "x", 8, 5e3).schedule is a
    assert t.get_family_executable("all_to_all", "x", 4, 1e6).schedule \
        is not a
    p = t.get_family_executable("p2p", "x", 8, 1e6).schedule
    rs = t.get_family_executable("reduce_scatter", "x", 8, 1e6).schedule
    assert t.get_family_executable("reduce-scatter", "x", 8,
                                   1e6).schedule is rs
    assert t.invalidate_executables() >= 4
    assert t.get_family_executable("all_to_all", "x", 8, 1e6).schedule \
        is not a
    assert t.get_family_executable("p2p", "x", 8, 1e6).schedule is not p
    assert t.get_family_executable("reduce_scatter", "x", 8,
                                   1e6).schedule is not rs


def test_uncalibrated_default_is_the_gpu_testbed():
    """Uncalibrated, an axis prices on the GPU testbed's rows, the leaf
    class on its NVLink ("middle_sw") row."""
    from repro_torch.core.cost_model import GPU_AXIS_BASIS, GPU_TESTBED
    assert GPU_AXIS_BASIS["root_sw"] == GPU_TESTBED["middle_sw"]
    assert {k: v for k, v in GPU_AXIS_BASIS.items() if k != "root_sw"} \
        == {k: v for k, v in GPU_TESTBED.items() if k != "root_sw"}
    t = PlannerService()
    a = t.get_family_executable("reduce_scatter", "x", 8, 1e6)
    b = PlannerService().get_family_executable("reduce_scatter", "x", 8,
                                               1e6, params=GPU_AXIS_BASIS)
    assert a.key == b.key and a.predicted_time == b.predicted_time


@pytest.mark.parametrize("family", ["reduce_scatter", "allgather",
                                    "all_to_all", "allreduce"])
def test_mark_degraded_matches_reference(family):
    """A degraded level changes the plan fingerprint (of the GenTree
    families) and the predicted time exactly as the reference's service
    does, drops the derived schedules, and a restore brings the healthy
    answer back."""
    j, t = JService(), PlannerService()
    healthy = t.get_family_executable(family, "x", 8, 1e6, params=T_TABLE5)
    j.get_family_executable(family, "x", 8, 1e6, params=J_TABLE5)
    assert t.mark_degraded("root_sw", 0.5) == j.mark_degraded("root_sw",
                                                                0.5)
    assert t.degraded() == j.degraded() == {"root_sw": 0.5}
    jr = j.get_family_executable(family, "x", 8, 1e6, params=J_TABLE5)
    tr = t.get_family_executable(family, "x", 8, 1e6, params=T_TABLE5)
    assert tr.key == jr.key
    if family != "all_to_all":        # its key names the structure only
        assert tr.key != healthy.key
    assert abs(tr.predicted_time - jr.predicted_time) \
        <= 1e-9 * jr.predicted_time
    assert tr.predicted_time > healthy.predicted_time
    t.clear_degraded()
    j.clear_degraded()
    assert t.degraded() == {} and t.stats()["degraded"] == {}
    back = t.get_family_executable(family, "x", 8, 1e6, params=T_TABLE5)
    assert back.key == healthy.key
    assert back.predicted_time == healthy.predicted_time


def test_mark_degraded_rejects_a_bad_factor():
    with pytest.raises(ValueError):
        PlannerService().mark_degraded("root_sw", 0.0)
