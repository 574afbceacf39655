"""The port's schedule compiler and local-mesh executor against the JAX
package's.

Plans come from each package's own GenTree on the same topology with the
same explicit params (the paper's Table 5 — the two packages' defaults
differ by design). The port's compiled schedule must have the reference's
structure, and `run_local` (kernel wrappers on the CPU, i.e. their plain
versions) must agree with the reference's `run_numpy` and with its
`CompiledSchedule.allreduce` run under `shard_map` on 8 forced host
devices and a plain `jax.sharding.Mesh` — one subprocess runs every
shard_map case.

Tolerances: f32 at 1e-6 relative to the largest |sum| (the same f32 adds,
possibly in another order); a compressed wire within its
`Precision.error_budget` plus 1e-6 of the reference's own wire result.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.core.gentree import gentree as jgentree
from repro.core.lower import lower_plan as jlower

from repro_torch.core import topology as ttopo
from repro_torch.core.cost_model import PAPER_TABLE5 as T_TABLE5, PRECISIONS
from repro_torch.core.gentree import gentree as tgentree
from repro_torch.core.lower import (GuardedSchedule, LoweringError,
                                    guard_schedule, lower_plan as tlower)
from repro_torch.kernels import ops

TOPOS = {  # name -> (builder args); flat n=8, the two-level tree, n=6
    "flat8": ("single_switch", (8,)),
    "two_level": ("symmetric_tree", (2, 4)),
    "flat6": ("single_switch", (6,)),
}
WIRES = ["bf16", "fp8", "int8"]
SIZE = 1000
SEEDS = {"flat8": 1, "two_level": 2, "flat6": 3}

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import topology
from repro.core.compat import shard_map
from repro.core.cost_model import PAPER_TABLE5, PRECISIONS
from repro.core.gentree import gentree
from repro.core.lower import lower_plan

TOPOS, WIRES, SIZE, SEEDS = eval(sys.argv[2])
res = {}
for name, (builder, args) in TOPOS.items():
    topo = getattr(topology, builder)(*args)
    n = topo.num_servers()
    cs = lower_plan(gentree(topo, 1e6, params=PAPER_TABLE5).plan)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    X = np.random.default_rng(SEEDS[name]).standard_normal(
        (n, SIZE)).astype(np.float32)
    for wire in [None] + WIRES:
        s = cs if wire is None else cs.with_wire(PRECISIONS[wire])
        f = jax.jit(shard_map(lambda v, s=s: s.allreduce(v[0], "x")[None],
                              mesh=mesh, in_specs=P("x"),
                              out_specs=P("x")))
        res[f"{name}/{wire}"] = np.asarray(f(jnp.asarray(X)))
np.savez(sys.argv[1], **res)
"""


def _plans(name):
    builder, args = TOPOS[name]
    jp = jgentree(getattr(jtopo, builder)(*args), 1e6, params=J_TABLE5)
    tp = tgentree(getattr(ttopo, builder)(*args), 1e6, params=T_TABLE5)
    return jlower(jp.plan), tlower(tp.plan)


def _inputs(name, n, size=SIZE, seed=None):
    rng = np.random.default_rng(SEEDS[name] if seed is None else seed)
    return rng.standard_normal((n, size)).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def shard_map_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_lower") / "jax_allreduce.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr((TOPOS, WIRES, SIZE, SEEDS))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(out), spec],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", list(TOPOS))
def test_schedule_structure_matches_jax(name):
    js, ts = _plans(name)
    assert ts.describe() == js.describe()
    assert (ts.n, ts.num_blocks, ts.blocks_per_shard, ts.placement,
            ts.family) == (js.n, js.num_blocks, js.blocks_per_shard,
                           js.placement, js.family)
    np.testing.assert_array_equal(ts.owner_of_block, js.owner_of_block)
    for th, jh in ((ts.rs, js.rs), (ts.ag, js.ag)):
        assert len(th) == len(jh)
        for tst, jst in zip(th, jh):
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
                np.testing.assert_array_equal(tf.include_self,
                                              jf.include_self)


@pytest.mark.parametrize("name", list(TOPOS))
@pytest.mark.parametrize("size", [1, 41, 1000, 4 * 64 + 3])
def test_run_local_matches_run_numpy(name, size):
    js, ts = _plans(name)
    X = _inputs(name, js.n, size, seed=size)
    want = js.run_numpy(X)
    got = ts.run_local(torch.from_numpy(X)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6
    assert _rel(got, np.broadcast_to(X.sum(0), X.shape)) <= 1e-6


@pytest.mark.parametrize("name", list(TOPOS))
def test_run_local_matches_shard_map(name, shard_map_results):
    _, ts = _plans(name)
    X = _inputs(name, ts.n)
    got = ts.run_local(torch.from_numpy(X)).numpy()
    assert _rel(got, shard_map_results[f"{name}/None"]) <= 1e-6


@pytest.mark.parametrize("name", list(TOPOS))
@pytest.mark.parametrize("wire", WIRES)
def test_wire_run_local_matches_shard_map(name, wire, shard_map_results):
    _, ts = _plans(name)
    prec = PRECISIONS[wire]
    X = _inputs(name, ts.n)
    got = ts.with_wire(prec).run_local(torch.from_numpy(X)).numpy()
    want = shard_map_results[f"{name}/{wire}"]
    assert _rel(got, want) <= prec.error_budget + 1e-6
    # and within budget of the exact sum
    assert _rel(got, np.broadcast_to(X.sum(0), X.shape)) \
        <= prec.error_budget


def test_with_wire_memoizes_variants():
    _, ts = _plans("flat8")
    v = ts.with_wire(PRECISIONS["fp8"])
    assert v is ts.with_wire(PRECISIONS["fp8"])
    assert v.with_wire(None) is not v and ts.with_wire(None) is ts
    assert "wire=fp8" in v.describe()


def test_run_local_bf16_buffer():
    _, ts = _plans("two_level")
    X = torch.from_numpy(_inputs("two_level", ts.n)).to(torch.bfloat16)
    got = ts.run_local(X)
    assert got.dtype == torch.bfloat16
    want = X.float().sum(dim=0)
    assert _rel(got.float().numpy(), np.broadcast_to(want.numpy(),
                                                     got.shape)) <= 2e-2


def test_run_local_rejects_wrong_rank_count():
    _, ts = _plans("flat8")
    with pytest.raises(LoweringError):
        ts.run_local(torch.zeros(4, 10))


def test_guard_runs_planned_rung_without_demotion():
    _, ts = _plans("flat6")
    g = guard_schedule(ts)
    assert g is guard_schedule(ts)
    X = _inputs("flat6", 6)
    out = g.run_local(torch.from_numpy(X))
    assert _rel(out.numpy(), np.broadcast_to(X.sum(0), X.shape)) <= 1e-6
    assert g.demotions == 0
    assert g.stats == {"launches": 1, "failures": 0}


def test_guard_failure_raises():
    """A failing planned schedule raises through the guard — no flat sum
    answers in its place — and the failure is counted."""
    class Broken:
        plan_name, n, wire = "broken", 4, None

        def run_local(self, X):
            raise RuntimeError("kernel launch failed")

    g = GuardedSchedule(Broken())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        g.run_local(torch.from_numpy(_inputs("flat8", 4)))
    assert g.stats == {"launches": 1, "failures": 1}
    assert g.demotions == 0


@pytest.mark.parametrize("wire", [None, "bf16", "fp8"])
def test_guard_raises_when_a_kernel_fails(monkeypatch, wire):
    """A fold kernel that fails to launch (as on a card whose build broke)
    surfaces through the guarded schedule: neither the full-precision
    schedule nor a flat sum takes its place."""
    def fail(*args, **kw):
        raise RuntimeError("fused kernel launch failed with cudaError 98")

    monkeypatch.setattr(ops, "fused_reduce_into", fail)
    monkeypatch.setattr(ops, "quant_reduce_into", fail)
    _, ts = _plans("two_level")
    cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
    g = guard_schedule(cs)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        g.run_local(torch.from_numpy(_inputs("two_level", 8)))
    assert g.stats["failures"] == 1 and g.demotions == 0


def _spy_folds(monkeypatch):
    """Records the batch shape (A, K) of every gathered fold launch (a
    landing phase on a scaled wire is a gathered dequantize)."""
    calls = []
    for name in ("fused_reduce_into", "quant_reduce_into",
                 "dequantize_into"):
        real = getattr(ops, name)

        def spy(*args, _real=real, **kw):
            table = next(a for a in args if isinstance(a, ops.RowTable))
            calls.append(tuple(table.rows.shape))
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_fold_phase_is_one_launch_per_fold(monkeypatch, wire):
    """Every fold phase of the schedule is exactly one gathered reduce
    (or, landing copies on a scaled wire, one gathered dequantize),
    batched over all folding ranks."""
    _, ts = _plans("two_level")
    cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
    calls = _spy_folds(monkeypatch)
    cs.run_local(torch.from_numpy(_inputs("two_level", 8)))
    folds = [fd for st in ts.rs + ts.ag for fd in st.folds]
    assert calls == [(int((fd.blk >= 0).sum()), fd.ops.shape[1])
                     for fd in folds]


def test_run_local_reads_no_unwritten_staging(monkeypatch):
    """Staging buffers start uninitialised: fill every new one with NaN
    and the result must still be exact — a masked fold operand or a
    padding row is never read."""
    real = torch.empty

    def nan_empty(*args, **kw):
        t = real(*args, **kw)
        if t.dtype.is_floating_point:
            t.fill_(float("nan"))
        elif t.dtype == torch.uint8:
            t.fill_(0x7F)                 # NaN bits in fp8-e4m3
        return t

    _, ts = _plans("flat6")
    X = _inputs("flat6", 6)
    monkeypatch.setattr(torch, "empty", nan_empty)
    for wire in (None, "bf16", "fp8", "int8"):
        cs = ts if wire is None else ts.with_wire(PRECISIONS[wire])
        got = cs.run_local(torch.from_numpy(X)).numpy()
        assert np.isfinite(got).all()
        budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget
        assert _rel(got, np.broadcast_to(X.sum(0), X.shape)) <= budget
