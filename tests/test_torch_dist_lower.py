"""The compiled schedules on a process mesh (one process a rank over
`torch.distributed`, gloo on the CPU) against the local mesh and the JAX
package's.

One fixture launches the ranks (`launch.mesh.launch`: 8 processes for
the 8-rank plans, then 6 for `flat6`, each with a deadline) and runs
every case of `tests/_dist_workers.py:lower_worker`: the GenTree
AllReduce of each topology of `test_torch_lower.py` (Table 5 params)
through `allreduce`, `reduce_scatter` and `all_gather`, and the flat
all-to-all and p2p plans through `all_to_all` and `p2p`, each in f32,
bf16, fp8 and int8 wires and in f32 and bf16 data, through the guard.
Beside it one subprocess runs the reference's `CompiledSchedule`
entry points under `shard_map` on a plain `jax.sharding.Mesh` (never
`jax.make_mesh`).

Tolerances: every rank's result equals `run_local`'s row bit for bit
(the same operands, the same order of adds); against the reference,
f32 within 1e-6 of the largest |value| and a wire within its
`Precision.error_budget` plus 1e-6 (the reference reduces in XLA's
order); the wrapper calls of each entry point equal `dist_launches`
exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.core.cost_model import PRECISIONS
from repro_torch.launch import mesh as M

ENTRIES = {"allreduce": ["allreduce", "reduce_scatter", "all_gather"],
           "all_to_all": ["all_to_all"], "p2p": ["p2p"]}
CASES = [(name, fam, entry) for name in W.TOPOS for fam in ENTRIES
         for entry in ENTRIES[fam]]
LOCAL = {"allreduce": "run_local",
         "reduce_scatter": "run_local_reduce_scatter",
         "all_gather": "run_local_all_gather",
         "all_to_all": "run_local_all_to_all", "p2p": "run_local_p2p"}
TIMEOUT_S = 240

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

TOPOS, inputs = eval(sys.argv[2]), dict(np.load(sys.argv[3]))
res = {}
for name, (builder, args) in TOPOS.items():
    topo = getattr(topology, builder)(*args)
    n = topo.num_servers()
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    scheds = {"allreduce": lower_plan(gentree(topo, 1e6,
                                              params=PAPER_TABLE5).plan),
              "all_to_all": lower_plan(plans.alltoall_plan(n, 1e6)),
              "p2p": lower_plan(plans.p2p_plan(n, 1e6))}
    for fam, cs in scheds.items():
        X = jnp.asarray(inputs[f"{name}/{fam}"])
        for wire in [None, "bf16", "fp8", "int8"]:
            s = cs if wire is None else cs.with_wire(PRECISIONS[wire])

            def run(f, v):
                return np.asarray(jax.jit(shard_map(
                    lambda a: f(a[0], "x")[None], mesh=mesh,
                    in_specs=P("x"), out_specs=P("x")))(v))
            if fam == "allreduce":
                res[f"{name}/allreduce/{wire}"] = run(s.allreduce, X)
                sh = run(s.reduce_scatter, X)
                res[f"{name}/reduce_scatter/{wire}"] = sh
                res[f"{name}/all_gather/{wire}"] = run(s.all_gather,
                                                       jnp.asarray(sh))
            else:
                res[f"{name}/{fam}/{wire}"] = run(getattr(s, fam), X)
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results by topology, the reference's results): the
    reference's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("dist_lower")
    inputs = {f"{name}/{fam}": W.lower_inputs(name, fam,
                                              W.schedules(name)[fam].n)
              for name in W.TOPOS for fam in ENTRIES}
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    ref = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp / "ref.npz"),
         repr(W.TOPOS), str(tmp / "inputs.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = {}
        for names, n in ((["flat8", "two_level"], 8), (["flat6"], 6)):
            ranks = M.launch(W.lower_worker, n, backend="gloo",
                             device="cpu", timeout_s=TIMEOUT_S, threads=1,
                             args=(names,))
            for name in names:
                got[name] = ranks
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    return got, dict(np.load(tmp / "ref.npz"))


def _local(name, fam, entry, wire, dtype):
    """run_local's rows of the case on the local mesh (the AllGather fed
    the local reduce-scatter's shards, as each rank feeds its own)."""
    cs = W.schedules(name)[fam]
    cs = cs.with_wire(None if wire is None else PRECISIONS[wire])
    X = torch.from_numpy(W.lower_inputs(name, fam, cs.n)).to(
        getattr(torch, dtype))
    if entry == "all_gather":
        X = cs.run_local_reduce_scatter(X)
    return getattr(cs, LOCAL[entry])(X)


@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("wire", W.WIRES, ids=lambda w: w or "f32")
@pytest.mark.parametrize("name,fam,entry", CASES)
def test_every_rank_equals_run_local(runs, name, fam, entry, wire, dtype):
    got, _ = runs
    want = _local(name, fam, entry, wire, dtype)
    for r, res in enumerate(got[name]):
        t = res[(name, fam, wire, dtype, entry)]
        assert t.dtype == want.dtype
        assert torch.equal(t.reshape(-1), want[r]), (name, entry, wire, r)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("wire", W.WIRES, ids=lambda w: w or "f32")
@pytest.mark.parametrize("name,fam,entry", CASES)
def test_matches_reference_shard_map(runs, name, fam, entry, wire):
    got, ref = runs
    rows = np.stack([res[(name, fam, wire, "float32", entry)].numpy()
                     for res in got[name]])
    want = ref[f"{name}/{entry}/{wire}"]
    budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget + 1e-6
    assert _rel(rows, want) <= budget


@pytest.mark.parametrize("wire", W.WIRES, ids=lambda w: w or "f32")
@pytest.mark.parametrize("name,fam", [(n, f) for n in W.TOPOS
                                      for f in ENTRIES])
def test_wrapper_calls_equal_dist_launches(runs, name, fam, wire):
    """Each rank calls each kernel wrapper once a fold phase it folds in
    (and `quantize` once a round it sends in, on a scaled wire), so the
    ranks together call the fold n times a phase where the local mesh
    launches once."""
    got, _ = runs
    cs = W.schedules(name)[fam]
    for entry in ENTRIES[fam]:
        total = 0
        for res in got[name]:
            calls, want = res[("launches", name, fam, wire, entry)]
            assert calls == want, (entry, calls, want)
            total += sum(calls.values())
        assert total > 0
        if wire is None and fam == "allreduce" and entry == "allreduce":
            phases = sum(len(st.folds) for st in cs.rs + cs.ag)
            active = sum(int((fd.blk >= 0).sum())
                         for st in cs.rs + cs.ag for fd in st.folds)
            assert total == active and phases <= total <= cs.n * phases


@pytest.mark.parametrize("name", list(W.TOPOS))
def test_guard_counts_process_mesh_calls(runs, name):
    got, _ = runs
    for res in got[name]:
        for fam in ENTRIES:
            for wire in W.WIRES:
                stats, demotions = res[("guard", name, fam, wire)]
                # each dtype's calls and the counted ones
                calls = (len(W.DTYPES) * len(ENTRIES[fam])
                         + len(ENTRIES[fam])
                         + (1 if fam == "allreduce" else 0))
                assert stats == {"launches": calls, "failures": 0}
                assert demotions == 0


@pytest.mark.parametrize("n", [8, 6])
def test_axis_of_another_size_raises(runs, n):
    got, _ = runs
    res = got["flat8" if n == 8 else "flat6"][0]
    assert res["wrong_axis"] is not None
    assert "mesh axis 'data' has" in res["wrong_axis"]


def test_importing_the_mesh_starts_no_process_group():
    import torch.distributed as dist

    import repro_torch.core.transport  # noqa: F401
    import repro_torch.launch.mesh  # noqa: F401
    assert not dist.is_initialized()


def test_mesh_helpers_match_the_reference_names():
    axes = M.make_host_mesh(4, 2)
    assert axes == (("data", 4), ("model", 2))
    assert M.dp_axes(axes) == ("data",)
    assert M.axis_sizes(axes) == {"data": 4, "model": 2}
    assert M.coords_of(5, [2, 4]) == (1, 1)
