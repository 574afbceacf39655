"""The flat collectives and the gradient sync on a process mesh (one
process a rank, gloo on the CPU) against the local mesh.

One fixture launches 8 processes, which run every case of
`tests/_dist_workers.py:collectives_worker` on the mesh ("data", 8) and
then on ("pod", 2) × ("data", 4) over the same processes, and then 6
processes for ("data", 6) (rhd on a non-power of two, hcps (2, 3) and
(3, 2)), each launch with a deadline: `allreduce`, `reduce_scatter` and
`all_gather` with ring, rhd, cps, hcps and psum on every axis, `psum`
over all axes at once, `all_to_all`, and `sync_gradients` with the plan
per leaf, bucketed (the default bucket, 4 KiB buckets, where the
planner picks the merged issuance on one axis, and a bf16 wire), the
planner's labels ("gentree"), ring, hcps and "auto" (psum), the axes
leaf-first. Every rank's result equals the local mesh's row bit for bit
(the same programs and the same order of adds), with one exception the
local mesh's own layout makes: its per-leaf "plan" AllReduce on several
axes runs the groups of the other axis side by side in one schedule
run, so an element's block, and its order of adds, depend on the
grouping; a process mesh runs each group alone, and is held against the
local mesh run a group at a time.
"""
import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.core import collectives as C
from repro_torch.core.sync import SyncConfig, resolve_axis_plans, sync_gradients
from repro_torch.core.transport import ProcessMesh
from repro_torch.launch import mesh as M

TIMEOUT_S = 240
ENTRIES = ["allreduce", "reduce_scatter", "all_gather"]
FLAT_CASES = [(key, ax, strat, fac)
              for key, axes in W.MESHES.items() for ax, n in axes
              for strat, fac in W.FLAT[n]]


@pytest.fixture(scope="module")
def ranks():
    """{mesh key: the ranks' results}."""
    out = {}
    for keys, n in ((["data8", "pod2xdata4"], 8), (["data6"], 6)):
        res = M.launch(W.collectives_worker, n, backend="gloo",
                       device="cpu", timeout_s=TIMEOUT_S, threads=1,
                       args=(keys,))
        for key in keys:
            out[key] = res
    return out


def _lead(key):
    return [s for _, s in W.MESHES[key]]


def _R(key):
    return int(np.prod(_lead(key)))


def _local_flat(key, ax, strat, fac, dtype, entry):
    mesh = list(W.MESHES[key])
    x = torch.from_numpy(W.flat_inputs(_R(key))).to(
        getattr(torch, dtype)).reshape(*_lead(key), -1)
    if entry == "allreduce":
        return C.allreduce(x, ax, strat, factors=fac, mesh=mesh)
    sh = C.reduce_scatter(x, ax, strat, factors=fac, mesh=mesh)
    if entry == "reduce_scatter":
        return sh
    return C.all_gather(sh, ax, strat, factors=fac, mesh=mesh)


def _assert_rows(key, results, want, what):
    want = want.reshape(_R(key), -1)
    for r, res in enumerate(results):
        got = res[what].reshape(-1)
        assert got.dtype == want.dtype
        assert torch.equal(got, want[r]), (what, r)


@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("key,ax,strat,fac", FLAT_CASES)
def test_flat_collective_equals_local_mesh(ranks, key, ax, strat, fac,
                                           entry, dtype):
    want = _local_flat(key, ax, strat, fac, dtype, entry)
    _assert_rows(key, ranks[key], want, (key, ax, strat, fac, dtype, entry))


@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("key", list(W.MESHES))
def test_psum_over_every_axis_equals_local_mesh(ranks, key, dtype):
    x = torch.from_numpy(W.flat_inputs(_R(key))).to(
        getattr(torch, dtype)).reshape(*_lead(key), -1)
    names = [a for a, _ in W.MESHES[key]]
    want = C.psum(x, names, mesh=list(W.MESHES[key]))
    _assert_rows(key, ranks[key], want, (key, "psum-all", dtype))


@pytest.mark.parametrize("dtype", W.DTYPES)
@pytest.mark.parametrize("key,ax", [(k, a) for k, axes in W.MESHES.items()
                                    for a, _ in axes])
def test_all_to_all_equals_local_mesh(ranks, key, ax, dtype):
    x = torch.from_numpy(W.flat_inputs(_R(key))).to(getattr(torch, dtype))
    x = x[:, :W.FLAT_SIZE - W.FLAT_SIZE % 24].reshape(*_lead(key), -1)
    want = C.all_to_all(x, ax, mesh=list(W.MESHES[key]))
    _assert_rows(key, ranks[key], want, (key, "all_to_all", ax, dtype))


def _per_group_plan_sync(grads, axes, cfg, mesh):
    """The local mesh's per-leaf "plan" sync run a group of the other
    axes at a time (each group's (n, L) rows alone through the axis's
    schedule), the layout of a process mesh."""
    lead = [s for _, s in mesh]
    names = [a for a, _ in mesh]
    R = int(np.prod(lead))
    plans = resolve_axis_plans(axes, cfg, float(sum(
        g.numel() // R for g in grads.values())))
    out = {}
    for k, g in grads.items():
        g = g.reshape(*lead, -1).clone()
        for pl in plans:
            d = names.index(pl.axis)
            Q = C.axis_rows(tuple(lead), (d,))
            flat = g.reshape(R, -1)
            for grp in range(Q.shape[1]):
                rows = torch.from_numpy(Q[:, grp].copy())
                flat[rows] = C.allreduce(flat[rows], pl.axis, "plan",
                                         schedule=pl.schedule)
            g = flat.reshape(*lead, -1)
        out[k] = g.reshape(grads[k].shape)
    return out


@pytest.mark.parametrize("label", list(W.SYNC))
@pytest.mark.parametrize("key", list(W.MESHES))
def test_sync_gradients_equals_local_mesh(ranks, key, label):
    lead = _lead(key)
    mesh = list(W.MESHES[key])
    grads = {f"g{j}": torch.from_numpy(a).reshape(*lead, *a.shape[1:])
             for j, a in enumerate(W.sync_inputs(_R(key)))}
    cfg = SyncConfig(**W.SYNC[label])
    axes = W.sync_axes(mesh)
    stats = {}
    if label == "plan-per-leaf" and len(mesh) > 1:
        want = _per_group_plan_sync(grads, axes, cfg, mesh)
        side = sync_gradients(grads, axes, cfg, mesh=mesh)
        for k in want:        # the side-by-side layout: rounding apart
            d = (want[k].double() - side[k].double()).abs().max()
            assert float(d) <= 1e-6 * float(want[k].abs().max())
    else:
        want = sync_gradients(grads, axes, cfg, stats=stats, mesh=mesh)
    for r, res in enumerate(ranks[key]):
        got, mode = res[(key, "sync", label)]
        assert mode == stats.get("overlap_mode")
        for k, w in want.items():
            assert torch.equal(got[k], w.reshape(_R(key), *got[k].shape)[r]
                               ), (k, r)


def test_merged_issuance_runs_on_one_axis(ranks):
    """The 4 KiB buckets on ("data", 8) take the planner's merged RS/AG
    issuance, which the process mesh runs as one exchange a step."""
    _, mode = ranks["data8"][0][("data8", "sync", "plan-4KiB-buckets")]
    assert mode == "merged"


def test_compress_over_a_process_mesh_raises():
    """Item 8a lifted the refusals of `compress` and `allreduce_planned`
    on a process mesh (tests/test_torch_dist_planned.py runs them over
    processes); what stays refused is `compress` in the ZeRO-3 trainer
    (item 9). On a one-rank axis, which moves nothing, both run without
    a process group and return the input."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_manual_train_step
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    one = ProcessMesh(axes=(("data", 1),), rank=0, coords=(0,),
                      backend="gloo", device=torch.device("cpu"))
    g = torch.arange(8.0)
    got = sync_gradients({"g": g}, [("data", 1)],
                         SyncConfig(strategy="cps", compress="int8"),
                         mesh=one)
    assert torch.equal(got["g"], g)
    st = {}
    assert torch.equal(C.allreduce_planned(g, "data", stats=st, mesh=one),
                       g)
    assert st == {"mode": "noop"}
    pm = ProcessMesh(axes=(("data", 4),), rank=0, coords=(0,),
                     backend="gloo", device=torch.device("cpu"))
    api = build(smoke_config(get_config("stablelm-12b")))
    with pytest.raises(NotImplementedError, match="item 9"):
        make_manual_train_step(api, pm, sync=SyncConfig(
            strategy="cps", compress="int8"), device="cpu")
