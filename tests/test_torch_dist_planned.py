"""The planned AllReduce, the int8 CPS AllReduce and the server's decode
self-check with one process a rank (a process mesh, gloo on the CPU)
against the local mesh.

One fixture launches 4 processes (`tests/_dist_workers.py:
planned_worker`, with a deadline), which run every case on ("data", 4)
and on ("pod", 2) × ("data", 2) over the same processes, then serve the
smoke stablelm-12b on ("model", 4):

- `allreduce_planned` on each axis through each route: the GenTree plan
  in f32, at the bf16 and fp8 wires and at the wire a tolerance prices,
  the bucket executor at a pinned 1 KiB bucket in f32 and at a bf16
  wire, and the flat-label fallback (a plan without block annotations):
  every rank takes the local mesh's branch, fills its `stats` and
  returns its row of the local mesh's result bit for bit. On (pod 2,
  data 2) the local mesh's plan and bucket routes run the groups of the
  other axis side by side in one schedule run, so an element's block
  and its order of adds depend on the grouping; a process mesh runs
  each group alone and is held against the local mesh run a group at a
  time (tests/test_torch_dist_collectives.py gives the same reason);
- `allreduce_int8_cps` and `sync_gradients(compress="int8")` with cps
  and hcps, the axes leaf-first: each rank's row bit for bit, one
  `fused_reduce` call a rank a call;
- the server: every rank's self-check under 1e-5 of the plain column
  sum, the time observed alike on every rank as host-staged, and rank
  0's tokens equal to the local-mesh server's (the other ranks return
  none).
"""
import warnings

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.core import collectives as C
from repro_torch.core.sync import (SyncConfig, allreduce_int8_cps,
                                   sync_gradients)
from repro_torch.launch import mesh as M

TIMEOUT_S = 240
AXES = [(key, ax) for key, axes in W.PLANNED_MESHES.items()
        for ax, _ in axes]


@pytest.fixture(scope="module")
def ranks():
    return M.launch(W.planned_worker, 4, backend="gloo", device="cpu",
                    timeout_s=TIMEOUT_S, threads=1,
                    args=(list(W.PLANNED_MESHES), True))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks' one torch thread, for the local mesh's runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lead(key):
    return [s for _, s in W.PLANNED_MESHES[key]]


def _group_rows(key, ax):
    """(n, G) rows of the local mesh: entry [i, g] is rank i on `ax` of
    group g of the other axes."""
    lead = _lead(key)
    names = [a for a, _ in W.PLANNED_MESHES[key]]
    return C.axis_rows(tuple(lead), (names.index(ax),))


def _local_planned(key, ax, route):
    """The local mesh's `allreduce_planned` a group at a time (each
    group's (n, L) rows alone, one axis): the (R, L) rows and each
    group's stats."""
    X = torch.from_numpy(W.planned_inputs(int(np.prod(_lead(key)))))
    Q = _group_rows(key, ax)
    out = torch.empty_like(X)
    stats = []
    for g in range(Q.shape[1]):
        rows = torch.from_numpy(Q[:, g].copy())
        svc = W.planned_service(route, Q.shape[0], W.PLANNED_SIZE)
        st = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the fallback's
            out[rows] = C.allreduce_planned(X[rows], ax, service=svc,
                                            stats=st,
                                            **W.planned_kwargs(route))
        stats.append(st)
    return out, stats


@pytest.mark.parametrize("route", list(W.PLANNED_ROUTES))
@pytest.mark.parametrize("key,ax", AXES)
def test_allreduce_planned_equals_local_mesh(ranks, key, ax, route):
    want, stats = _local_planned(key, ax, route)
    assert all(st == stats[0] for st in stats)
    mode = {"bucketed": "bucketed", "bucketed-bf16": "bucketed",
            "fallback": "flat-label"}.get(route, "plan")
    assert stats[0]["mode"] == mode
    for r, res in enumerate(ranks):
        got, st, _ = res[(key, "planned", ax, route)]
        assert st == stats[0], (r, st)
        assert got.dtype == want.dtype
        assert torch.equal(got, want[r]), (route, r)


@pytest.mark.parametrize("key,ax", AXES)
def test_planned_wires_take_their_precision(ranks, key, ax):
    """The routes bound to a wire run it; every rank's wrapper calls of
    the f32 plan are its schedule's `dist_launches` (fused_reduce only),
    of the fp8 wire quantize, quant_reduce and dequantize as well."""
    res = ranks[0]
    assert res[(key, "planned", ax, "bf16-wire")][1]["precision"] == "bf16"
    assert res[(key, "planned", ax, "fp8-wire")][1]["precision"] == "fp8"
    assert res[(key, "planned", ax, "bucketed-bf16")][1]["precision"] \
        == "bf16"
    n = dict(W.PLANNED_MESHES[key])[ax]
    sched = W.planned_service("plan", n, W.PLANNED_SIZE) \
        .get_axis_executable(ax, n, float(W.PLANNED_SIZE)).schedule
    names = [a for a, _ in W.PLANNED_MESHES[key]]
    for r, rk in enumerate(ranks):
        m = M.coords_of(r, _lead(key))[names.index(ax)]
        calls = rk[(key, "planned", ax, "plan")][2]
        assert calls["fused_reduce"] > 0
        assert calls["quantize"] == calls["dequantize"] == 0
        assert calls == {k: sched.dist_launches("allreduce", m).get(k, 0)
                         for k in calls}
        fp8 = rk[(key, "planned", ax, "fp8-wire")][2]
        assert fp8["quantize"] > 0 and fp8["quant_reduce"] > 0


@pytest.mark.parametrize("key,ax", AXES)
def test_int8_cps_equals_local_mesh(ranks, key, ax):
    R = int(np.prod(_lead(key)))
    x = torch.from_numpy(W.planned_inputs(R)).reshape(*_lead(key), -1)
    want = allreduce_int8_cps(x, ax, mesh=list(W.PLANNED_MESHES[key]))
    want = want.reshape(R, -1)
    exact = x.double().reshape(R, -1)
    for r, res in enumerate(ranks):
        got, calls = res[(key, "int8", ax)]
        assert torch.equal(got, want[r]), r
        assert calls["fused_reduce"] == 1           # one n-ary fold
    # and it is the sum within the int8 wire's rounding
    Q = _group_rows(key, ax)
    col = exact[torch.from_numpy(Q[:, 0].copy())].sum(0)
    got0 = ranks[int(Q[0, 0])][(key, "int8", ax)][0].double()
    assert float((got0 - col).abs().max() / col.abs().max()) < 0.05


@pytest.mark.parametrize("label", list(W.INT8_SYNC))
@pytest.mark.parametrize("key", list(W.PLANNED_MESHES))
def test_sync_gradients_int8_equals_local_mesh(ranks, key, label):
    lead = _lead(key)
    R = int(np.prod(lead))
    mesh = list(W.PLANNED_MESHES[key])
    grads = {f"g{j}": torch.from_numpy(a).reshape(*lead, *a.shape[1:])
             for j, a in enumerate(W.sync_inputs(R))}
    want = sync_gradients(grads, W.sync_axes(mesh),
                          SyncConfig(**W.INT8_SYNC[label]), mesh=mesh)
    for r, res in enumerate(ranks):
        got = res[(key, "sync-int8", label)]
        for k, w in want.items():
            assert torch.equal(got[k], w.reshape(R, *got[k].shape)[r]), \
                (k, r)


def test_server_self_check_on_every_rank(ranks):
    outs = [res["serve"] for res in ranks]
    assert all(o["err"] is not None and o["err"] < 1e-5 for o in outs)
    assert all(o["algo"] == outs[0]["algo"] for o in outs)
    # every rank observed the same (slowest rank's) time, host-staged
    assert len({o["observed"][0] for o in outs}) == 1
    assert "host_staged" in outs[0]["observed"][0]
    assert all(o["stats"]["failures"] == 0 for o in outs)
    assert all(o["tokens"] is None for o in outs[1:])


def test_server_rank_zero_serves_the_local_meshs_tokens(ranks):
    from repro_torch.launch.serve import ServeConfig, serve
    want = serve(ServeConfig(**W.SERVE, local_ranks=4), smoke=True,
                 on_log=lambda *_: None)
    got = ranks[0]["serve"]["tokens"]
    assert got.shape == want["tokens"].shape
    assert np.array_equal(got, want["tokens"])
