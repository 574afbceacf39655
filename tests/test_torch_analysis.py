"""The port's step analysis (`repro_torch.launch.analysis`) against the
JAX package's `launch/hlo_analysis.py`, on the CPU.

- `mix_from_stats` on the reference's `analyze_hlo` of
  tests/test_hlo_analysis.py's MULTIFAM module, its fields copied into the
  port's `ModuleStats`: the reference's mix, exactly;
- `roofline_from_stats`: the reference's terms scaled by the ratio of the
  two constant sets (the H100's data sheet against TPU v5e), within 1e-12
  relative;
- the census of one collective call of each family (the lowered
  schedule's `run_local*` entry points directly, through the guard,
  through the flat collectives on one and two mesh axes, through
  `allreduce_planned`, `ep_exchange` and `allreduce_int8_cps`): one record
  of the right kind, per-rank payload, group size and wire bytes, exactly;
- each kernel wrapper's census on the CPU path: its shape count alone (the
  plain version's ops are not counted), the same on the meta device, and
  the kernel table's bound-column formulas, exactly;
- op counting: products at 2·M·N·K, views free, peak live bytes, and
  what a census costs nothing when none is open (`LAUNCHES` unchanged).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jha
from repro_torch.core import collectives, sync
from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.lower import guard_schedule
from repro_torch.kernels import ops
from repro_torch.launch import analysis as ha
from repro_torch.planner.service import PlannerService

from test_hlo_analysis import MULTIFAM

N = 8


def _rows(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _port_stats(js) -> ha.ModuleStats:
    return ha.ModuleStats(**dataclasses.asdict(js))


def test_constants_are_the_h100s():
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)


def test_mix_from_stats_matches_reference():
    js = jha.analyze_hlo(MULTIFAM)
    assert ha.mix_from_stats(_port_stats(js)) == jha.mix_from_stats(js)
    assert ha.mix_from_stats(_port_stats(js), dsize=2) == \
        jha.mix_from_stats(js, dsize=2)
    assert ha._KIND_TO_FAMILY == jha._KIND_TO_FAMILY


def test_roofline_terms_scale_with_the_constants():
    js = jha.analyze_hlo(MULTIFAM)
    js.flops, js.hbm_bytes = 3.1e15, 7.7e12
    want = jha.roofline_from_stats(js, 16, model_flops=2.2e16)
    got = ha.roofline_from_stats(_port_stats(js), 16, model_flops=2.2e16)
    scale = {"compute_s": jha.PEAK_FLOPS / ha.PEAK_FLOPS,
             "memory_s": jha.HBM_BW / ha.HBM_BW,
             "collective_s": jha.ICI_BW / ha.LINK_BW}
    for f, k in scale.items():
        assert getattr(got, f) == pytest.approx(getattr(want, f) * k,
                                                rel=1e-12, abs=0), f
    for f in ("flops", "hbm_bytes", "coll_bytes", "chips", "model_flops",
              "coll_by_kind", "useful_ratio"):
        assert getattr(got, f) == getattr(want, f), f
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    assert got.roofline_fraction == pytest.approx(
        2.2e16 / (16 * ha.PEAK_FLOPS) / got.bound, rel=1e-12)


# ---------------------------------------------------------------------------
# collectives: one record a call
# ---------------------------------------------------------------------------
def _wire(kind, n, m):
    return {"all-reduce": 2 * (n - 1) / n * m,
            "collective-permute": m}.get(kind, (n - 1) / n * m)


@pytest.fixture(scope="module")
def scheds():
    svc = PlannerService()
    out = {"allreduce": svc.get_axis_executable(
        "data", N, 4096.0, params=PAPER_TABLE5).schedule}
    for fam in ("reduce_scatter", "allgather", "all_to_all", "p2p"):
        out[fam] = svc.get_family_executable(fam, "data", N, 4096.0,
                                             params=PAPER_TABLE5).schedule
    out["two_level"] = svc.get_family_executable(
        "reduce_scatter", "data", 4, 4096.0, params=PAPER_TABLE5).schedule
    return out


def _padded(L, cs):
    return -(-L // cs.num_blocks) * cs.num_blocks


def _calls(s):
    """(name, call, kind, per-rank payload bytes, n) of each case."""
    X = _rows((N, 1000))
    Xb = _rows((N, 1000), dtype=torch.bfloat16)
    rs, ag = s["reduce_scatter"], s["allgather"]
    a2a, p2p = s["all_to_all"], s["p2p"]
    k = ag.blocks_per_shard
    S = _rows((N, 5 * k))
    A = _rows((N, 3 * a2a.num_blocks))
    rs2 = s["two_level"]
    X2 = _rows((2, 4, 1000))
    mesh2 = [("pod", 2), ("data", 4)]
    G = guard_schedule
    return [
        ("run_local", lambda: s["allreduce"].run_local(X), "all-reduce",
         4000, N),
        ("run_local bf16", lambda: s["allreduce"].run_local(Xb),
         "all-reduce", 2000, N),
        ("run_local_reduce_scatter", lambda: rs.run_local_reduce_scatter(X),
         "reduce-scatter", 4 * _padded(1000, rs), N),
        ("run_local_all_gather", lambda: ag.run_local_all_gather(S),
         "all-gather", 4 * N * 5 * k, N),
        ("run_local_all_to_all", lambda: a2a.run_local_all_to_all(A),
         "all-to-all", 4 * A.shape[1], N),
        ("run_local_p2p", lambda: p2p.run_local_p2p(X),
         "collective-permute", 4000, N),
        ("guard run_local", lambda: G(s["allreduce"]).run_local(X),
         "all-reduce", 4000, N),
        ("guard reduce_scatter", lambda: G(rs).run_local_reduce_scatter(X),
         "reduce-scatter", 4 * _padded(1000, rs), N),
        ("guard all_gather", lambda: G(ag).run_local_all_gather(S),
         "all-gather", 4 * N * 5 * k, N),
        ("guard all_to_all", lambda: G(a2a).run_local_all_to_all(A),
         "all-to-all", 4 * A.shape[1], N),
        ("guard p2p", lambda: G(p2p).run_local_p2p(X),
         "collective-permute", 4000, N),
        ("allreduce plan", lambda: collectives.allreduce(
            X, "data", "plan", schedule=s["allreduce"]), "all-reduce",
         4000, N),
        ("allreduce ring", lambda: collectives.allreduce(X, "data", "ring"),
         "all-reduce", 4000, N),
        ("allreduce psum", lambda: collectives.allreduce(X, "data"),
         "all-reduce", 4000, N),
        ("reduce_scatter psum", lambda: collectives.reduce_scatter(
            _rows((N, 1001)), "data"), "reduce-scatter", 4 * 1008, N),
        ("reduce_scatter plan", lambda: collectives.reduce_scatter(
            X, "data", "plan", schedule=G(rs)), "reduce-scatter",
         4 * _padded(1000, rs), N),
        ("reduce_scatter plan two-level", lambda: collectives.reduce_scatter(
            X2, "data", "plan", schedule=rs2, mesh=mesh2), "reduce-scatter",
         4 * _padded(1000, rs2), 4),
        ("all_gather psum", lambda: collectives.all_gather(
            _rows((N, 7)), "data"), "all-gather", 4 * N * 7, N),
        ("all_gather plan", lambda: collectives.all_gather(
            S, "data", "plan", schedule=ag), "all-gather", 4 * N * 5 * k, N),
        ("all_to_all flat", lambda: collectives.all_to_all(
            _rows((N, 64)), "data"), "all-to-all", 256, N),
        ("all_to_all plan", lambda: collectives.all_to_all(
            A, "data", schedule=G(a2a)), "all-to-all", 4 * A.shape[1], N),
        ("psum two axes", lambda: collectives.psum(
            X2, ["pod", "data"], mesh=mesh2), "all-reduce", 4000, N),
        ("allreduce_planned", lambda: collectives.allreduce_planned(
            X, "data"), "all-reduce", 4000, N),
        ("ep_exchange", lambda: sync.ep_exchange(_rows((N, 64)), "data"),
         "all-to-all", 256, N),
        ("allreduce_int8_cps", lambda: sync.allreduce_int8_cps(X, "data"),
         "all-reduce", 4000, N),
    ]


CALL_NAMES = [
    "run_local", "run_local bf16", "run_local_reduce_scatter",
    "run_local_all_gather", "run_local_all_to_all", "run_local_p2p",
    "guard run_local", "guard reduce_scatter", "guard all_gather",
    "guard all_to_all", "guard p2p", "allreduce plan", "allreduce ring",
    "allreduce psum", "reduce_scatter psum", "reduce_scatter plan",
    "reduce_scatter plan two-level", "all_gather psum", "all_gather plan",
    "all_to_all flat", "all_to_all plan", "psum two axes",
    "allreduce_planned", "ep_exchange", "allreduce_int8_cps"]


@pytest.mark.parametrize("name", CALL_NAMES)
def test_one_record_a_collective_call(scheds, name):
    (_, call, kind, payload, n), = [c for c in _calls(scheds)
                                    if c[0] == name]
    before = dict(ops.LAUNCHES)
    with ha.census(N) as c:
        call()
    assert c.records == [ha.CollRecord(kind, float(payload), n,
                                       _wire(kind, n, float(payload)))]
    st = c.stats()
    assert st.coll_counts == {kind: 1}
    assert st.coll_payload_by_kind == {kind: float(payload)}
    assert st.coll_by_kind == {kind: _wire(kind, n, float(payload))}
    # the executor's folds and copies count as the collective alone: its
    # operand and result bytes, no op and no kernel work
    io = (payload + payload / n if kind in ("reduce-scatter", "all-gather")
          else 2 * payload)
    assert (st.flops, st.hbm_bytes, c.kernels) == (0.0, io, {})
    assert ops.LAUNCHES == before


def test_call_names_cover_the_cases(scheds):
    assert [c[0] for c in _calls(scheds)] == CALL_NAMES


def test_no_census_costs_nothing(scheds):
    X = _rows((N, 1000))
    out = scheds["allreduce"].run_local(X)
    assert ha._ACTIVE is None
    with ha.census(N) as c:
        got = scheds["allreduce"].run_local(X)
        with pytest.raises(RuntimeError, match="already open"):
            with ha.census(N):
                pass
    assert ha._ACTIVE is None and torch.equal(got, out)
    assert len(c.records) == 1


def test_noted_collective_and_repeats():
    with ha.census(N) as c:
        ha.note_collective("all-reduce", 4, N)
        with ha.repeated(3):
            ha.note_collective("all-reduce", 4, N)
            torch.ones(4, 8) @ torch.ones(8, 2)
        ha.note_collective("all-reduce", 4, 1)         # a group of one
    assert c.stats().coll_counts == {"all-reduce": 4}
    assert c.total.flops == 3 * 2 * 4 * 8 * 2


# ---------------------------------------------------------------------------
# kernel wrappers: shape counts
# ---------------------------------------------------------------------------
def _table(B, K, R, n_out, seed=0, own=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, (B, K))
    rows[np.arange(B), rng.integers(0, K, B)] = -1
    out_rows = rng.permutation(n_out)[:B]
    own_rows = (np.where(np.arange(B) % 2 == 0, out_rows, -1) if own
                else None)
    return rows, out_rows, own_rows


def _wrapper_cases(dev):
    """(name, call, kernel, flops, bytes): the kernel table's bound
    column, restated from `chip_smoke.py`'s cases."""
    T = lambda *s, dt=torch.float32: _rows(s).to(dt).to(dev)  # noqa: E731
    tile = ops.QUANT_TILE
    parts = T(3, 4, 1000)
    g = T(5, 700, dt=torch.bfloat16)
    rows, out_rows, own_rows = _table(6, 3, 10, 8)
    tab = ops.row_table(rows, out_rows, own_rows, dev)
    src, out = T(10, 300), T(8, 300)
    x = T(4, 1000)
    q = torch.zeros((4, 1024), dtype=torch.float8_e4m3fn, device=dev)
    sc = T(4, 8)
    q3 = torch.zeros((2, 3, 1024), dtype=torch.int8, device=dev)
    sc3 = T(2, 3, 8)
    own = T(2, 900)
    lt = ops.row_table(np.arange(6)[:, None], np.arange(6), device=dev)
    q2, sc2, out6 = q.repeat(2, 1), sc.repeat(2, 1), T(6, 1000)
    qi, sci, outi = (torch.zeros((10, 384), dtype=torch.int8, device=dev),
                     T(10, 3), T(8, 300))
    qd, kv_len = T(2, 8, 1, 16), torch.tensor([5, 20], device=dev)
    B, H, Tt, K, V = 2, 3, 5, 8, 8
    wkv = [T(B, H, Tt, K), T(B, H, Tt, K), T(B, H, Tt, V), T(B, H, Tt, K),
           T(H, K), T(B, H, K, V)]
    Bs, Ts, Di, Ns = 2, 5, 12, 4
    ssm = [T(Bs, Ts, Di), T(Bs, Ts, Di), T(Bs, Ts, Ns), T(Bs, Ts, Ns),
           T(Di, Ns), T(Bs, Di, Ns)]
    xn, w = T(2, 7, 64, dt=torch.bfloat16), T(64)
    qa, ka = T(2, 8, 12, 16), T(2, 2, 20, 16)
    live, own_live = int((rows >= 0).sum()), int((own_rows >= 0).sum())
    return [
        ("fused_reduce", lambda: ops.fused_reduce(parts), "fused_reduce",
         0, (4 + 1) * 1000 * 3 * 4),
        ("grouped_reduce", lambda: ops.grouped_reduce(g, 2),
         "grouped_reduce", 0, 6 * 700 * 2),
        ("fused_reduce_into", lambda: ops.fused_reduce_into(src, tab, out),
         "fused_reduce", 0, live * 300 * 4 + (own_live + 6) * 300 * 4
         + 8 * 3 * 6 + 8 * 6 * 2),
        ("quantize", lambda: ops.quantize(x, "int8"), "quantize", 0,
         4 * (4 * 1000 + 8 * tile + 4 * 8)),
        ("dequantize", lambda: ops.dequantize(q, sc, out_len=1000),
         "dequantize", 0, 4 * (8 * tile + 4 * 8 + 4 * 1000)),
        ("dequantize_into", lambda: ops.dequantize_into(
            q2, sc2, lt, out6), "dequantize",
         0, 6 * (1000 + 4 * 8) + 6 * 1000 * 4 + 8 * (6 + 6)),
        ("quant_reduce", lambda: ops.quant_reduce(q3, sc3, own),
         "quant_reduce", 0, 2 * (3 * 1024 + 4 * 3 * 8 + 4 * 900 + 4 * 1024)),
        ("quant_reduce_into", lambda: ops.quant_reduce_into(
            qi, sci, tab, outi), "quant_reduce", 0,
         live * (384 + 4 * 3) + (own_live + 6) * 300 * 4 + 8 * 3 * 6
         + 8 * 6 * 2),
        ("quant_reduce_requant", lambda: ops.quant_reduce_requant(q, sc),
         "quant_reduce_requant", 0, 5 * (1024 + 4 * 8)),
        ("wkv", lambda: ops.wkv(*wkv), "wkv", B * H * Tt * K * (7 * V + 1),
         4 * (B * H * Tt * (3 * K + 2 * V) + H * K + 2 * B * H * K * V)),
        ("ssm_scan", lambda: ops.ssm_scan(*ssm), "ssm_scan",
         Bs * Ts * Di * (7 * Ns + 1),
         4 * (3 * Bs * Ts * Di + 2 * Bs * Ts * Ns + Di * Ns
              + 2 * Bs * Di * Ns)),
        ("rmsnorm", lambda: ops.rmsnorm(xn, w, offset=1.0), "rmsnorm",
         4 * xn.numel(), 2 * xn.numel() * 2 + 64 * 4),
        # causal, window 6: the 12 queries at positions 8..19 see 6 keys
        # each (72 pairs), key rows 3..19 (17)
        ("flash_attention", lambda: ops.flash_attention(
            qa, ka, ka, window=6), "flash_attention", 4 * 8 * 16 * 72 * 2,
         4 * (2 * 2 * 8 * 12 * 16 + 2 * 2 * 17 * 2 * 16)),
        ("flash_attention decode", lambda: ops.flash_attention(
            qd, ka, ka, kv_len=kv_len), "flash_attention",
         4 * 8 * 16 * 20 * 2, 4 * (2 * 2 * 8 * 16 + 2 * 2 * 20 * 2 * 16)
         + 16),
    ]


WRAPPERS = ["fused_reduce", "grouped_reduce", "fused_reduce_into",
            "quantize", "dequantize", "dequantize_into", "quant_reduce",
            "quant_reduce_into", "quant_reduce_requant", "wkv", "ssm_scan",
            "rmsnorm", "flash_attention", "flash_attention decode"]


def test_wrapper_names_cover_the_cases():
    assert [c[0] for c in _wrapper_cases("cpu")] == WRAPPERS


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_census_is_its_shape_count(name):
    got = {}
    for dev in ("cpu", "meta"):
        (_, call, kernel, flops, nbytes), = [
            c for c in _wrapper_cases(dev) if c[0] == name]
        with ha.census() as c:
            call()
        got[dev] = c
        assert c.kernel_work() == {kernel: (1, flops, nbytes)}, dev
        # the plain version's ops are not counted: the census is the
        # kernel's work alone
        assert (c.total.flops, c.total.hbm_bytes) == (flops, nbytes), dev
    assert got["cpu"].kernel_work() == got["meta"].kernel_work()


# ---------------------------------------------------------------------------
# op counting
# ---------------------------------------------------------------------------
def test_op_counting():
    a, b = _rows((6, 10)), _rows((10, 4))
    w = _rows((3, 10, 5))
    with ha.census(2) as c:
        y = a @ b                              # 2·6·10·4 FLOPs
        z = torch.bmm(a[None, :3].expand(3, 3, 10), w)    # 2·3·3·10·5
        v = y.t()[:2]                          # views: free
        y.add_(1.0)                            # in place: reads and writes
    assert c.total.flops == 2 * 6 * 10 * 4 + 2 * 3 * 3 * 10 * 5
    st = c.stats()
    assert st.flops == c.total.flops / 2 and st.coll_counts == {}
    assert c.total.hbm_bytes == 4 * (6 * 10 + 10 * 4 + 6 * 4      # mm
                                     + 3 * 3 * 10 + 3 * 10 * 5 + 3 * 3 * 5
                                     + 6 * 4)                    # add_
    assert c.peak_bytes == 4 * (6 * 4 + 3 * 3 * 5) and v.shape == (2, 6)
    del y, z, v
    assert c.live_bytes == 0


def test_peak_live_bytes_on_meta():
    with ha.census() as c:
        x = torch.empty((1 << 20,), device="meta")
        for _ in range(3):
            y = x * 2.0
            del y
        keep = x + 1.0
    assert c.peak_bytes == c.live_bytes == 2 * 4 * (1 << 20)
    del x
    assert c.live_bytes == 4 * (1 << 20) and keep.is_meta
