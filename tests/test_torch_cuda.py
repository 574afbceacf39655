"""The port's CUDA kernels and executor against their plain versions, on
the card.

Every test here needs a CUDA device and skips without one; on a machine
with a card run `PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
-q`. The file imports no JAX (the card's machine has none): the plain
versions it holds the kernels against are themselves held against the
JAX package by tests/test_torch_kernels.py on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import PAPER_TABLE5, PRECISIONS
from repro_torch.core.gentree import gentree
from repro_torch.core.lower import lower_plan
from repro_torch.core.topology import single_switch, symmetric_tree
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed, dev, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


# The kernels compute the plain versions' float operations in the same
# order, so they must agree exactly (tolerance 0).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1000), (3, 20480), (9, 1001),
                                   (4, 8, 4100), (8, 9, 1003)])
def test_fused_reduce_kernel_matches_plain(dev, dtype, shape):
    x = _rand(shape, 1, dev).to(dtype)
    before = ops.LAUNCHES["fused_reduce"]
    got = ops.fused_reduce(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] == before + 1
    want = ref.fused_reduce_ref(x)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("shape", [(1, 1000), (4, 20480), (3, 131),
                                   (2, 256)])
def test_quantize_kernel_matches_plain(dev, wire, shape):
    x = _rand(shape, 2, dev, scale=3.0)
    x[:, :128] = 0.0                        # an all-zero tile
    q, s = ops.quantize(x, wire)
    torch.cuda.synchronize()
    qr, sr = ref.quantize_ref(x, wire)
    assert torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
    assert torch.equal(s, sr)
    assert (s[:, 0] == 0).all()


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("with_own", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_quant_reduce_kernel_matches_plain(dev, wire, with_own, batch):
    K, L = 5, 1000
    lead = () if batch is None else (batch,)
    x = _rand(lead + (K, L), 3, dev)
    q, s = ops.quantize(x.reshape(-1, L), wire)
    q = q.reshape(lead + (K, -1))
    s = s.reshape(lead + (K, -1))
    # a masked operand: NaN payload bits under a zero scale
    q.view(torch.uint8)[..., 1, :] = 0x7F if wire != "int8" else 0x80
    s[..., 1, :] = 0.0
    own = _rand(lead + (L,), 4, dev) if with_own else None
    got = ops.quant_reduce(q, s, own, out_len=L)
    torch.cuda.synchronize()
    want = ref.quant_reduce_ref(q, s, own, out_len=L)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _tables(B, K, R, n_out, dev):
    """Gathered-launch row tables: operands from rows 0..R-1 with one
    masked (−1) slot per batch row, distinct out rows, every other batch
    row folding its own partial."""
    rng = np.random.default_rng(B * K)
    rows = rng.integers(0, R, (B, K))
    rows[np.arange(B), rng.integers(0, K, B)] = -1
    out_rows = rng.permutation(n_out)[:B]
    own_rows = np.where(np.arange(B) % 2 == 0, out_rows, -1)
    return ops.row_table(rows, out_rows, own_rows, dev)


@pytest.mark.parametrize("src_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,K,L", [(8, 7, 2560), (3, 2, 1003), (6, 9, 4096)])
def test_fused_reduce_into_kernel_matches_plain(dev, src_dtype, out_dtype,
                                                B, K, L):
    R, n_out = 20, 10
    src = _rand((R + 1, L), 6, dev).to(src_dtype)
    src[R] = float("nan")                   # a row no table names
    t = _tables(B, K, R, n_out, dev)
    out = _rand((n_out, L), 7, dev).to(out_dtype)
    got, want = out.clone(), out.clone()
    before = ops.LAUNCHES["fused_reduce"]
    ops.fused_reduce_into(src, t, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] == before + 1
    ref.fused_reduce_into_ref(src, t.rows, want, t.out_rows, t.own_rows)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,L", [(8, 7, 2560), (3, 2, 1003)])
def test_quant_reduce_into_kernel_matches_plain(dev, wire, dtype, B, K, L):
    R, n_out = 20, 10
    q, s = ops.quantize(_rand((R + 1, L), 8, dev), wire)
    q.view(torch.uint8)[R] = 0x7F           # NaN bits in a row no table names
    s[3, 0] = 0.0                           # a zero-scale tile
    t = _tables(B, K, R, n_out, dev)
    out = _rand((n_out, L), 9, dev).to(dtype)
    got, want = out.clone(), out.clone()
    before = ops.LAUNCHES["quant_reduce"]
    ops.quant_reduce_into(q, s, t, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quant_reduce"] == before + 1
    ref.quant_reduce_into_ref(q, s, t.rows, want, t.out_rows, t.own_rows)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("topo", ["flat8", "two_level", "flat6"])
@pytest.mark.parametrize("wire", [None, "bf16", "fp8", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_run_local_on_card(dev, topo, wire, dtype):
    t = {"flat8": single_switch(8), "two_level": symmetric_tree(2, 4),
         "flat6": single_switch(6)}[topo]
    cs = lower_plan(gentree(t, 1e6, params=PAPER_TABLE5).plan)
    if wire is not None:
        cs = cs.with_wire(PRECISIONS[wire])
    X = _rand((t.num_servers(), 4 * 5120 + 3), 5, dev)
    if dtype == "bf16":
        X = X.to(torch.bfloat16)
    want = X.double().sum(dim=0)
    got = cs.run_local(X)
    torch.cuda.synchronize()
    assert got.dtype == X.dtype
    err = float((got.double() - want).abs().max() / want.abs().max())
    budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget
    if dtype == "bf16":                     # the buffer itself rounds
        budget = max(budget, 2e-2)
    assert err <= budget
    # the same schedule on the CPU runs the plain versions: the same
    # float operations in the same order
    assert torch.equal(got.cpu(), cs.run_local(X.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x,fan_in", [(2, 2), (3, 2), (7, 3), (9, 2),
                                      (9, 4), (16, 16), (1, 2), (100, 2)])
@pytest.mark.parametrize("L", [20480, 1001])
def test_grouped_reduce_kernel_matches_plain(dev, dtype, x, fan_in, L):
    parts = _rand((x, L), 10 + x, dev).to(dtype)
    before = ops.LAUNCHES["grouped_reduce"]
    got = ops.grouped_reduce(parts, fan_in)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["grouped_reduce"] == before + 1
    want = ref.grouped_reduce_ref(parts, fan_in)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("shape,out_len", [((8, 20480), None),
                                           ((3, 1024), 1000),
                                           ((2, 256), 131)])
def test_dequantize_kernel_matches_plain(dev, wire, shape, out_len):
    q, s = ops.quantize(_rand(shape, 11, dev, scale=3.0), wire)
    q.view(torch.uint8)[0, :128] = 0x7F     # NaN bits under a zero scale
    s[0, 0] = 0.0
    before = ops.LAUNCHES["dequantize"]
    got = ops.dequantize(q, s, out_len=out_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequantize"] == before + 1
    want = ref.dequantize_ref(q, s, out_len=out_len)
    assert torch.isfinite(got).all() and not got[0, :128].any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(8, 2560), (3, 1003)])
def test_dequantize_into_kernel_matches_plain(dev, wire, dtype, B, L):
    R, n_out = 20, 10
    q, s = ops.quantize(_rand((R + 1, L), 12, dev), wire)
    q.view(torch.uint8)[R] = 0x7F           # NaN bits in a row no table names
    s[3, 0] = 0.0
    rng = np.random.default_rng(B)
    rows = rng.integers(0, R, (B, 1))
    rows[0, 0] = -1                         # a row that lands zeros
    t = ops.row_table(rows, rng.permutation(n_out)[:B], device=dev)
    out = _rand((n_out, L), 13, dev).to(dtype)
    got, want = out.clone(), out.clone()
    before = ops.LAUNCHES["dequantize"]
    ops.dequantize_into(q, s, t, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequantize"] == before + 1
    ref.dequantize_into_ref(q, s, t.rows, want, t.out_rows)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("K,L", [(1, 1024), (3, 20480), (8, 4096)])
def test_quant_reduce_requant_kernel_matches_plain(dev, wire, out_wire, K,
                                                   L):
    q, s = ops.quantize(_rand((K, L), 14, dev, scale=4.0), wire)
    q.view(torch.uint8)[0, 128:256] = 0x7F  # NaN bits under a zero scale
    s[0, 1] = 0.0
    before = ops.LAUNCHES["quant_reduce_requant"]
    gq, gs = ops.quant_reduce_requant(q, s, out_wire)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quant_reduce_requant"] == before + 1
    wq, ws = ref.quant_reduce_requant_ref(q, s, out_wire)
    assert torch.equal(gq.view(torch.uint8), wq.view(torch.uint8))
    assert torch.equal(gs, ws)
    # and byte for byte the quantize kernel applied to quant_reduce's sum
    kq, ks = ops.quantize(ops.quant_reduce(q, s)[None], out_wire)
    assert torch.equal(gq.view(torch.uint8), kq[0].view(torch.uint8))
    assert torch.equal(gs, ks[0])


@pytest.mark.parametrize("topo", ["flat8", "two_level", "flat6"])
@pytest.mark.parametrize("wire", [None, "bf16", "fp8", "int8"])
@pytest.mark.parametrize("family", ["reduce_scatter", "allgather",
                                    "all_to_all", "p2p"])
def test_families_on_card(dev, topo, wire, family):
    """Each family's schedule from the planner runs on the card exactly
    as the same code runs on the CPU (the kernels equal their plain
    versions), and a movement family on a scaled wire lands its copies
    through dequantize."""
    from repro_torch.planner.service import PlannerService
    n = {"flat8": 8, "two_level": 8, "flat6": 6}[topo]
    t = {"flat8": single_switch(8), "two_level": symmetric_tree(2, 4),
         "flat6": single_switch(6)}[topo]
    svc = PlannerService(params=PAPER_TABLE5)
    if family in ("reduce_scatter", "allgather"):
        from repro_torch.core.plans import family_halves
        rs, ag = family_halves(gentree(t, 1e6, params=PAPER_TABLE5).plan)
        cs = lower_plan(rs if family == "reduce_scatter" else ag)
    else:
        cs = svc.get_family_executable(family, "x", n, 1e6).schedule
    if wire is not None:
        cs = cs.with_wire(PRECISIONS[wire])
    size = {"reduce_scatter": 4 * 5120 + 3, "allgather": 4 * 5120,
            "all_to_all": 24 * 1000, "p2p": 4 * 5120}[family]
    X = _rand((n, size), 15, dev)
    entry = {"reduce_scatter": "run_local_reduce_scatter",
             "allgather": "run_local_all_gather",
             "all_to_all": "run_local_all_to_all",
             "p2p": "run_local_p2p"}[family]
    before = ops.LAUNCHES["dequantize"]
    got = getattr(cs, entry)(X)
    torch.cuda.synchronize()
    if wire in ("fp8", "int8") and family != "reduce_scatter":
        # every movement step lands its copies through dequantize
        assert ops.LAUNCHES["dequantize"] > before
    assert torch.equal(got.cpu(), getattr(cs, entry)(X.cpu()))


# The recurrence kernels reduce in another order than their plain
# versions: output and final state within 1e-5 of the largest |value|.
RECURRENCE_RTOL = 1e-5


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _wkv_args(B, H, T, K, V, seed, dev):
    return (_rand((B, H, T, K), seed, dev), _rand((B, H, T, K), seed + 1, dev),
            _rand((B, H, T, V), seed + 2, dev),
            -torch.exp(_rand((B, H, T, K), seed + 3, dev)),
            _rand((H, K), seed + 4, dev, 0.1),
            _rand((B, H, K, V), seed + 5, dev, 0.1))


def _ssm_args(B, T, Di, N, seed, dev):
    return (_rand((B, T, Di), seed, dev),
            torch.nn.functional.softplus(_rand((B, T, Di), seed + 1, dev)),
            _rand((B, T, N), seed + 2, dev), _rand((B, T, N), seed + 3, dev),
            -torch.exp(_rand((Di, N), seed + 4, dev, 0.5)),
            _rand((B, Di, N), seed + 5, dev, 0.1))


@pytest.mark.parametrize("kernel,shape", [
    ("wkv", (4, 32, 32, 64, 64)), ("wkv", (4, 32, 1, 64, 64)),
    ("wkv", (2, 3, 40, 16, 16)), ("wkv", (1, 2, 5, 33, 20)),
    ("ssm_scan", (4, 32, 3200, 16)), ("ssm_scan", (4, 1, 3200, 16)),
    ("ssm_scan", (2, 40, 200, 8)), ("ssm_scan", (1, 3, 130, 64))])
def test_recurrence_kernel_matches_plain(dev, kernel, shape):
    args = (_wkv_args if kernel == "wkv" else _ssm_args)(*shape, 11, dev)
    before = ops.LAUNCHES[kernel]
    out, state = getattr(ops, kernel)(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    want, s_want = getattr(ref, f"{kernel}_ref")(*args)
    assert out.shape == want.shape and state.shape == s_want.shape
    assert _rel(out, want) <= RECURRENCE_RTOL
    assert _rel(state, s_want) <= RECURRENCE_RTOL


@pytest.mark.parametrize("kernel", ["wkv", "ssm_scan"])
def test_recurrence_kernel_state_handoff(dev, kernel):
    """Two launches over the halves of the sequence, the state handed
    over, equal one launch over the whole."""
    if kernel == "wkv":
        *seq, fixed, s0 = _wkv_args(2, 4, 40, 64, 64, 12, dev)
        dim = 2
    else:
        *seq, fixed, s0 = _ssm_args(2, 40, 200, 16, 12, dev)
        dim = 1
    fn = getattr(ops, kernel)
    whole, s_whole = fn(*seq, fixed, s0)
    a, s1 = fn(*(x.narrow(dim, 0, 17).contiguous() for x in seq), fixed, s0)
    b, s2 = fn(*(x.narrow(dim, 17, 23).contiguous() for x in seq), fixed, s1)
    torch.cuda.synchronize()
    assert _rel(torch.cat([a, b], dim=dim), whole) <= RECURRENCE_RTOL
    assert _rel(s2, s_whole) <= RECURRENCE_RTOL


# The kernels' edges: batch 1 (a (b, h)'s columns, or a batch row's
# channels, over more blocks); T off the 16-token tile and the 8- and
# 4-token groups (1, 7, 33, 65); V off a warp's column slice (20 at K 64,
# 36 at K 16); K 33 and V 18 (off the 16-byte path); Di off the channel
# block (200; 130, off the 16-byte path); N 1 and 3 (one lane a channel),
# 8, 32 and 64 (sixteen lanes).
@pytest.mark.parametrize("kernel,shape", [
    ("wkv", (1, 32, 1, 64, 64)), ("wkv", (4, 32, 33, 64, 64)),
    ("wkv", (2, 32, 65, 64, 64)), ("wkv", (2, 3, 40, 64, 20)),
    ("wkv", (2, 3, 33, 16, 36)), ("wkv", (1, 2, 65, 33, 18)),
    ("wkv", (1, 2, 1, 33, 18)), ("wkv", (3, 5, 7, 32, 64)),
    ("ssm_scan", (1, 1, 3200, 16)), ("ssm_scan", (4, 33, 3200, 16)),
    ("ssm_scan", (2, 65, 3200, 16)), ("ssm_scan", (2, 40, 200, 1)),
    ("ssm_scan", (2, 33, 200, 3)), ("ssm_scan", (1, 65, 130, 64)),
    ("ssm_scan", (2, 7, 200, 32)), ("ssm_scan", (2, 1, 130, 8))])
def test_recurrence_kernel_edges(dev, kernel, shape):
    args = (_wkv_args if kernel == "wkv" else _ssm_args)(*shape, 13, dev)
    before = ops.LAUNCHES[kernel]
    out, state = getattr(ops, kernel)(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    want, s_want = getattr(ref, f"{kernel}_ref")(*args)
    assert _rel(out, want) <= RECURRENCE_RTOL
    assert _rel(state, s_want) <= RECURRENCE_RTOL


@pytest.mark.parametrize("kernel", ["wkv", "ssm_scan"])
def test_recurrence_kernel_off_16_byte_bases(dev, kernel):
    """Contiguous inputs that start 4 bytes past a 16-byte boundary (the
    kernels then copy element by element) give the plain result."""
    args = (_wkv_args(2, 4, 33, 64, 64, 14, dev) if kernel == "wkv"
            else _ssm_args(2, 33, 320, 16, 14, dev))

    def shifted(a):
        buf = torch.empty(a.numel() + 1, device=dev)[1:]
        return buf.copy_(a.reshape(-1)).view(a.shape)

    moved = [shifted(a) for a in args]
    assert all(a.data_ptr() % 16 == 4 and a.is_contiguous() for a in moved)
    out, state = getattr(ops, kernel)(*moved)
    torch.cuda.synchronize()
    want, s_want = getattr(ref, f"{kernel}_ref")(*args)
    assert _rel(out, want) <= RECURRENCE_RTOL
    assert _rel(state, s_want) <= RECURRENCE_RTOL


@pytest.mark.parametrize("T,split", [(40, 17), (33, 16), (20, 1)])
@pytest.mark.parametrize("kernel", ["wkv", "ssm_scan"])
def test_recurrence_kernel_handoff_off_the_tile(dev, kernel, T, split):
    """A sequence cut after a tile and one token, after a tile, after one
    token: two launches, the state handed over, equal one launch."""
    if kernel == "wkv":
        *seq, fixed, s0 = _wkv_args(4, 32, T, 64, 64, 15, dev)
        dim = 2
    else:
        *seq, fixed, s0 = _ssm_args(4, T, 3200, 16, 15, dev)
        dim = 1
    fn = getattr(ops, kernel)
    whole, s_whole = fn(*seq, fixed, s0)
    a, s1 = fn(*(x.narrow(dim, 0, split).contiguous() for x in seq), fixed,
               s0)
    b, s2 = fn(*(x.narrow(dim, split, T - split).contiguous() for x in seq),
               fixed, s1)
    torch.cuda.synchronize()
    assert _rel(torch.cat([a, b], dim=dim), whole) <= RECURRENCE_RTOL
    assert _rel(s2, s_whole) <= RECURRENCE_RTOL


# The model kernels also reduce in another order than their plain
# versions. An f32 output is held within 1e-5 of the largest |value|; a
# bf16 output is the f32 result rounded once, so it is held within 2^-8
# of the largest |value| of the plain version on the same inputs
# widened to f32.
MODEL_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("shape", [(4, 32, 5120), (4, 1, 1600), (3, 64),
                                   (5, 2, 4608)])
def test_rmsnorm_kernel_matches_plain(dev, shape, offset, x_dtype, w_dtype):
    x = _rand(shape, 13, dev, 3.0).to(x_dtype)
    w = _rand(shape[-1:], 14, dev, 0.5).to(w_dtype)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, w, offset=offset)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == x_dtype and got.shape == x.shape
    want = ref.rmsnorm(x.float(), w, offset=offset)
    assert _rel(got, want) <= MODEL_RTOL[x_dtype]


def test_rmsnorm_kernel_strided_rows(dev):
    x = _rand((2, 5, 3, 2048), 15, dev)
    w = _rand((2048,), 16, dev)
    for view in (x[:, -1:], x.transpose(1, 2), x[:, ::2, 1]):
        got = ops.rmsnorm(view, w, offset=1.0)
        torch.cuda.synchronize()
        assert _rel(got, ref.rmsnorm(view, w, offset=1.0)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,softcap,kv_len", [
    (4, 32, 8, 32, 32, 160, 0, 0.0, None),
    (4, 32, 8, 1, 128, 160, 0, 0.0, [33, 47, 60, 128]),
    (4, 25, 5, 32, 32, 64, 24, 0.0, None),
    (4, 25, 5, 1, 128, 64, 24, 0.0, [33, 47, 60, 128]),
    (2, 32, 16, 32, 128, 128, 40, 50.0, None),
    (2, 32, 16, 1, 128, 128, 4096, 50.0, [0, 77]),
    (2, 4, 4, 37, 50, 16, 0, 0.0, None),
    (1, 6, 2, 5, 300, 200, 100, 1.0, [150]),
    (2, 8, 2, 3, 200, 128, 50, 30.0, [180, 2]),
    (1, 32, 16, 1, 4416, 128, 4096, 50.0, [4360]),
    (1, 4, 2, 4, 4416, 16, 4096, 0.0, [4360]),
    (2, 4, 2, 1, 70, 18, 0, 0.0, [70, 9]),
    (1, 32, 8, 1, 4416, 160, 0, 0.0, [4360]),
    (4, 32, 16, 1, 4416, 128, 4096, 50.0, [4360, 0, 300, 4416]),
    (1, 32, 16, 4, 4416, 128, 4096, 50.0, [4360]),
    (1, 8, 2, 130, 130, 160, 0, 0.0, None),
    (2, 8, 2, 1, 300, 72, 0, 0.0, [300, 129])])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, Hq, Hkv, Tq, Tk,
                                              D, window, softcap, kv_len):
    q = _rand((B, Tq, Hq, D), 17, dev).to(dtype).transpose(1, 2)
    k = _rand((B, Hkv, Tk, D), 18, dev).to(dtype)
    v = _rand((B, Hkv, Tk, D), 19, dev).to(dtype)
    n = None if kv_len is None else torch.tensor(kv_len, device=dev)
    kw = dict(window=window, softcap=softcap, kv_len=n)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Tq, D)
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= MODEL_RTOL[dtype]
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


def _row_rel(got, want):
    """Largest |difference| over the largest |value| of its row (last
    dim), as chip_smoke.py holds attention."""
    diff = (got.double() - want.double()).abs()
    row = want.double().abs().amax(dim=-1, keepdim=True)
    return float((diff / (row + 1e-30)).max())


# bf16 prefill (Tq > 4) runs the tensor-core kernel: query counts that
# are and are not multiples of its 128-row tile, head dims on every
# template bound and between them (72: a multiple of 8, not of 16), GQA
# groups 1, 4 and 5, ragged key counts with a row that sees none,
# windows narrower than a key tile, softcap on and off, no causal mask,
# and K/V rows whose stride is no multiple of 16 bytes (element staging);
# groups 7 and 6 at head dim 128 (qwen2-vl-7b's 28/4, mixtral-8x22b's
# 48/8) and whisper-large-v3's non-causal encoder on 1,500 frames
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,softcap,kv_len,causal,pad", [
    (2, 4, 4, 5, 5, 64, 0, 0.0, None, True, 0),
    (2, 8, 2, 17, 40, 72, 0, 50.0, [40, 17], True, 0),
    (2, 10, 2, 33, 33, 80, 24, 0.0, None, True, 0),
    (1, 4, 1, 130, 300, 128, 0, 30.0, None, True, 0),
    (3, 4, 4, 40, 100, 160, 16, 0.0, [100, 0, 45], True, 0),
    (2, 4, 2, 70, 70, 256, 0, 50.0, None, True, 0),
    (1, 5, 5, 129, 129, 128, 0, 0.0, None, True, 0),
    (2, 32, 16, 64, 64, 128, 4096, 50.0, [64, 20], True, 0),
    (1, 25, 5, 33, 200, 64, 24, 0.0, [180], True, 0),
    (1, 4, 2, 20, 50, 64, 0, 0.0, None, False, 0),
    (2, 8, 2, 33, 60, 72, 8, 0.0, [60, 33], True, 4),
    (1, 4, 4, 9, 30, 18, 0, 0.0, None, True, 0),
    (2, 28, 4, 33, 60, 128, 0, 0.0, [60, 33], True, 0),
    (1, 28, 4, 130, 130, 128, 0, 0.0, None, True, 0),
    (2, 48, 8, 40, 40, 128, 16, 0.0, None, True, 0),
    (1, 48, 8, 70, 200, 128, 4096, 0.0, [200], False, 0),
    (1, 20, 20, 1500, 1500, 64, 0, 0.0, None, False, 0)])
def test_flash_attention_prefill_edges(dev, B, Hq, Hkv, Tq, Tk, D, window,
                                       softcap, kv_len, causal, pad):
    q = _rand((B, Tq, Hq, D), 21, dev).to(torch.bfloat16).transpose(1, 2)
    k = _rand((B, Hkv, Tk, D + pad), 22, dev).to(torch.bfloat16)[..., :D]
    v = _rand((B, Hkv, Tk, D + pad), 23, dev).to(torch.bfloat16)[..., :D]
    n = None if kv_len is None else torch.tensor(kv_len, device=dev)
    kw = dict(window=window, softcap=softcap, kv_len=n, causal=causal)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, Tq, D)
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, want) <= MODEL_RTOL[torch.bfloat16]
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


# f32 prefill (Tq > 4) runs the 3xTF32 tensor-core kernel: head dims 16,
# 72, 128, 160, 256 and 18 (no whole 16 bytes: element staging), groups
# 1 and 4, ragged key counts with a row that sees none, a window, no
# causal mask, and K/V rows strided by a multiple of 16 bytes and by
# none (element staging); within 1e-5 of each row's largest |value|
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,softcap,kv_len,causal,pad", [
    (2, 4, 4, 5, 5, 16, 0, 0.0, None, True, 0),
    (2, 8, 2, 17, 40, 72, 0, 50.0, [40, 17], True, 0),
    (3, 4, 1, 40, 100, 160, 16, 0.0, [100, 0, 45], True, 0),
    (2, 4, 4, 70, 70, 256, 0, 50.0, None, True, 0),
    (1, 4, 1, 130, 300, 128, 0, 30.0, None, True, 0),
    (1, 4, 2, 20, 50, 64, 0, 0.0, None, False, 0),
    (2, 8, 2, 33, 60, 72, 8, 0.0, [60, 33], True, 4),
    (2, 8, 2, 33, 60, 72, 8, 0.0, [60, 33], True, 1),
    (1, 4, 4, 9, 30, 18, 0, 0.0, None, True, 0)])
def test_flash_attention_f32_prefill_edges(dev, B, Hq, Hkv, Tq, Tk, D, window,
                                           softcap, kv_len, causal, pad):
    q = _rand((B, Tq, Hq, D), 31, dev).transpose(1, 2)
    k = _rand((B, Hkv, Tk, D + pad), 32, dev)[..., :D]
    v = _rand((B, Hkv, Tk, D + pad), 33, dev)[..., :D]
    n = None if kv_len is None else torch.tensor(kv_len, device=dev)
    kw = dict(window=window, softcap=softcap, kv_len=n, causal=causal)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Tq, D)
    want = ref.flash_attention(q, k, v, **kw)
    assert torch.isfinite(got).all()
    assert _row_rel(got, want) <= MODEL_RTOL[torch.float32]
    if kv_len is not None and 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


# rmsnorm: widths on the 16-byte vector path (1000, 4608) and off it
# (1001, 18), the long prefill's 4,352 rows, and last-token rows whose
# base is not 16-byte aligned (element path)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 1000), (2, 5, 1001), (4, 18),
                                   (1, 4352, 4608)])
def test_rmsnorm_kernel_widths(dev, dtype, shape):
    x = _rand(shape, 24, dev, 3.0).to(dtype)
    w = _rand(shape[-1:], 25, dev, 0.5).to(torch.bfloat16)
    got = ops.rmsnorm(x, w, offset=1.0)
    torch.cuda.synchronize()
    want = ref.rmsnorm(x.float(), w, offset=1.0)
    assert _rel(got, want) <= MODEL_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_misaligned_last_token_rows(dev, dtype):
    B, T, D = 4, 32, 5120
    flat = _rand((B * T * D + 1,), 26, dev, 3.0).to(dtype)
    x = flat[1:].view(B, T, D)[:, -1:]
    assert x.data_ptr() % 16
    w = _rand((D,), 27, dev, 0.5).to(dtype)
    got = ops.rmsnorm(x, w, offset=1.0)
    torch.cuda.synchronize()
    assert got.shape == (B, 1, D)
    assert _rel(got, ref.rmsnorm(x.float(), w, offset=1.0)) \
        <= MODEL_RTOL[dtype]


def test_wrappers_refuse_grad_on_card(dev):
    """A CUDA input that requires grad raises under grad mode and
    launches under inference mode."""
    x = _rand((2, 3, 64), 28, dev).requires_grad_()
    w = torch.ones(64, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rmsnorm(x, w)
    with torch.inference_mode():
        assert ops.rmsnorm(x, w).shape == x.shape


def test_bf16_reduce_scatter_past_2_31_buffer_elements(dev):
    """The trainer's bf16 reduce-scatter of one leaf whose working buffer
    holds more than 2^31 elements (8 ranks × 2^28 + 8, as stablelm-12b's
    embedding, 8 × 513,802,240, does): every rank's shard of the sum, the
    rows past 2^31 included, within one bf16 rounding (2^-8) of the
    largest |value| of torch.sum of the rows in f32, and one fused_reduce
    launch per fold phase."""
    from repro_torch.core.sync import SyncConfig, resolve_axis_plans
    from repro_torch.launch import train

    n, numel = 8, (1 << 28) + 8
    plans = resolve_axis_plans(
        [("data", n)], SyncConfig(strategy="plan", bucket_bytes=0),
        float(numel))
    g = torch.Generator(device=dev).manual_seed(30)
    X = torch.randn((n, numel), generator=g, device=dev).to(torch.bfloat16)
    assert X.numel() > 1 << 31
    before = ops.LAUNCHES["fused_reduce"]
    got = train._scatter_leaf(X, plans)
    torch.cuda.synchronize()
    cs = plans[0].schedule
    folds = sum(len(st.folds) for st in cs.rs
                + ([cs.reorder] if cs.reorder is not None else []))
    assert ops.LAUNCHES["fused_reduce"] == before + folds
    want = torch.sum(X.float(), dim=0).reshape(n, -1)
    del X
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max() <= 2.0 ** -8 * want.abs().max()


def test_smoke_trainer_on_card_matches_cpu(dev):
    """The ZeRO-3 trainer at smoke size in f32, 3 steps from one state:
    per-step loss and gnorm on the card (fused_reduce folds) within 1e-4
    of the same code on the CPU; the final shards within 1e-4 of each
    leaf's largest |value| but for at most 1e-4 of their elements, and
    those within 2·lr a step: AdamW's first update is about lr·sign(g),
    so an element whose gradient the two devices round to opposite signs
    moves up to 2·lr a step apart."""
    _smoke_trainer_card_vs_cpu(dev, None)


def test_bucketed_smoke_trainer_on_card_matches_cpu(dev):
    """The same on the bucketed path, bucket_bytes pinned to 32 KiB (10
    buckets a half at smoke size): each rank's gradients written into
    the bucket tensors, each reduce-scattered in place on the card."""
    from repro_torch.core.sync import SyncConfig
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=32768))


def test_two_level_smoke_trainer_on_card_matches_cpu(dev):
    """The same per leaf over the two-level (pod 2, data 4) local mesh:
    one plan a level, the "plan" schedules run a group of the other axis
    at a time on the card."""
    from repro_torch.core.sync import SyncConfig
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=0),
                               mesh=[("pod", 2), ("data", 4)])


def test_fp8_smoke_trainer_on_card_matches_cpu(dev):
    """The same per leaf with the fp8 wire: each rank forwards its own
    gathered copy; quantize, quant_reduce and dequantize on the card."""
    from repro_torch.core.sync import SyncConfig
    before = dict(ops.LAUNCHES)
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=0,
                                               precision="fp8"))
    for name in ("quantize", "quant_reduce", "dequantize"):
        assert ops.LAUNCHES[name] > before[name]


def _smoke_trainer_card_vs_cpu(dev, sync, mesh=8, arch="stablelm-12b",
                               seq_len=32, **cfg_kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig, adamw_init

    api = build(dataclasses.replace(smoke_config(get_config(arch)),
                                    **cfg_kw))
    shards = train.shard_params_zero3(api.init_params(
        torch.Generator().manual_seed(0), torch.float32, "cpu"), mesh)
    data = SyntheticLM(train.data_config(api.cfg, seq_len, 8))
    runs = {}
    for where in ("cpu", dev):
        params = [s.to(where, copy=True) for s in shards]
        state = {"params": params, "opt": adamw_init(params)}
        kw = {} if sync is None else {"sync": sync}
        step = train.make_manual_train_step(api, mesh, AdamWConfig(lr=1e-3),
                                            device=where,
                                            param_dtype=torch.float32, **kw)
        if sync is not None and sync.bucket_bytes != 0:
            assert len(step.scatter_buckets) >= 3
        metrics = []
        for s in range(3):
            state, m = step(state, train.batch_tensors(data.batch_at(s),
                                                       where))
            metrics.append([float(m["loss"]), float(m["gnorm"])])
        runs[str(where)] = (np.array(metrics),
                            [p.cpu() for p in state["params"]])
    (card, card_p), (cpu, cpu_p) = runs[str(dev)], runs["cpu"]
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    far = total = 0
    for a, b in zip(card_p, cpu_p, strict=True):
        d = (a - b).abs()
        far += int((d > 1e-4 * b.abs().max()).sum())
        total += d.numel()
        assert d.max() <= 2 * 1e-3 * 3
    assert far <= 1e-4 * total


@pytest.mark.parametrize("mesh", [8, [("pod", 2), ("data", 4)]],
                         ids=["one-axis", "two-level"])
def test_moe_smoke_trainer_on_card_matches_cpu(dev, mesh):
    """The same for deepseek-moe-16b's smoke model per leaf, its MoE
    layers expert-parallel over the first live axis ("data", or "pod" on
    the two-level mesh), the exchange the planned all-to-all."""
    from repro_torch.core.sync import SyncConfig
    before = ops.LAUNCHES["fused_reduce"]
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=0),
                               mesh=mesh, arch="deepseek-moe-16b")
    assert ops.LAUNCHES["fused_reduce"] > before


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_smoke_trainer_on_card_matches_cpu(dev, arch):
    """The same for the recurrent families' smoke models per leaf: their
    training recurrences are torch ops, on the card as on the CPU."""
    from repro_torch.core.sync import SyncConfig
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=0), arch=arch)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_training_launches_no_model_kernel(dev, arch):
    """A recurrent family's training step on the card launches fused_reduce
    (its gathers and reduce-scatters) and no wkv, ssm_scan, rmsnorm or
    flash_attention (no kernel has a backward); its prefill, on the same
    weights, still launches the recurrence kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig, adamw_init

    api = build(smoke_config(get_config(arch)))
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.float32, dev)
    shards = train.shard_params_zero3(params, 8)
    step = train.make_manual_train_step(
        api, 8, AdamWConfig(lr=1e-3), sync=SyncConfig(strategy="plan",
                                                      bucket_bytes=0),
        device=dev, param_dtype=torch.float32)
    batch = {k: torch.as_tensor(v, device=dev).long() for k, v in
             SyntheticLM(DataConfig(vocab=api.cfg.vocab, seq_len=32,
                                    global_batch=8, seed=0)
                         ).batch_at(0).items()}
    model = ("wkv", "ssm_scan", "rmsnorm", "flash_attention")
    before = dict(ops.LAUNCHES)
    _, m = step({"params": shards, "opt": adamw_init(shards)}, batch)
    assert np.isfinite(float(m["loss"]))
    assert ops.LAUNCHES["fused_reduce"] > before["fused_reduce"]
    assert all(ops.LAUNCHES[k] == before[k] for k in model)
    kernel = "wkv" if arch == "rwkv6-1.6b" else "ssm_scan"
    with torch.no_grad():
        api.prefill(params, {"tokens": batch["tokens"][:2]}, cache_len=32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before[kernel] + api.cfg.n_layers


# the last three configurations' smoke models: qwen2-vl at head dim 32,
# where M-RoPE's h and w sections turn; 48 tokens, past mixtral's smoke
# window of 32
FAMILY_TRAIN = {"qwen2-vl-7b": {"d_head": 32}, "whisper-large-v3": {},
                "mixtral-8x22b": {}}


@pytest.mark.parametrize("arch", list(FAMILY_TRAIN))
def test_family_smoke_trainer_on_card_matches_cpu(dev, arch):
    """The same for qwen2-vl-7b (its f32 stub embeddings and M-RoPE
    streams), whisper-large-v3 (its f32 stub frames through the
    non-causal encoder) and mixtral-8x22b (expert-parallel over the 8
    ranks) per leaf."""
    from repro_torch.core.sync import SyncConfig
    _smoke_trainer_card_vs_cpu(dev, SyncConfig(strategy="plan",
                                               bucket_bytes=0), arch=arch,
                               seq_len=48, **FAMILY_TRAIN[arch])


@pytest.mark.parametrize("arch", list(FAMILY_TRAIN))
def test_family_training_launches_no_model_kernel(dev, arch):
    """A training step of these families on the card launches fused_reduce
    alone (its gathers, reduce-scatters and mixtral's exchanges), no
    rmsnorm or flash_attention (no kernel has a backward); their prefill,
    on the same weights, still launches both."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig, adamw_init

    api = build(dataclasses.replace(smoke_config(get_config(arch)),
                                    **FAMILY_TRAIN[arch]))
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.float32, dev)
    shards = train.shard_params_zero3(params, 8)
    step = train.make_manual_train_step(
        api, 8, AdamWConfig(lr=1e-3), sync=SyncConfig(strategy="plan",
                                                      bucket_bytes=0),
        device=dev, param_dtype=torch.float32)
    batch = train.batch_tensors(SyntheticLM(train.data_config(
        api.cfg, 32, 8)).batch_at(0), dev)
    model = ("wkv", "ssm_scan", "rmsnorm", "flash_attention")
    before = dict(ops.LAUNCHES)
    _, m = step({"params": shards, "opt": adamw_init(shards)}, batch)
    assert np.isfinite(float(m["loss"]))
    assert ops.LAUNCHES["fused_reduce"] > before["fused_reduce"]
    assert all(ops.LAUNCHES[k] == before[k] for k in model)
    prompt = {k: (v[:, :2] if k == "mrope_positions" else v[:2])
              for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        api.prefill(params, prompt, cache_len=32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] > before["rmsnorm"]
    assert ops.LAUNCHES["flash_attention"] > before["flash_attention"]


@pytest.mark.parametrize("planned", [False, True], ids=["flat", "plan"])
@pytest.mark.parametrize("mesh", [[("data", 8)], [("pod", 2), ("data", 4)]],
                         ids=["one-axis", "two-level"])
def test_ep_exchange_on_card_equals_cpu(dev, mesh, planned):
    """`ep_exchange` forward and backward on the card equal the CPU's bit
    for bit (it moves data, adds nothing), in bf16; under a planned
    schedule each direction launches fused_reduce once a fold phase and
    group."""
    from repro_torch.core import sync
    from repro_torch.planner.service import PlannerService

    axis, n = mesh[0]
    lead = [s for _, s in mesh]
    kw = {"mesh": mesh} if len(mesh) > 1 else {}
    sched = (PlannerService().get_family_executable(
        "all_to_all", axis, n, 1e6).schedule if planned else None)
    x = _rand((*lead, 4096), 40, "cpu").to(torch.bfloat16)
    g = _rand((*lead, 4096), 41, "cpu").to(torch.bfloat16)
    out = {}
    for where in ("cpu", dev):
        xi = x.to(where).requires_grad_(True)
        before = ops.LAUNCHES["fused_reduce"]
        with sync.expert_parallel(axis, n, sched):
            y = sync.ep_exchange(xi, axis, **kw)
            (dx,) = torch.autograd.grad(y, xi, g.to(where))
        launched = ops.LAUNCHES["fused_reduce"] - before
        out[str(where)] = (y.detach().cpu(), dx.cpu(), launched)
    folds = 0 if sched is None else (8 // n) * sum(
        len(st.folds) for st in sched.ag)
    assert out["cpu"][2] == 0 and out[str(dev)][2] == 2 * folds
    assert torch.equal(out["cpu"][0], out[str(dev)][0])
    assert torch.equal(out["cpu"][1], out[str(dev)][1])


@pytest.mark.parametrize("wire", [None, "bf16", "fp8", "int8"])
@pytest.mark.parametrize("bucket_bytes", [None, 4096])
def test_sync_bucketed_on_card_equals_cpu(dev, wire, bucket_bytes):
    """`sync_bucketed` on the card gives the CPU's result exactly (rounds
    are copies; the folds, quantize and dequantize kernels compute their
    plain versions' operations in the same order), including the merged
    issuance the pinned bucket's plan picks."""
    from repro_torch.core.bucketing import sync_bucketed
    from repro_torch.core.sync import SyncConfig
    from repro_torch.planner.service import PlannerService

    shapes = [(13,), (3, 7), (0,), (5, 5, 5), (1000,), (64, 9), (2048,)]
    leaves = [_rand((8, *s), 40 + i, "cpu") for i, s in enumerate(shapes)]
    cfg = SyncConfig(strategy="plan", bucket_bytes=bucket_bytes,
                     precision=wire, params=PAPER_TABLE5)
    cpu = sync_bucketed(leaves, [("data", 8)], cfg, service=PlannerService())
    before = dict(ops.LAUNCHES)
    got = sync_bucketed([x.to(dev) for x in leaves], [("data", 8)], cfg,
                        service=PlannerService())
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) > sum(before.values())
    for g, c in zip(got, cpu, strict=True):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("wire", [None, "fp8"])
@pytest.mark.parametrize("bucket_bytes", [None, 1024])
def test_two_axis_sync_bucketed_on_card_equals_cpu(dev, wire, bucket_bytes):
    """The hierarchical bucket chain over (pod 2, data 4) on the card
    gives the CPU's bits: every axis schedule a group at a time, the
    folds and wire kernels computing their plain versions' operations."""
    from repro_torch.core.bucketing import sync_bucketed
    from repro_torch.core.sync import SyncConfig
    from repro_torch.planner.service import PlannerService

    shapes = [(13,), (3, 7), (0,), (5, 5, 5), (1000,), (64, 9), (2048,)]
    leaves = [_rand((2, 4, *s), 60 + i, "cpu") for i, s in enumerate(shapes)]
    axes, mesh = [("data", 4), ("pod", 2)], [("pod", 2), ("data", 4)]
    cfg = SyncConfig(strategy="plan", bucket_bytes=bucket_bytes,
                     precision=wire, params=PAPER_TABLE5)
    cpu = sync_bucketed(leaves, axes, cfg, service=PlannerService(),
                        mesh=mesh)
    before = dict(ops.LAUNCHES)
    got = sync_bucketed([x.to(dev) for x in leaves], axes, cfg,
                        service=PlannerService(), mesh=mesh)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) > sum(before.values())
    for g, c in zip(got, cpu, strict=True):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)


def test_overwriting_reduce_scatter_on_card(dev):
    """The in-place reduce-scatter of a bf16 bucket tensor on the card
    equals the one through a private copy, launch for launch."""
    cs = lower_plan(gentree(single_switch(8), 1e6, params=PAPER_TABLE5).plan)
    X = _rand((8, 8 * 4099), 41, dev).to(torch.bfloat16)
    want = cs.run_local_reduce_scatter(X)
    before = ops.LAUNCHES["fused_reduce"]
    got = cs.run_local_reduce_scatter(X.clone(), overwrite=True)
    torch.cuda.synchronize()
    folds = sum(len(st.folds) for st in cs.rs
                + ([cs.reorder] if cs.reorder is not None else []))
    assert ops.LAUNCHES["fused_reduce"] == before + folds
    assert torch.equal(got, want)


def test_torch_provider_launches_fused_reduce_as_counted(dev):
    """The card's calibration backend: a warm-up and 5 timed folds a
    fan-in (one `fused_reduce` launch each) and a warm-up and 3 timed CPS
    runs an (n, S), one fold kernel a fold phase; positive times."""
    from repro_torch.core.gentree import baseline_plan
    from repro_torch.planner.calibrate import (CalibrationConfig,
                                               TorchProvider)
    cfg = CalibrationConfig(backend="torch", ns=(2, 3, 8),
                            sizes=(1000.0, 1 << 16), fig4_xs=(2, 5, 9),
                            fig4_size=1 << 16)
    prov = TorchProvider()
    assert prov.device.type == "cuda"
    before = dict(ops.LAUNCHES)
    xs, f4 = prov.fig4_curve("server", PAPER_TABLE5["server"], cfg)
    assert ops.LAUNCHES["fused_reduce"] == before["fused_reduce"] + 6 * 3
    ns, sizes, times = prov.cps_curve("server", PAPER_TABLE5["server"], cfg)
    torch.cuda.synchronize()
    folds = {m: sum(len(st.folds) for st in cs.rs + cs.ag) for m in cfg.ns
             for cs in [lower_plan(baseline_plan("cps", single_switch(m),
                                                 1000.0))]}
    assert ops.LAUNCHES["fused_reduce"] == before["fused_reduce"] + 18 + sum(
        4 * folds[m] * len(cfg.sizes) for m in cfg.ns)
    assert {k: v for k, v in ops.LAUNCHES.items() if k != "fused_reduce"} \
        == {k: v for k, v in before.items() if k != "fused_reduce"}
    assert (f4 > 0).all() and (times > 0).all()
    assert len(times) == len(cfg.ns) * len(cfg.sizes)


def test_service_calibrated_on_card_runs_its_decode_plan(dev):
    """A service calibrated on the card (`backend="torch"`) prices with the
    fitted params, which pass `validate_params`, and its decode AllReduce
    lowers and runs within 1e-6 of the column sum."""
    from repro_torch.planner.calibrate import (CalibrationConfig,
                                               validate_params)
    from repro_torch.planner.service import PlannerService
    svc = PlannerService()
    res = svc.calibrate(cfg=CalibrationConfig(
        backend="torch", ns=(2, 4, 8), sizes=(1 << 16, 1 << 18),
        fig4_xs=(2, 4, 8), fig4_size=1 << 20, levels=("root_sw", "server")))
    assert res.backend == "torch" and svc.params == res.params
    for lvl, p in res.params.items():
        assert validate_params(p) == [], lvl
    resp = svc.get_axis_executable("model", 8, 4 * 5120.0)
    X = _rand((8, 4 * 5120), 42, dev)
    got = resp.schedule.run_local(X)
    want = X.double().sum(dim=0)
    torch.cuda.synchronize()
    assert float((got.double() - want).abs().max() / want.abs().max()) \
        <= 1e-6


# ---------------------------------------------------------------------------
# the flat collectives (core.collectives, core.sync) on the local mesh
# ---------------------------------------------------------------------------
FLAT = [("psum", None, 8), ("ring", None, 8), ("rhd", None, 8),
        ("cps", None, 8), ("hcps", (4, 2), 8), ("hcps", (2, 4), 8),
        ("hcps", (2, 2, 2), 8), ("rhd", None, 3), ("rhd", None, 5),
        ("rhd", None, 6), ("rhd", None, 7), ("ring", None, 5)]


def _flat_folds(strategy, factors, n, half):
    """The fused_reduce launches of one flat collective, from its
    structure: ring n − 1 folds, rhd log2 p (+1 at n ≠ p), cps 1, hcps one
    a stage, psum 1 (reduce-scatter 1); an all-gather none."""
    pow2 = 1 << (n.bit_length() - 1)
    rs = {"psum": 1, "ring": n - 1, "cps": 1,
          "rhd": pow2.bit_length() - 1 + (n != pow2),
          "hcps": len(factors or ())}[strategy]
    return {"reduce_scatter": rs, "all_gather": 0, "allreduce": rs}[half]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy,factors,n", FLAT,
                         ids=[f"{s}-{f}-{n}" for s, f, n in FLAT])
def test_flat_collective_on_card(dev, strategy, factors, n, dtype):
    """Each flat collective gives on the card the bits it gives on the CPU
    (the same fold order; the kernel equals its plain version), and
    launches exactly its folds: allreduce, reduce-scatter and all-gather,
    at a size the strategy must pad."""
    from repro_torch.core import collectives as C
    X = _rand((n, 4 * 1000 + 13), 50 + n, dev).to(dtype)
    before = ops.LAUNCHES["fused_reduce"]
    got = C.allreduce(X, "x", strategy, factors=factors)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] - before == _flat_folds(
        strategy, factors, n, "allreduce")
    assert torch.equal(got.cpu(), C.allreduce(X.cpu(), "x", strategy,
                                              factors=factors))
    if strategy == "rhd" and n & (n - 1):
        return               # its reduce-scatter shards over the core
    before = ops.LAUNCHES["fused_reduce"]
    rs = C.reduce_scatter(X, "x", strategy, factors=factors)
    ag = C.all_gather(rs, "x", strategy, factors=factors)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] - before == _flat_folds(
        strategy, factors, n, "reduce_scatter")
    want = C.reduce_scatter(X.cpu(), "x", strategy, factors=factors)
    assert torch.equal(rs.cpu(), want)
    assert torch.equal(ag.cpu(), C.all_gather(want, "x", strategy,
                                              factors=factors))


def test_int8_cps_topk_and_two_axis_sync_on_card(dev):
    """allreduce_int8_cps (one fused_reduce launch) and allreduce_topk give
    the CPU's bits on the card; sync_gradients over a (2, 4) mesh with
    hcps (2, 2) within 1e-6 of the column sum."""
    from repro_torch.core import sync as S
    g = _rand((8, 1000), 60, dev)
    before = ops.LAUNCHES["fused_reduce"]
    got = S.allreduce_int8_cps(g, "x")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] == before + 1
    assert torch.equal(got.cpu(), S.allreduce_int8_cps(g.cpu(), "x"))
    sparse = torch.zeros((8, 1000), device=dev)
    sparse[:, :5] = _rand((8, 5), 61, dev)
    got = S.allreduce_topk(sparse, "x")
    assert torch.equal(got.cpu(), S.allreduce_topk(sparse.cpu(), "x"))
    assert torch.equal(got[0].cpu(), ref.fused_reduce_ref(sparse.cpu()))
    z = _rand((2, 4, 24), 62, dev)
    out = S.sync_gradients({"g": z}, [("data", 4), ("pod", 2)],
                           S.SyncConfig(strategy="hcps", factors=(2, 2)),
                           mesh=[("pod", 2), ("data", 4)])["g"]
    want = z.double().sum(dim=(0, 1))
    assert float((out.double() - want).abs().max() / want.abs().max()) \
        <= 1e-6


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """bf16, f32 and int32 leaves on the card saved and restored in place,
    bit for bit; the host snapshot is taken before `save` returns, so a
    later in-place update does not reach the checkpoint."""
    from repro_torch.checkpoint import CheckpointManager, tree_flatten
    tree = {"p": [_rand((8, 1001), 1, dev).to(torch.bfloat16),
                  _rand((8, 64), 2, dev)],
            "opt": {"m": [_rand((8, 1001), 3, dev)],
                    "step": torch.tensor(5, dtype=torch.int32, device=dev)}}
    want = [x.clone() for x in tree_flatten(tree)[0]]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, tree)
    for x in tree_flatten(tree)[0]:
        x.add_(1)
    out, step = mgr.restore(tree)
    assert step == 5
    got = tree_flatten(out)[0]
    for g, w, l in zip(got, want, tree_flatten(tree)[0], strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))
        assert g is l


def test_smoke_trainer_survives_device_loss_on_card(dev, tmp_path):
    """The checkpointed smoke trainer (bf16, 8 ranks, 6 steps, a checkpoint
    every 2) under one injected device loss at step 5, which restores
    step 4 and replays: its final state equals the fault-free run's bit
    for bit, and each step's loss is the fault-free loss."""
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.launch import train
    from repro_torch.runtime.faults import (FaultEvent, FaultInjector,
                                            FaultPlan)

    def run(name, events):
        tc = train.TrainConfig(steps=6, seq_len=32, global_batch=8,
                               engine="manual", sync="plan", ckpt_every=2,
                               ckpt_dir=str(tmp_path / name),
                               log_every=1000)
        with FaultInjector(FaultPlan(seed=1, events=events)) as inj:
            out = train.run_training(tc, on_log=lambda *_: None)
        return out, inj.stats()["fired"]

    clean, _ = run("clean", ())
    chaos, fired = run("chaos", (FaultEvent("device_loss", 5),))
    assert fired == {"device_loss": 1}
    assert chaos["steps"] == [0, 1, 2, 3, 4, 4, 5]
    assert chaos["loop"].restarts == 1
    for g, w in zip(tree_flatten(chaos["state"])[0],
                    tree_flatten(clean["state"])[0], strict=True):
        assert g.is_cuda and torch.equal(_bits(g), _bits(w))
    losses = dict(zip(clean["steps"], clean["losses"]))
    assert [losses[s] for s in chaos["steps"]] == chaos["losses"]


# the served head dims the decode kernel had not run before: qwen3-32b's
# 80 (padded to its 128 template) and gemma3-4b's 256, with a window and
# without, ragged key counts with a row that sees none, f32 and bf16;
# then the GQA groups 7 (qwen2-vl-7b) and 6 (mixtral-8x22b, its window)
# at head dim 128, one query a head (7 and 6 rows a key head) and four
# (28 and 24 rows, past the 8 rows a block), and whisper-large-v3's
# group 1 at head dim 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,kv_len", [
    (4, 64, 8, 1, 128, 80, 0, [33, 47, 60, 128]),
    (2, 64, 8, 1, 300, 80, 24, [300, 0]),
    (4, 8, 4, 1, 128, 256, 1024, [33, 47, 60, 128]),
    (1, 8, 4, 1, 1168, 256, 1024, [1160]),
    (2, 8, 4, 4, 1168, 256, 0, [1160, 7]),
    (4, 28, 4, 1, 128, 128, 0, [33, 47, 60, 128]),
    (2, 28, 4, 4, 300, 128, 24, [300, 0]),
    (4, 48, 8, 1, 128, 128, 4096, [33, 47, 60, 128]),
    (2, 48, 8, 4, 4416, 128, 4096, [4360, 5]),
    (4, 20, 20, 1, 128, 64, 0, [33, 47, 60, 128])])
def test_flash_attention_decode_at_served_head_dims(dev, dtype, B, Hq, Hkv,
                                                    Tq, Tk, D, window,
                                                    kv_len):
    q = _rand((B, Tq, Hq, D), 41, dev).to(dtype).transpose(1, 2)
    k = _rand((B, Hkv, Tk, D), 42, dev).to(dtype)
    v = _rand((B, Hkv, Tk, D), 43, dev).to(dtype)
    kw = dict(window=window, kv_len=torch.tensor(kv_len, device=dev))
    before = dict(ops.ATTENTION_LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.ATTENTION_LAUNCHES["flash_decode_kernel"] == \
        before["flash_decode_kernel"] + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Tq, D)
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, want) <= MODEL_RTOL[dtype]
    if 0 in kv_len:
        assert (got[kv_len.index(0)] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,T", [(64, 32), (8, 32), (64, 1)])
def test_rmsnorm_kernel_qk_norm_rows(dev, dtype, H, T):
    """qwen3-32b's qk_norm rows as the layer passes them: the (B, H, T,
    80) head transpose of a (B, T, H·80) projection."""
    x = _rand((4, T, H, 80), 44, dev, 3.0).to(dtype).transpose(1, 2)
    w = _rand((80,), 45, dev, 0.5).to(torch.bfloat16)
    got = ops.rmsnorm(x, w, offset=1.0)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    assert _rel(got, ref.rmsnorm(x.float(), w, offset=1.0)) \
        <= MODEL_RTOL[dtype]


@pytest.mark.parametrize("arch,run", [("qwen3-32b", (2, 8, 16)),
                                      ("gemma3-4b", (2, 40, 48)),
                                      ("deepseek-moe-16b", (4, 64, 72))])
def test_smoke_model_on_card_matches_cpu(dev, arch, run):
    """The smoke-size model in f32 on the card (its kernels) against the
    same code on the CPU (their plain versions): prefill and 4 greedy
    decode steps, logits within 1e-4 of the largest |logit|, the same
    tokens. gemma3-4b's 40-token prompt passes its 32-key smoke window;
    deepseek-moe-16b's 256 tokens go through the grouped sorted
    dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    api = build(smoke_config(get_config(arch)))
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    B, T, cache_len = run
    tokens = torch.randint(0, api.cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(1))

    def to(tree, where):
        if isinstance(tree, dict):
            return {k: to(v, where) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, where) for v in tree]
        return tree.to(where)

    runs = {}
    for where in ("cpu", dev):
        p = to(params, where)
        before = ops.LAUNCHES["flash_attention"]
        with torch.inference_mode():
            logits, cache = api.prefill(p, {"tokens": tokens.to(where)},
                                        cache_len)
            outs, toks = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(dim=-1)
                toks.append(tok.cpu())
                logits, cache = api.decode_step(p, cache,
                                                {"tokens": tok[:, None]})
                outs.append(logits.cpu())
        launched = ops.LAUNCHES["flash_attention"] - before
        assert launched == (5 * api.cfg.n_layers if where == dev else 0)
        runs[str(where)] = (torch.stack(outs), torch.stack(toks))
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(dev)]
    assert torch.isfinite(lg).all()
    assert float((lg - lc).abs().max() / lc.abs().max()) <= 1e-4
    assert torch.equal(tc, tg)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b",
                                  "mixtral-8x22b"])
def test_smoke_family_on_card_matches_cpu(dev, arch):
    """The smoke-size whisper-large-v3 (12 seeded frames through the
    non-causal encoder), qwen2-vl-7b (head dim 32, where M-RoPE's h and w
    sections turn, three distinct position streams, embeddings in) and
    mixtral-8x22b (4 × 40 tokens, past its 32-key window, through the
    16-group dispatch) in f32 on the card against the same code on the
    CPU: prefill and 4 greedy decode steps, logits within 1e-4 of the
    largest |logit|, the same tokens, every attention on the card a
    kernel launch (whisper's prefill its encoder's layers too)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import step_batch
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    kw = {"d_head": 32} if arch == "qwen2-vl-7b" else {}
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **kw)
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    B, T, cache_len = (4, 40, 48) if arch == "mixtral-8x22b" else (2, 8, 16)
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "vlm":
        batch = {"embeds": torch.randn((B, T, cfg.d_model), generator=gen),
                 "mrope_positions": torch.randint(0, 2048, (3, B, T),
                                                  generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, T),
                                         generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, 12, cfg.d_model), generator=gen)

    def to(tree, where):
        if isinstance(tree, dict):
            return {k: to(v, where) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, where) for v in tree]
        return tree.to(where)

    runs = {}
    for where in ("cpu", dev):
        p = to(params, where)
        before = ops.LAUNCHES["flash_attention"]
        with torch.inference_mode():
            logits, cache = api.prefill(p, to(batch, where), cache_len)
            outs, toks = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(dim=-1)
                toks.append(tok.cpu())
                logits, cache = api.decode_step(p, cache,
                                                step_batch(cfg, p, tok))
                outs.append(logits.cpu())
        launched = ops.LAUNCHES["flash_attention"] - before
        assert launched == (5 * cfg.n_layers + cfg.n_encoder_layers
                            if where == dev else 0)
        runs[str(where)] = (torch.stack(outs), torch.stack(toks))
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(dev)]
    assert torch.isfinite(lg).all()
    assert float((lg - lc).abs().max() / lc.abs().max()) <= 1e-4
    assert torch.equal(tc, tg)
