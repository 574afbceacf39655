"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode, on shared numpy
inputs made from a seed.

Tolerances: fused_reduce, grouped_reduce and quant_reduce at 1e-6
relative to the largest |sum| (f32 sums of the same operands, possibly in
another order within a group); quantize must produce the identical
payload bytes and scales within one f32 ulp; dequantize must match
exactly; quant_reduce_requant's scales within 1e-6 relative and its
decoded values within one quantisation step of their tile (a one-ulp
difference in the f32 sum can flip a rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import quant as jquant

from repro_torch.kernels import ops, ref

RTOL = 1e-6
WIRES = ["float8_e4m3fn", "int8"]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= rtol, err


def _bytes(q) -> np.ndarray:
    """Payload bytes of a torch or JAX wire array."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _within_ulp(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                         np.abs(b))))


@pytest.mark.parametrize("shape", [(2, 1000), (3, 128), (8, 4097),
                                   (9, 513)])
def test_fused_reduce_matches_jax(shape):
    x = _np(shape, 10)
    got = ops.fused_reduce(torch.from_numpy(x))
    want = jops.fused_reduce(jnp.asarray(x), impl="interpret")
    _close(got.numpy(), want)


def test_fused_reduce_batched_equals_per_batch():
    x = torch.from_numpy(_np((3, 4, 77), 11))
    got = ops.fused_reduce(x)
    for b in range(3):
        assert torch.equal(got[b], ops.fused_reduce(x[b]))


def test_fused_reduce_bf16_writes_input_dtype():
    x = torch.from_numpy(_np((5, 300), 12)).to(torch.bfloat16)
    got = ops.fused_reduce(x)
    assert got.dtype == torch.bfloat16
    want = x.float().sum(dim=0)
    assert torch.allclose(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("L", [1000, 128, 300])
def test_quantize_matches_jax(wire, L):
    x = _np((3, L), 20 + L, scale=4.0)
    q, s = ops.quantize(torch.from_numpy(x), wire)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    assert q.dtype == ref.wire_dtype(wire)
    np.testing.assert_array_equal(_bytes(q), _bytes(jq))
    _within_ulp(s.numpy(), js)


@pytest.mark.parametrize("wire", WIRES)
def test_quantize_ties_and_zero_tile(wire):
    """A tile whose amax is exactly qmax has scale 1, so the payload is
    the value itself: int8 must round half to even, fp8 to nearest even;
    an all-zero tile stores scale 0 and zero payload."""
    qmax = ref.WIRE_QMAX[wire]
    row = np.zeros(384, np.float32)
    row[:128] = np.resize(np.array([2.5, -3.5, 0.5, 1.5, -0.5, 6.5],
                                   np.float32), 128)
    row[0] = qmax
    row[256:] = np.linspace(-qmax, qmax, 128, dtype=np.float32)
    x = row[None]
    q, s = ops.quantize(torch.from_numpy(x), wire)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    np.testing.assert_array_equal(_bytes(q), _bytes(jq))
    _within_ulp(s.numpy(), js)
    assert s[0, 1] == 0.0 and not _bytes(q)[0, 128:256].any()
    if wire == "int8":
        assert q[0, 1:4].tolist() == [-4, 0, 2]


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("with_own", [False, True])
@pytest.mark.parametrize("K", [2, 5])
def test_quant_reduce_matches_jax(wire, with_own, K):
    L = 1000
    x = _np((K, L), 30 + K)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    q = torch.from_numpy(_bytes(jq).copy()).view(ref.wire_dtype(wire))
    s = torch.from_numpy(np.asarray(js).copy())
    own = _np((L,), 40) if with_own else None
    got = ops.quant_reduce(q, s, None if own is None
                           else torch.from_numpy(own), out_len=L)
    want = jops.quant_reduce(jq, js, None if own is None
                             else jnp.asarray(own), out_len=L,
                             impl="interpret")
    _close(got.numpy(), want)


@pytest.mark.parametrize("wire", WIRES)
def test_quant_reduce_masked_operand_nan_bits(wire):
    """A masked operand carries a zero scale; its payload bits must not
    reach the sum even when they spell NaN (0x7f in fp8-e4m3). The port
    agrees with JAX on the same operands with that payload zeroed, where
    JAX's own arithmetic (q·0) would turn NaN bits into NaN."""
    K, L = 3, 256
    x = _np((K, L), 50)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    qb = _bytes(jq).copy()
    sc = np.asarray(js).copy()
    sc[1] = 0.0
    clean = qb.copy()
    clean[1] = 0
    qb[1] = 0x7F
    own = _np((L,), 51)
    got = ops.quant_reduce(torch.from_numpy(qb).view(ref.wire_dtype(wire)),
                           torch.from_numpy(sc), torch.from_numpy(own))
    assert torch.isfinite(got).all()
    want = jops.quant_reduce(jnp.asarray(clean.view(np.asarray(jq).dtype)),
                             jnp.asarray(sc), jnp.asarray(own),
                             impl="interpret")
    _close(got.numpy(), want)


def _tables(B, K, R, seed, n_out):
    """Row tables of a gathered launch: operands drawn from R rows with
    one masked (−1) slot per batch row, distinct out rows, every other
    batch row folding its own partial."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, (B, K))
    rows[np.arange(B), rng.integers(0, K, B)] = -1
    out_rows = rng.permutation(n_out)[:B]
    own_rows = np.where(np.arange(B) % 2 == 0, out_rows, -1)
    return rows, out_rows, own_rows


@pytest.mark.parametrize("B,K", [(1, 2), (4, 3), (6, 9)])
def test_fused_reduce_into_matches_jax(B, K):
    """Each written row is JAX's fused_reduce of the live gathered rows
    (plus the partial); rows no table names keep NaN and never leak."""
    R, L, n_out = 12, 300, 8
    src = _np((R, L), 70 + K)
    rows, out_rows, own_rows = _tables(B, K, R - 1, 71 + K, n_out)
    src[R - 1] = np.nan                   # a row no table names
    out = _np((n_out, L), 72)
    got = torch.from_numpy(out.copy())
    ops.fused_reduce_into(torch.from_numpy(src),
                          ops.row_table(rows, out_rows, own_rows), got)
    want = out.copy()
    for b in range(B):
        parts = [src[r] for r in rows[b] if r >= 0]
        if own_rows[b] >= 0:
            parts.append(out[own_rows[b]])
        want[out_rows[b]] = np.asarray(jops.fused_reduce(
            jnp.asarray(np.stack(parts)), impl="interpret"))
    _close(got.numpy(), want)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_reduce_into_matches_jax(wire, dtype):
    """Each written row is JAX's quant_reduce of the live gathered wire
    rows plus the partial, cut to the out row's length; a row no table
    names holds NaN payload bits under a non-zero scale, and never leaks."""
    B, K, R, L, n_out = 5, 3, 10, 300, 6
    x = _np((R, L), 80)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    qb = _bytes(jq).copy()
    rows, out_rows, own_rows = _tables(B, K, R - 1, 81, n_out)
    qb[R - 1] = 0x7F                      # NaN bits in fp8-e4m3
    out = torch.from_numpy(_np((n_out, L), 82)).to(dtype)
    got = out.clone()
    ops.quant_reduce_into(torch.from_numpy(qb).view(ref.wire_dtype(wire)),
                          torch.from_numpy(np.asarray(js).copy()),
                          ops.row_table(rows, out_rows, own_rows), got)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = out.float().numpy()
    for b in range(B):
        live = np.array([r for r in rows[b] if r >= 0])
        own = (out[own_rows[b]].float().numpy() if own_rows[b] >= 0
               else np.zeros(L, np.float32))
        want[out_rows[b]] = np.asarray(jops.quant_reduce(
            jnp.asarray(np.asarray(jq)[live]), jnp.asarray(js)[live],
            jnp.asarray(own), out_len=L, impl="interpret"))
    want = torch.from_numpy(want).to(dtype).float().numpy()
    _close(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fan", [2, 3, 4, "x"])
@pytest.mark.parametrize("x", [2, 3, 7, 9, 16])
def test_grouped_reduce_matches_jax(x, fan, dtype):
    """The tree of fan_in-ary adds against the Pallas kernel on a ragged
    L (not a multiple of its 4096-lane tile or of a 16-byte vector);
    fan_in = x is one level, the fused reduce's own sum."""
    fan_in = x if fan == "x" else fan
    L = 4099
    parts = _np((x, L), 90 + x)
    t = torch.from_numpy(parts).to(dtype)
    got = ops.grouped_reduce(t, fan_in)
    assert got.dtype == dtype and got.shape == (L,)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jops.grouped_reduce(jnp.asarray(parts).astype(jdt), fan_in,
                               impl="interpret")
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if fan == "x":
        assert torch.equal(got, ops.fused_reduce(t))


def test_grouped_reduce_tree_order():
    """Level by level, left to right from 0: over [2^24, 1, 1, 1] fan_in
    2 adds (2^24 + 1) + (1 + 1) = 2^24 + 2, where one level (fan_in 4,
    the flat sum) loses each 1 against 2^24."""
    parts = torch.tensor([[2.0 ** 24], [1.0], [1.0], [1.0]])
    assert ops.grouped_reduce(parts, 2).item() == 2.0 ** 24 + 2
    assert ops.grouped_reduce(parts, 4).item() == 2.0 ** 24


@pytest.mark.parametrize("out_len", [None, 300, 129])
@pytest.mark.parametrize("wire", WIRES)
def test_dequantize_matches_jax(wire, out_len):
    """q·scale per tile, exactly the Pallas kernel's values, with a ragged
    out_len and an all-zero (zero-scale) tile."""
    x = _np((4, 384), 100, scale=3.0)
    x[1, 128:256] = 0.0
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    q = torch.from_numpy(_bytes(jq).copy()).view(ref.wire_dtype(wire))
    s = torch.from_numpy(np.asarray(js).copy())
    assert s[1, 1] == 0.0
    got = ops.dequantize(q, s, out_len=out_len)
    want = jops.dequantize(jq, js, out_len=out_len, impl="interpret")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wire", WIRES)
def test_dequantize_zero_scale_ignores_payload_bits(wire):
    """A zero-scale tile decodes to exactly 0 whatever its payload bits —
    NaN bits (0x7f in fp8-e4m3) included; the other tiles as JAX."""
    x = _np((2, 256), 101)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    qb = _bytes(jq).copy()
    sc = np.asarray(js).copy()
    qb[0, :128] = 0x7F
    sc[0, 0] = 0.0
    got = ops.dequantize(torch.from_numpy(qb).view(ref.wire_dtype(wire)),
                         torch.from_numpy(sc))
    assert not got[0, :128].any() and torch.isfinite(got).all()
    want = np.asarray(jops.dequantize(jq, js, impl="interpret"))
    np.testing.assert_array_equal(got.numpy()[:, 128:], want[:, 128:])
    np.testing.assert_array_equal(got.numpy()[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("wire", WIRES)
def test_dequantize_into_matches_jax(wire, dtype):
    """Each written row is JAX's dequantize of its staged row, cut to the
    out row's length; a −1 row writes zeros; a row no table names holds
    NaN payload bits and never leaks; the other out rows keep theirs."""
    R, L, n_out = 6, 300, 7
    x = _np((R, L), 102)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    qb = _bytes(jq).copy()
    qb[R - 1] = 0x7F
    rows, out_rows = [[3], [0], [-1], [4]], [6, 1, 2, 4]
    out = torch.from_numpy(_np((n_out, L), 103)).to(dtype)
    got = out.clone()
    ops.dequantize_into(torch.from_numpy(qb).view(ref.wire_dtype(wire)),
                        torch.from_numpy(np.asarray(js).copy()),
                        ops.row_table(rows, out_rows), got)
    want = out.clone()
    deq = torch.from_numpy(np.asarray(jops.dequantize(
        jq, js, out_len=L, impl="interpret")).copy())
    for (r,), o in zip(rows, out_rows):
        want[o] = (deq[r] if r >= 0 else torch.zeros(L)).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def _wire_step(scales: np.ndarray, wire: str) -> np.ndarray:
    """The largest quantisation step of each tile: the wire's spacing at
    its full scale (1 for int8, 32 for fp8-e4m3 at 448) times the scale."""
    return scales * (1.0 if wire == "int8" else 32.0)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("wire", WIRES)
def test_quant_reduce_requant_matches_jax(wire, K):
    L = 640
    x = _np((K, L), 110 + K, scale=2.0)
    jq, js = jops.quantize(jnp.asarray(x), wire, impl="interpret")
    q = torch.from_numpy(_bytes(jq).copy()).view(ref.wire_dtype(wire))
    s = torch.from_numpy(np.asarray(js).copy())
    gq, gs = ops.quant_reduce_requant(q, s)
    wq, ws = jquant.quant_reduce_requant(jq, js, wire, interpret=True)
    assert gq.dtype == ref.wire_dtype(wire) and gq.shape == (L,)
    ws = np.asarray(ws)
    assert np.all(np.abs(gs.numpy() - ws) <= 1e-6 * np.abs(ws))
    dec_got = ops.dequantize(gq[None], gs[None])[0].numpy()
    dec_want = np.asarray(jops.dequantize(wq[None], ws[None],
                                          impl="interpret"))[0]
    step = np.repeat(_wire_step(ws, wire), ref.QUANT_TILE)
    assert np.all(np.abs(dec_got - dec_want) <= step)


@pytest.mark.parametrize("out_wire", WIRES)
@pytest.mark.parametrize("wire", WIRES)
def test_quant_reduce_requant_is_quantize_of_quant_reduce(wire, out_wire):
    """Byte for byte the quantize encoding of quant_reduce's sum, into
    either wire, a zero-scale operand tile with NaN bits included."""
    K, L = 4, 512
    q, s = ops.quantize(torch.from_numpy(_np((K, L), 120, scale=5.0)), wire)
    q.view(torch.uint8)[2, 128:256] = 0x7F
    s[2, 1] = 0.0
    gq, gs = ops.quant_reduce_requant(q, s, out_wire)
    wq, ws = ops.quantize(ops.quant_reduce(q, s)[None], out_wire)
    assert gq.dtype == ref.wire_dtype(out_wire)
    assert torch.equal(gq.view(torch.uint8), wq[0].view(torch.uint8))
    assert torch.equal(gs, ws[0])


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    x = torch.from_numpy(_np((4, 256), 60))
    ops.fused_reduce(x)
    q, s = ops.quantize(x, "int8")
    ops.quant_reduce(q, s)
    table = ops.row_table([[0, 1]], [2], [2])
    ops.fused_reduce_into(x, table, x)
    ops.quant_reduce_into(q, s, table, x)
    r = torch.from_numpy(_np((1, 2, 3, 8), 61))
    ops.wkv(r, r, r, -r.exp(), torch.zeros(2, 8), torch.zeros(1, 2, 8, 8))
    u = torch.from_numpy(_np((1, 3, 6), 62))
    b = torch.from_numpy(_np((1, 3, 4), 63))
    ops.ssm_scan(u, u.exp(), b, b, -torch.ones(6, 4), torch.zeros(1, 6, 4))
    ops.grouped_reduce(x, 3)
    ops.dequantize(q, s)
    ops.dequantize_into(q, s, ops.row_table([[1]], [0]), x)
    ops.quant_reduce_requant(q, s)
    # every kernel of the port has a count, and the CPU path adds to none
    assert {"fused_reduce", "grouped_reduce", "quantize", "dequantize",
            "quant_reduce", "quant_reduce_requant", "wkv",
            "ssm_scan"} <= set(ops.LAUNCHES)
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("call", [
    lambda: ops.fused_reduce(torch.zeros(3, 8, dtype=torch.float16)),
    lambda: ops.fused_reduce(torch.zeros(8)),
    lambda: ops.quantize(torch.zeros(2, 8, dtype=torch.float64)),
    lambda: ops.quantize(torch.zeros(2, 8), "float16"),
    lambda: ops.quant_reduce(torch.zeros(2, 128), torch.zeros(2, 1)),
    lambda: ops.quant_reduce(torch.zeros(2, 128, dtype=torch.int8),
                             torch.zeros(2, 2)),
    lambda: ops.fused_reduce_into(torch.zeros(3, 8), ([[0, 1]], [0]),
                                  torch.zeros(3, 8)),
    lambda: ops.fused_reduce_into(torch.zeros(3, 8), ops.row_table(
        [[0, 1]], [0]), torch.zeros(3, 8, dtype=torch.bfloat16)),
    lambda: ops.fused_reduce_into(torch.zeros(3, 8), ops.row_table(
        [[0, 3]], [0]), torch.zeros(3, 8)),
    lambda: ops.fused_reduce_into(torch.zeros(3, 8), ops.row_table(
        [[0, 1]], [0], [3]), torch.zeros(3, 8)),
    lambda: ops.quant_reduce_into(torch.zeros(2, 128, dtype=torch.int8),
                                  torch.zeros(2, 1), ops.row_table(
        [[0, 1]], [0]), torch.zeros(3, 129)),
    lambda: ops.row_table([[0, 1], [1, 0]], [2, 2]),
    lambda: ops.row_table([[0, -2]], [0]),
    lambda: ops.row_table([0, 1], [0]),
    lambda: ops.grouped_reduce(torch.zeros(3, 8, dtype=torch.float16), 2),
    lambda: ops.grouped_reduce(torch.zeros(3, 8), 1),
    lambda: ops.grouped_reduce(torch.zeros(8), 2),
    lambda: ops.grouped_reduce(torch.zeros(129, 8), 2),
    lambda: ops.dequantize(torch.zeros(2, 128), torch.zeros(2, 1)),
    lambda: ops.dequantize(torch.zeros(2, 128, dtype=torch.int8),
                           torch.zeros(2, 2)),
    lambda: ops.dequantize(torch.zeros(2, 128, dtype=torch.int8),
                           torch.zeros(2, 1), out_len=129),
    lambda: ops.dequantize_into(torch.zeros(2, 128, dtype=torch.int8),
                                torch.zeros(2, 1), ops.row_table(
        [[0, 1]], [0]), torch.zeros(3, 128)),
    lambda: ops.dequantize_into(torch.zeros(2, 128, dtype=torch.int8),
                                torch.zeros(2, 1), ops.row_table(
        [[0]], [0], [0]), torch.zeros(3, 128)),
    lambda: ops.dequantize_into(torch.zeros(2, 128, dtype=torch.int8),
                                torch.zeros(2, 1), ops.row_table(
        [[0]], [0]), torch.zeros(3, 128, dtype=torch.int8)),
    lambda: ops.quant_reduce_requant(torch.zeros(2, 128, dtype=torch.int8),
                                     torch.zeros(2, 1), "float16"),
    lambda: ops.quant_reduce_requant(torch.zeros(2, 100, dtype=torch.int8),
                                     torch.zeros(2, 1)),
], ids=["fr-dtype", "fr-rank", "q-dtype", "q-wire", "qr-dtype",
        "qr-scales", "fri-table", "fri-out-dtype", "fri-src-range",
        "fri-own-range", "qri-out-len", "rt-dup-out", "rt-neg", "rt-rank",
        "gr-dtype", "gr-fan", "gr-rank", "gr-depth", "dq-dtype",
        "dq-scales", "dq-out-len", "dqi-fan", "dqi-own", "dqi-out-dtype",
        "rq-wire", "rq-tile"])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
