"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode, on shared numpy
inputs made from a seed.

Tolerances: fused_reduce and quant_reduce at 1e-6 relative (f32 sums of
the same operands, possibly in another order); quantize must produce the
identical payload bytes and scales within one f32 ulp.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops

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
    # every kernel of the port has a count, and the CPU path adds to none
    assert {"fused_reduce", "quantize", "quant_reduce", "wkv",
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
], ids=["fr-dtype", "fr-rank", "q-dtype", "q-wire", "qr-dtype",
        "qr-scales", "fri-table", "fri-out-dtype", "fri-src-range",
        "fri-own-range", "qri-out-len", "rt-dup-out", "rt-neg", "rt-rank"])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
