"""The recurrence kernels' layouts, and their new edge shapes, on the CPU.

- `ops.wkv_layout` and `ops.ssm_scan_layout`, the host's choice of how
  the `wkv` and `ssm_scan` kernels lay a call over the card: functions
  of the shapes alone (ints, the same on every call, no device read);
  lanes that cover a (b, h)'s K rows or a channel's N states 4 a lane,
  the fewest that do; blocks the kernels' own limits take; every
  column of every (b, h), and every channel of every batch row, held
  by exactly one thread group; at the served shapes (rwkv6-1.6b, B 4,
  H 32, K = V = 64; hymba-1.5b, B 4, Di 3200, N 16; prefill and decode
  alike) the card filled: wkv one wave of 8-warp blocks on 128 of the
  132 SMs, ssm_scan 400 blocks of 4 warps.
- The plain `wkv` and `ssm_scan` (what the wrappers run on CPU tensors)
  against the Pallas kernels in interpret mode, on shared numpy inputs
  made from a seed, at smoke widths of the kernels' edges: V off a
  warp's column slice, Di off a block's channels, N 1, 3 and 64, K 33,
  T 1, 33, 40 and 65, and the state handed over at a T that does not
  split into the kernels' 16-token tiles; output and final state within
  1e-5 of the largest |value|, as tests/test_torch_recurrence.py holds
  them.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jssm_scan
from repro.kernels.wkv import wkv as jwkv

from repro_torch.kernels import ops

KERNEL_RTOL = 1e-5

# (B, H, K, V) and (B, Di, N): the served shapes, batch 1 and a large
# batch, and widths on and off the kernels' slices
WKV_SHAPES = list(itertools.product((1, 4, 64), (1, 32), (4, 17, 33, 64),
                                    (1, 20, 36, 64)))
SSM_SHAPES = list(itertools.product((1, 4), (4, 200, 3200),
                                    (1, 3, 16, 33, 64)))


def _wkv_blocks(B, H, K, V):
    """The kernel's grid as its launcher derives it: (lanes, warps a
    block, blocks a (b, h), columns a warp)."""
    lanes, warps = ops.wkv_layout(B, H, K, V)
    cols = 128 // lanes
    return lanes, warps, -(-V // (warps * cols)), cols


def test_layouts_are_functions_of_the_shapes_alone():
    for B, H, K, V in WKV_SHAPES:
        got = ops.wkv_layout(B, H, K, V)
        assert all(type(x) is int for x in got)
        assert got == ops.wkv_layout(B, H, K, V)
    for B, Di, N in SSM_SHAPES:
        got = ops.ssm_scan_layout(B, Di, N)
        assert all(type(x) is int for x in got)
        assert got == ops.ssm_scan_layout(B, Di, N)


@pytest.mark.parametrize("B,H,K,V", WKV_SHAPES)
def test_wkv_layout_covers_every_column_once(B, H, K, V):
    lanes, warps, splits, cols = _wkv_blocks(B, H, K, V)
    # the fewest lanes (4, 8 or 16) whose 4 rows each cover K
    assert lanes in (4, 8, 16) and 4 * lanes >= K
    assert lanes == 4 or 2 * lanes < K
    # what the launcher takes: at most 8 warps, 64 columns a block
    assert 1 <= warps <= 8 and warps * cols <= 64
    # each column of a (b, h) on exactly one (block, warp, lane quad)
    held = [0] * V
    for sp, w, quad in itertools.product(range(splits), range(warps),
                                         range(32 // lanes)):
        first = (sp * warps + w) * cols + 4 * quad
        for c in range(first, min(first + 4, V)):
            held[c] += 1
    assert held == [1] * V
    # no block without a column
    assert (splits - 1) * warps * cols < V


@pytest.mark.parametrize("B,H,K,V", WKV_SHAPES)
def test_wkv_layout_fills_one_wave(B, H, K, V):
    """A (b, h)'s columns go to more blocks only while all of them still
    run at once, one an SM; never more blocks than its warps; and blocks
    of one warp fewer would not all fit."""
    lanes, warps, splits, cols = _wkv_blocks(B, H, K, V)
    need = -(-V // cols)                  # warps a (b, h)
    assert splits <= need
    assert splits == 1 or B * H * splits <= ops.DECODE_SMS
    assert warps == 1 or B * H * -(-need // (warps - 1)) > ops.DECODE_SMS


@pytest.mark.parametrize("B,Di,N", SSM_SHAPES)
def test_ssm_scan_layout_covers_every_channel_once(B, Di, N):
    lanes, channels = ops.ssm_scan_layout(B, Di, N)
    assert lanes in (1, 2, 4, 8, 16) and 4 * lanes >= N
    assert lanes == 1 or 2 * lanes < N
    # what the launcher takes: whole warps, at most 128 threads, and
    # 16-byte rows of u and dt
    threads = channels * lanes
    assert threads % 32 == 0 and threads <= 128 and channels % 4 == 0
    blocks = -(-Di // channels)
    held = [0] * Di
    for blk, ch in itertools.product(range(blocks), range(channels)):
        if blk * channels + ch < Di:
            held[blk * channels + ch] += 1
    assert held == [1] * Di


@pytest.mark.parametrize("B,Di,N", SSM_SHAPES)
def test_ssm_scan_layout_halves_blocks_only_to_fill_the_card(B, Di, N):
    lanes, channels = ops.ssm_scan_layout(B, Di, N)
    assert channels <= 128 // lanes
    if channels < 128 // lanes:       # halved: the wider block was short
        assert B * -(-Di // (2 * channels)) < 2 * ops.DECODE_SMS
    floor = max(8, 32 // lanes)
    assert channels == floor or \
        B * -(-Di // channels) >= 2 * ops.DECODE_SMS or \
        channels == 128 // lanes


@pytest.mark.parametrize("T", [1, 32])
def test_layouts_at_the_served_shapes(T):
    """rwkv6-1.6b's and hymba-1.5b's serve shapes (batch 4) take the
    same layout at prefill and decode: wkv one wave of 128 blocks of 8
    warps, a (b, h) a block; ssm_scan 400 blocks of 32 channels × 4
    lanes, three an SM."""
    assert _wkv_blocks(4, 32, 64, 64) == (16, 8, 1, 8)
    assert 4 * 32 * 1 <= ops.DECODE_SMS
    assert ops.ssm_scan_layout(4, 3200, 16) == (4, 32)
    assert 4 * -(-3200 // 32) == 400
    # batch 1 spreads a (b, h)'s columns, or a row's channels, wider
    assert _wkv_blocks(1, 32, 64, 64) == (16, 2, 4, 8)
    assert ops.ssm_scan_layout(1, 3200, 16) == (4, 8)


# ---------------------------------------------------------------------------
# the plain recurrences against the Pallas kernels at the kernels' edges
# ---------------------------------------------------------------------------
def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _wkv_inputs(B, H, T, K, V, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(r=f(B, H, T, K), k=f(B, H, T, K), v=f(B, H, T, V),
                logw=-np.exp(f(B, H, T, K)), u=f(H, K) * 0.1,
                s0=f(B, H, K, V) * 0.1)


def _ssm_inputs(B, T, Di, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(B, T, Di), dt=np.log1p(np.exp(f(B, T, Di))),
                b=f(B, T, N), c=f(B, T, N), log_a=-np.exp(f(Di, N) * 0.5),
                s0=f(B, Di, N) * 0.1)


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


# (B, H, T, K, V): T 1; V 20 off the 8-column slice of a warp at K 64;
# V 36 off the 32-column slice at K 16; K 33 (3 lanes of 16 unused rows)
# with V 18 at T 65; T 33 and 40 off the 16-token tile
WKV_EDGES = [(1, 2, 1, 64, 20), (1, 2, 33, 64, 20), (1, 2, 40, 16, 36),
             (1, 1, 65, 33, 18), (2, 1, 33, 8, 12)]
# (B, T, Di, N): T 1; Di 200 off the 32-channel block; N 1 and 3 (one
# lane); N 64 (16 lanes) at Di 130 and T 65
SSM_EDGES = [(1, 1, 200, 16), (2, 33, 200, 16), (1, 40, 130, 1),
             (1, 33, 200, 3), (1, 65, 130, 64)]


@pytest.mark.parametrize("B,H,T,K,V", WKV_EDGES)
def test_wkv_plain_matches_pallas_at_the_edges(B, H, T, K, V):
    x = _wkv_inputs(B, H, T, K, V, seed=T + K + V)
    want, s_want = jwkv(**_jax(x), chunk=32, interpret=True)
    got, s_got = ops.wkv(**_torch(x))
    assert _rel(got.numpy(), want) <= KERNEL_RTOL
    assert _rel(s_got.numpy(), s_want) <= KERNEL_RTOL


@pytest.mark.parametrize("B,T,Di,N", SSM_EDGES)
def test_ssm_scan_plain_matches_pallas_at_the_edges(B, T, Di, N):
    x = _ssm_inputs(B, T, Di, N, seed=T + Di + N)
    want, s_want = jssm_scan(**_jax(x), chunk=16, block_d=Di,
                             interpret=True)
    got, s_got = ops.ssm_scan(**_torch(x))
    assert _rel(got.numpy(), want) <= KERNEL_RTOL
    assert _rel(s_got.numpy(), s_want) <= KERNEL_RTOL


@pytest.mark.parametrize("T,split", [(40, 17), (33, 16), (20, 1)])
@pytest.mark.parametrize("kernel", ["wkv", "ssm_scan"])
def test_state_handoff_off_the_tile_matches_pallas(kernel, T, split):
    """Two calls over a sequence cut at `split` (a tile and one token; a
    tile; one token), the first's final state handed to the second,
    equal one Pallas call over the whole."""
    if kernel == "wkv":
        x = _wkv_inputs(1, 2, T, 33, 20, seed=T + split)
        want, s_want = jwkv(**_jax(x), chunk=T, interpret=True)
        seq, fixed, dim = ("r", "k", "v", "logw"), "u", 2
    else:
        x = _ssm_inputs(1, T, 200, 16, seed=T + split)
        want, s_want = jssm_scan(**_jax(x), chunk=T, block_d=200,
                                 interpret=True)
        seq, fixed, dim = ("u", "dt", "b", "c"), "log_a", 1
    t = _torch(x)
    fn = getattr(ops, kernel)
    part = lambda a, start, n: a.narrow(dim, start, n).contiguous()  # noqa
    a, s1 = fn(*(part(t[n], 0, split) for n in seq), t[fixed], t["s0"])
    b, s2 = fn(*(part(t[n], split, T - split) for n in seq), t[fixed], s1)
    assert _rel(torch.cat([a, b], dim=dim).numpy(), want) <= KERNEL_RTOL
    assert _rel(s2.numpy(), s_want) <= KERNEL_RTOL
