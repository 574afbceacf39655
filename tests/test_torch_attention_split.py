"""Decode attention's key split, and the new attention grid shapes, on the
CPU.

- `ops.decode_splits`, the host's choice of how many blocks (one
  thread-block cluster) share a (key head, batch row)'s keys at decode:
  a function of (B, Hkv, Tk) alone, so the host never reads kv_len from
  the device and the dtype does not enter; the most splits whose
  splits × Hkv × B blocks still fit the SMs at one a block, wherever
  the keys and the cluster limit allow; every split spans at least one
  key tile (one for each of a block's warps); never more than the
  portable cluster limit; 1 where the keys are one tile a warp.
- The plain `flash_attention` (what the wrapper runs on CPU tensors)
  against the Pallas kernel in interpret mode at smoke widths of the
  grid rows the split decode kernel and the f32 prefill kernel are
  timed at: long decode with and without a softcap, a ragged batch
  with a row that sees no key, one shorter than a split and one at full
  length, four queries a head, and f32 prefill past one block of query
  rows. The Pallas kernel takes no kv_len: a row is held against it on
  its keys sliced to its count (queries right-aligned to them), and a
  row that sees none must give 0. f32 within 1e-5 of the largest
  |value|, bf16 within 2^-8 of the Pallas result on the inputs widened
  to f32, as tests/test_torch_attention.py holds them.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash

from repro_torch.kernels import ops

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8

# (B, Hkv, Tk) of the served decode shapes, the long rows and edges
SHAPES = [(B, Hkv, Tk) for B, Hkv, Tk in itertools.product(
    (1, 2, 4, 8, 64, 200), (1, 2, 5, 8, 16, 32),
    (1, 31, 32, 33, 64, 128, 200, 4416, 70000))]


def test_splits_are_a_function_of_the_shapes_alone():
    for B, Hkv, Tk in SHAPES:
        s = ops.decode_splits(B, Hkv, Tk)
        assert isinstance(s, int)
        assert s == ops.decode_splits(B, Hkv, Tk)


@pytest.mark.parametrize("B,Hkv,Tk", SHAPES)
def test_splits_fill_the_sms_within_the_keys_and_the_cluster(B, Hkv, Tk):
    s = ops.decode_splits(B, Hkv, Tk)
    assert 1 <= s <= ops.DECODE_MAX_SPLITS <= 8
    # each split spans a key tile for every warp (16 keys each, 32 in f32)
    assert s == 1 or s * ops.DECODE_SPLIT_KEYS <= Tk
    assert ops.DECODE_SPLIT_KEYS >= 32
    # one wave: all blocks run at once, and one more split would not fit
    assert s == 1 or s * Hkv * B <= ops.DECODE_SMS
    if s < min(Tk // ops.DECODE_SPLIT_KEYS, ops.DECODE_MAX_SPLITS):
        assert (s + 1) * Hkv * B > ops.DECODE_SMS


@pytest.mark.parametrize("B,Hkv", [(1, 1), (1, 16), (4, 8), (200, 32)])
@pytest.mark.parametrize("Tk", [1, 17, 32, 128, 255])
def test_one_split_where_the_keys_are_one_tile_a_warp(B, Hkv, Tk):
    assert ops.decode_splits(B, Hkv, Tk) == 1


def test_splits_at_the_served_decode_shapes():
    """The grid's decode rows: the long requests take the cluster limit
    (gemma2-27b's 16 key heads × 8 splits, stablelm-12b's 8 × 8: one
    block an SM); the batch-4 cache-128 rows are one block a key head,
    its warps a key tile each; a batch of 4 long rows fills the card at
    2 splits."""
    assert ops.decode_splits(1, 16, 4416) == 8
    assert ops.decode_splits(1, 8, 4416) == 8
    assert ops.decode_splits(4, 8, 128) == 1
    assert ops.decode_splits(4, 16, 128) == 1
    assert ops.decode_splits(4, 5, 128) == 1
    assert ops.decode_splits(4, 16, 4416) == 2


# ---------------------------------------------------------------------------
# the new grid rows at smoke widths against the Pallas kernel
# ---------------------------------------------------------------------------
GRID = {  # B, Hq, Hkv, Tq, Tk, D, window, softcap, kv_len, bq, bk
    # long decode without a softcap (stablelm-12b's heads, narrowed)
    "long_decode": (1, 8, 2, 1, 64, 40, 0, 0.0, [56], 1, 8),
    # a ragged batch: near full, none, shorter than a split, full
    "ragged_long_decode": (4, 4, 2, 1, 64, 16, 48, 50.0, [56, 0, 8, 64],
                           1, 8),
    # four queries a head against a long cache, window and softcap
    "decode_tq4": (1, 4, 2, 4, 64, 16, 48, 50.0, [56], 4, 8),
    # f32 prefill past one block of query rows
    "prefill_tq130": (1, 4, 1, 130, 130, 160, 0, 0.0, None, 65, 65),
}


def _inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(GRID))
def test_plain_matches_pallas_at_the_grid_rows(case, dtype):
    B, Hq, Hkv, Tq, Tk, D, window, softcap, kv_len, bq, bk = GRID[case]
    arrays = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=Tk + D + Tq)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    qn, kn, vn = (t.float().numpy() for t in (q, k, v))
    n = None if kv_len is None else torch.tensor(kv_len)
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap,
                              kv_len=n)
    assert got.dtype == dtype and got.shape == (B, Hq, Tq, D)
    got = got.float().numpy()
    tol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    for b, m in enumerate(kv_len or [Tk] * B):
        if m == 0:
            assert (got[b] == 0).all()
            continue
        want = jflash(*(jnp.asarray(a[b:b + 1, :, :m] if a is not qn
                                    else a[b:b + 1]) for a in (qn, kn, vn)),
                      window=window, softcap=softcap, block_q=bq,
                      block_k=bk, interpret=True)
        assert _rel(got[b:b + 1], want) <= tol
