"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel in `csrc/` computes,
in the same order of float operations, so the kernel can be held against
it bit for bit on the card; the wrappers in `ops.py` run these for CPU
tensors. They are also held against the JAX package's oracles
(`repro/kernels/ref.py`) on shared numpy inputs by the CPU tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

QUANT_TILE = 128  # lanes per f32 scale; matches Precision.scale_block

# Symmetric full-scale magnitude per wire dtype.
WIRE_QMAX = {
    "float8_e4m3fn": 448.0,   # finfo(float8_e4m3fn).max
    "int8": 127.0,
}

WIRE_DTYPES = {
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
}


def wire_dtype(wire: str) -> torch.dtype:
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {wire!r}; "
                         f"one of {sorted(WIRE_DTYPES)}")
    return WIRE_DTYPES[wire]


def fused_reduce_ref(parts: torch.Tensor) -> torch.Tensor:
    """(..., x, L) → (..., L): the x operand rows summed in f32 from 0, in
    operand order, written in the input dtype."""
    acc = torch.zeros(parts.shape[:-2] + parts.shape[-1:],
                      dtype=torch.float32, device=parts.device)
    for j in range(parts.shape[-2]):
        acc = acc + parts[..., j, :].float()
    return acc.to(parts.dtype)


def _add_rows(acc: torch.Tensor, src: torch.Tensor, r: torch.Tensor
              ) -> torch.Tensor:
    """acc + src[r] (in f32) on the batch rows whose index r is >= 0; the
    other rows keep acc whatever their (clamped) source row holds."""
    v = src[r.clamp(min=0), :acc.shape[-1]].float()
    return torch.where((r >= 0)[:, None], acc + v, acc)


def fused_reduce_into_ref(src: torch.Tensor, rows: torch.Tensor,
                          out: torch.Tensor, out_rows: torch.Tensor,
                          own_rows: torch.Tensor | None = None) -> None:
    """Gathered fused reduce, in place: for every batch row b, the f32 sum
    from 0 of src rows rows[b, k] (−1 = skipped) in operand order, plus
    out row own_rows[b] (−1 = none) last, written to out row out_rows[b]
    in out's dtype."""
    B, x = rows.shape
    acc = torch.zeros((B, src.shape[-1]), dtype=torch.float32,
                      device=src.device)
    for k in range(x):
        acc = _add_rows(acc, src, rows[:, k])
    if own_rows is not None:
        acc = _add_rows(acc, out, own_rows)
    out[out_rows] = acc.to(out.dtype)


def quantize_ref(x: torch.Tensor, wire: str = "float8_e4m3fn",
                 tile: int = QUANT_TILE
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, L) f32 → (q (W, Lp) wire, scales (W, nt) f32), Lp = nt·tile.

    scale = amax/qmax per tile, stored as 0 for an all-zero tile; the
    payload is the tile divided by the (safe) scale — int8 rounds half to
    even and then clips, fp8 clips and then rounds to nearest even."""
    qmax = WIRE_QMAX[wire]
    W, L = x.shape
    nt = -(-L // tile)
    t = F.pad(x.float(), (0, nt * tile - L)).reshape(W, nt, tile)
    amax = t.abs().amax(dim=-1)
    # tensor ÷ tensor: a true IEEE divide on every device (PyTorch's CUDA
    # divide by a Python scalar multiplies by its reciprocal instead)
    scale = amax / torch.full_like(amax, qmax)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    y = t / safe[..., None]
    if wire == "int8":
        y = torch.round(y).clamp(-qmax, qmax)
    else:
        y = y.clamp(-qmax, qmax)
    q = y.to(wire_dtype(wire)).reshape(W, nt * tile)
    return q, torch.where(amax > 0.0, scale, torch.zeros_like(scale))


def _dequant(q: torch.Tensor, scales: torch.Tensor, tile: int
             ) -> torch.Tensor:
    """(..., Lp) wire · per-tile scale (..., nt) → (..., Lp) f32, with the
    lanes of every zero-scale tile exactly 0 whatever their payload bits
    (a NaN pattern times 0 would not be)."""
    *lead, Lp = q.shape
    nt = Lp // tile
    deq = (q.float().reshape(*lead, nt, tile)
           * scales[..., None]).reshape(*lead, Lp)
    live = (scales != 0.0).repeat_interleave(tile, dim=-1)
    return torch.where(live, deq, torch.zeros_like(deq))


def quant_reduce_ref(q: torch.Tensor, scales: torch.Tensor,
                     own: torch.Tensor | None = None,
                     tile: int = QUANT_TILE,
                     out_len: int | None = None) -> torch.Tensor:
    """(..., K, Lp) wire + (..., K, nt) scales [+ own (..., L_own) f32]
    → (..., out_len or Lp) f32.

    Each operand tile is decoded as q·scale and summed in f32 from 0 in
    operand order; the resident `own` partial is added last. A tile whose
    scale is 0 (an all-zero tile, or a masked operand) contributes
    exactly 0."""
    *lead, K, Lp = q.shape
    deq = _dequant(q, scales, tile)
    acc = torch.zeros(deq.shape[:-2] + (Lp,), dtype=torch.float32,
                      device=q.device)
    for k in range(K):
        acc = acc + deq[..., k, :]
    if own is not None:
        acc = acc + F.pad(own.float(), (0, Lp - own.shape[-1]))
    if out_len is None or out_len == Lp:
        return acc
    return acc[..., :out_len]


def quant_reduce_into_ref(q: torch.Tensor, scales: torch.Tensor,
                          rows: torch.Tensor, out: torch.Tensor,
                          out_rows: torch.Tensor,
                          own_rows: torch.Tensor | None = None,
                          tile: int = QUANT_TILE) -> None:
    """Gathered fused compressed reduce, in place: for every batch row b,
    the f32 sum from 0 of the decoded wire rows rows[b, k] of (q, scales)
    (−1 = skipped; zero-scale tiles contribute 0) in operand order, cut
    to out's row length L <= Lp, plus out row own_rows[b] (−1 = none)
    last, written to out row out_rows[b] in out's dtype."""
    B, K = rows.shape
    acc = torch.zeros((B, q.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for k in range(K):
        r = rows[:, k].clamp(min=0)
        deq = _dequant(q[r], scales[r], tile)
        acc = torch.where((rows[:, k] >= 0)[:, None], acc + deq, acc)
    acc = acc[:, :out.shape[-1]]
    if own_rows is not None:
        acc = _add_rows(acc, out, own_rows)
    out[out_rows] = acc.to(out.dtype)
