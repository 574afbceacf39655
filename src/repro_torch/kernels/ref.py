"""Plain PyTorch versions of the port's kernels.

Each reduce, quantize and dequantize function computes exactly what its
CUDA kernel in `csrc/` computes, in the same order of float operations,
so the kernel can be held against it bit for bit on the card; the
recurrences (`wkv_ref`, `ssm_scan_ref`) reduce in another order than
their kernels and are held to a tolerance, as are `rmsnorm` and
`flash_attention`, whose kernels also reduce in another order. The
wrappers in `ops.py` run these for CPU tensors.
They are also held against the JAX package's Pallas kernels and oracles
on shared numpy inputs by the CPU tests.
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


def _sum_from_zero(vals: list[torch.Tensor]) -> torch.Tensor:
    """0 + vals[0] + vals[1] + ..., left to right, in f32."""
    acc = torch.zeros_like(vals[0], dtype=torch.float32)
    for v in vals:
        acc = acc + v
    return acc


def grouped_reduce_ref(parts: torch.Tensor, fan_in: int) -> torch.Tensor:
    """(x, L) → (L,): the x operand rows summed in f32 as a tree of
    fan_in-ary adds, written in the input dtype. Each level sums groups
    of fan_in consecutive values of the level below, left to right from
    0, until one value is left (one level for x = 1). The reference pads
    a level's last group with zeros; adding +0 to a sum that starts at +0
    changes nothing, so the pad is left out."""
    vals = [parts[j].float() for j in range(parts.shape[0])]
    while True:
        vals = [_sum_from_zero(vals[g:g + fan_in])
                for g in range(0, len(vals), fan_in)]
        if len(vals) == 1:
            return vals[0].to(parts.dtype)


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


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   tile: int = QUANT_TILE,
                   out_len: int | None = None) -> torch.Tensor:
    """(..., Lp) wire + (..., nt) scales → (..., out_len or Lp) f32: each
    tile q·scale, a zero-scale tile exactly 0."""
    deq = _dequant(q, scales, tile)
    if out_len is None or out_len == q.shape[-1]:
        return deq
    return deq[..., :out_len].contiguous()


def dequantize_into_ref(q: torch.Tensor, scales: torch.Tensor,
                        rows: torch.Tensor, out: torch.Tensor,
                        out_rows: torch.Tensor,
                        tile: int = QUANT_TILE) -> None:
    """Gathered dequantize, in place: for every batch row b, wire row
    rows[b, 0] of (q, scales) decoded (−1 = zeros) and cut to out's row
    length L <= Lp, written to out row out_rows[b] in out's dtype."""
    r = rows[:, 0]
    safe = r.clamp(min=0)
    deq = _dequant(q[safe], scales[safe], tile)[:, :out.shape[-1]]
    deq = torch.where((r >= 0)[:, None], deq, torch.zeros_like(deq))
    out[out_rows] = deq.to(out.dtype)


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


def quant_reduce_requant_ref(q: torch.Tensor, scales: torch.Tensor,
                             wire: str = "float8_e4m3fn",
                             tile: int = QUANT_TILE
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, Lp) wire + (K, nt) scales → (q (Lp,) `wire`, scales (nt,) f32):
    the sum of `quant_reduce_ref`, encoded as `quantize_ref` encodes."""
    q_out, s_out = quantize_ref(quant_reduce_ref(q, scales, tile=tile)[None],
                                wire, tile)
    return q_out[0], s_out[0]


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


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV recurrence, token by token, in f32. r/k/logw (B, H, T, K),
    v (B, H, T, V), u (H, K), s0 (B, H, K, V) → (out (B, H, T, V), final
    state (B, H, K, V)):

        o_t = Σ_k r_t[k] · (S[k, :] + u[k] · k_t[k] · v_t)
        S  ← exp(logw_t) ⊙ S + k_t ⊗ v_t   (decay per row k)

    The same function as the reference's chunked form; the kernel sums
    over k in another order, so the two agree to rounding."""
    w = torch.exp(logw)
    s = s0
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]        # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(outs, dim=2), s


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, log_a: torch.Tensor, s0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-SSM scan, token by token, in f32. u/dt (B, T, Di), b/c
    (B, T, N), log_a (Di, N), s0 (B, Di, N) → (y (B, T, Di), final state
    (B, Di, N)):

        s ← exp(dt_t ⊙ log_a) ⊙ s + (dt_t · u_t) ⊗ b_t,  y_t = s · c_t

    The kernel sums over N in another order, so the two agree to
    rounding."""
    s = s0
    ys = []
    for t in range(u.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * log_a)           # (B, Di, N)
        s = decay * s + (dt[:, t] * u[:, t])[:, :, None] * b[:, t, None, :]
        ys.append((s * c[:, t, None, :]).sum(dim=-1))
    return torch.stack(ys, dim=1), s


NEG_INF = -1e30   # the masked score; finite, so exp(NEG_INF − NEG_INF) = 1
FLASH_BLOCK_Q = 256   # queries a score tile of the plain attention


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            offset: float = 0.0) -> torch.Tensor:
    """x (..., D) · rsqrt(mean x² + eps) · (offset + w), in f32, written in
    x's dtype. offset 0 is the reference's Pallas kernel (scale by w),
    offset 1 the models' norm (scale by 1 + w, formed in f32)."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * (offset + w.float())).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """GQA attention, the reference kernel's function: q (B, Hq, Tq, D),
    k/v (B, Hkv, Tk, D), query head h reading key head h // (Hq / Hkv).

    Row b sees keys [0, kv_len[b]) (default Tk; clamped to [0, Tk]) with
    its queries right-aligned to them: query i sits at position
    kv_len[b] − Tq + i. Scores are q·k·scale (default D^-1/2), then
    softcap·tanh(s / softcap) when softcap > 0, then masked (causal: key
    position <= query position; window w > 0: key position > query
    position − w). The softmax weights of masked keys are 0 and the sum
    is divided by (Σ weights + 1e-30), so a row that sees no key gives 0.
    Math in f32, output in q's dtype, as a (B, Hq, Tq, D) view of a
    (B, Tq, Hq, D) tensor (the kernel's layout); queries go
    FLASH_BLOCK_Q at a time, which bounds the score tile."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    n = torch.full((B,), Tk, dtype=torch.long, device=q.device) \
        if kv_len is None else kv_len.long().clamp(0, Tk)
    kf = k.float()[:, :, None]                          # (B, Hkv, 1, Tk, D)
    vf = v.float()[:, :, None]
    kpos = torch.arange(Tk, device=q.device)
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=q.device)
    for q0 in range(0, Tq, FLASH_BLOCK_Q):
        t = min(FLASH_BLOCK_Q, Tq - q0)
        qb = q[:, :, q0:q0 + t].float().reshape(B, Hkv, G, t, D)
        s = (qb @ kf.transpose(-1, -2)) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        qpos = (n[:, None] - Tq + q0
                + torch.arange(t, device=q.device))[:, :, None]  # (B, t, 1)
        mask = kpos < n[:, None, None]                          # (B, t, Tk)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        mask = mask[:, None, None]                      # (B, 1, 1, t, Tk)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, p, 0.0)
        o = (p @ vf) / (p.sum(dim=-1, keepdim=True) + 1e-30)
        out[:, q0:q0 + t] = o.reshape(B, Hq, t, D).transpose(1, 2).to(q.dtype)
    return out.transpose(1, 2)
