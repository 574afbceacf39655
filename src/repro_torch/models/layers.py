"""Dense transformer layers as plain functions over tensors: RMSNorm in
the `(1 + w)` form, RoPE, GQA attention (full sequence and one-token
decode against a KV cache), SwiGLU MLP, and the initializer.

These mirror the reference `models/layers.py` op for op, with its
layouts: activations (B, T, D), heads (B, H, T, hd), weights (in, out).
Attention never materializes more than one (block_q × Tk) score tile per
head: the full-sequence path loops over query blocks, each against the
whole K with a causal (and optional sliding-window) mask — the reference's
q-block scan. Sliding windows take that masked path; the reference's
banded KV slicing and KV-block scan compute the same function with fewer
reads and are not ported yet. Everything here is plain PyTorch: no fused
attention or normalization operator is called.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               scale: float | None = None, dtype=torch.bfloat16,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """N(0, 1)·scale with scale = fan_in^-1/2 unless given, drawn in f32
    from `gen` (which must live on `device`) and cast to `dtype`."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x·rsqrt(mean x² + eps)·(1 + w), in f32, written in x's dtype."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def _rope_freqs(d: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, D_head); positions: broadcastable to (..., T)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16, device="cpu") -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dtype,
                         device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype,
                         device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype,
                         device=device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dtype,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.mrope_sections is not None or cfg.attn_kv_block:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and the KV-block attention scan are not "
            "ported yet")


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _sdpa_block(q, k, v, mask, scale: float, softcap: float,
                remask: bool = True):
    """One (bq × Tk) attention rectangle; returns (out, m, l) in f32.

    remask=False skips the post-exp re-mask; only safe when every query
    row has at least one valid key (causal self-attention rows always see
    themselves)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if remask:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m, l


def _attend(q, k, v, cfg: ModelConfig, *, window: int = 0,
            causal: bool = True, block_q: int = 512) -> torch.Tensor:
    """Full-sequence attention of (B, H, T, hd) queries against the
    (B, Hkv, Tk, hd) keys/values, q-block by q-block; returns
    (B, T, H·hd) in q's dtype."""
    B, _, T, hd = q.shape
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    Tk = k.shape[2]
    bq = min(block_q, T)
    if T % bq:
        bq = T  # single block
    kpos = torch.arange(Tk, device=q.device)[None, :]
    outs = []
    for q0 in range(0, T, bq):
        qpos = (q0 + torch.arange(bq, device=q.device)[:, None]
                + (Tk - T))
        mask = torch.ones((bq, Tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        o, _m, l = _sdpa_block(q[:, :, q0:q0 + bq], k, v, mask[None, None],
                               hd ** -0.5, cfg.attn_softcap,
                               remask=not causal)
        outs.append((o / (l + 1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=2)
    return out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              window: int = 0, causal: bool = True,
              positions: torch.Tensor | None = None,
              block_q: int = 512) -> torch.Tensor:
    """Full-sequence attention (prefill), q-block by q-block."""
    _check_supported(cfg)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attend(q, k, v, cfg, window=window, causal=causal,
                  block_q=block_q)
    return out @ p["wo"]


def attention_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, window: int = 0) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); cache_{k,v}: (B, Hkv, S, hd);
    pos: (B,) current write position. Writes the new K/V into the cache
    at `pos` IN PLACE (the cache is the caller's decode state) and
    returns the attention output (B, 1, D)."""
    _check_supported(cfg)
    B = x.shape[0]
    hd = cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    cache_k[rows, :, pos] = k_new[:, :, 0]
    cache_v[rows, :, pos] = v_new[:, :, 0]

    rep = cfg.n_heads // cfg.n_kv_heads
    k = cache_k.repeat_interleave(rep, dim=1) if rep > 1 else cache_k
    v = cache_v.repeat_interleave(rep, dim=1) if rep > 1 else cache_v
    S = k.shape[2]
    kpos = torch.arange(S, device=x.device)[None, :]          # (1, S)
    valid = kpos <= pos[:, None]
    if window > 0:
        valid &= kpos > pos[:, None] - window
    mask = valid[:, None, None, :]                              # (B,1,1,S)
    o, _m, l = _sdpa_block(q, k, v, mask, hd ** -0.5, cfg.attn_softcap)
    out = (o / (l + 1e-30)).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d: int, f: int, dtype=torch.bfloat16,
             device="cpu") -> Params:
    return {"wi": dense_init(gen, (d, f), dtype=dtype, device=device),
            "wg": dense_init(gen, (d, f), dtype=dtype, device=device),
            "wo": dense_init(gen, (f, d), dtype=dtype, device=device)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) → (B, T, D) rows of the (vocab, D) table."""
    return table[tokens]
