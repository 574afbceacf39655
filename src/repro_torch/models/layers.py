"""Dense transformer layers as plain functions over tensors: RMSNorm in
the `(1 + w)` form, RoPE and M-RoPE, GQA attention (full sequence and
one-token decode against a KV cache), SwiGLU MLP, the MoE layer (sorted
and dense dispatch), and the initializer.

These mirror the reference `models/layers.py` op for op, with its
layouts: activations (B, T, D), heads (B, H, T, hd), weights (in, out).
Every norm goes through the `rmsnorm` kernel wrapper (offset 1) and
every attention through the `flash_attention` kernel wrapper
(`kernels.ops`): on a CUDA tensor each launches its hand-written kernel,
on a CPU tensor it runs its plain version. The kernel reads the head
layouts through strides and maps query heads to key heads itself, so no
head transpose or GQA repeat of K/V is copied; it writes the output in
the (B, T, H·hd) layout the output projection takes. Decode reads the
cache only up to each row's position (`kv_len`). The reference's banded
and KV-block attention scans compute the same function as the kernel,
whose skipped KV tiles stand in for the banded slice.

The MoE layer has no kernel in the reference either: its router and
expert products are XLA ops, here torch ops (`bmm`), in the reference's
order and dtypes. Its expert-parallel dispatch (`moe_ep`) runs every rank
of the local mesh at once, since each rank's capacity buffer crosses the
others' in one exchange (`core.sync.ep_exchange`).

Training takes other layers: no kernel has a backward (the reference's
Pallas kernels have none, and its training forward never calls them), so
`train_rmsnorm` and `train_attention` are the reference's XLA-op
`rmsnorm` and q-block `attention` written op for op in differentiable
torch ops, f32 where the reference is f32. `transformer.forward` and
`loss_fn` take them; prefill and decode keep the kernel wrappers.

The products take the reference's type promotion (`matmul`): f32
activations against bf16 weights (a vlm's embeddings, whisper's frames
and encoder states) widen the weights to f32, as jnp's `@` does.

Every training product goes through `tp_dot` (or `tp_ffn`, a gated MLP's
three): with no `actsharding.TPContext` installed it is the product as
it was; under the auto engine's context on a "model" axis above 1 a
product whose weight the axis shards runs on this rank's slice of it
(column, row or batch-sharded), and the gate, up and down products of an
MLP sharded Megatron's way keep their intermediate sharded.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import actsharding
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
    from `gen` (which must live on `device`) and cast to `dtype`. Scaled
    in place, so a leaf's draw holds one f32 copy of it, not two."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return x @ w


def matmul(x: torch.Tensor, w: torch.Tensor, gather: bool = True
           ) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as jnp's `@` on mixed
    dtypes: an f32 input against bf16 weights takes the weights widened.
    Tensor-parallel under the auto engine's context (`tp_dot`, which
    reads `gather`)."""
    return tp_dot(x, w, _promoted, gather)


def tp_dot(x: torch.Tensor, w: torch.Tensor,
           fn: Callable = torch.matmul, gather: bool = True) -> torch.Tensor:
    """fn(x, w): a product contracting x's last dim with w's dim -2 into
    w's last (a 3-D w's dim 0 a batch dim, as `torch.bmm`'s), with no
    other use of the weight. With no `actsharding.TPContext`, or a `w`
    its line does not shard, fn(x, w) as it is. Where the line shards
    the parameter leaf `w`, fn runs on this rank's slice of it:
      * its output dim (column): on x as it is (`TPContext.copy`: the
        cotangent of x summed over the line), the result gathered along
        its last dim, unless `gather` is False (the logits, which the
        loss takes sliced: `actsharding.TPContext.vocab_slice`);
      * its contraction dim (row): on this rank's slice of x's last dim,
        the partial results summed over the line;
      * a batch dim: on this rank's slice of x's dim 0, the results
        gathered along dim 0."""
    ctx = actsharding.tp_context()
    d = None if ctx is None else ctx.dim(w)
    if d is None:
        return fn(x, w)
    d -= w.dim()
    if d == -1:
        y = fn(ctx.copy(x), w)
        return ctx.gather(y, -1) if gather else y
    if d == -2:
        return ctx.reduce(fn(ctx.slice(x, -1), w))
    return ctx.gather(fn(ctx.slice(x, 0), w), 0)


def tp_ffn(x: torch.Tensor, ws_in: Sequence[torch.Tensor],
           inner: Callable, w_out: torch.Tensor,
           fn: Callable = torch.matmul) -> torch.Tensor:
    """fn(inner(fn(x, w) for w in ws_in), w_out), each product through
    `tp_dot`; where one line shards every w of `ws_in` on its output dim
    and `w_out` on its contraction dim, the intermediate stays sharded
    (`inner` is elementwise): x enters each rank's slices as it is, and
    one sum over the line follows `w_out` (the Megatron MLP)."""
    ctx = actsharding.tp_context()
    if ctx is not None and ctx.dim(w_out) == w_out.dim() - 2 and all(
            ctx.dim(w) == w.dim() - 1 for w in ws_in):
        xc = ctx.copy(x)
        return ctx.reduce(fn(inner(*(fn(xc, w) for w in ws_in)), w_out))
    return tp_dot(inner(*(tp_dot(x, w, fn) for w in ws_in)), w_out, fn)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x·rsqrt(mean x² + eps)·(1 + w), in f32, written in x's dtype."""
    return ops.rmsnorm(x, w, eps, offset=1.0)


def train_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The reference's `rmsnorm` in differentiable torch ops, in its
    order (training)."""
    w = actsharding.whole(w)
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def _rope_freqs(d: int, theta: float, device) -> torch.Tensor:
    """theta^(-2i/d) for i < d/2, rounded once to f32: the reference's
    compiled program folds these constants whole, where f32 steps land
    an ulp off in some lanes, which positions in the thousands turn into
    angles 1e-4 apart."""
    e = torch.arange(0, d, 2, dtype=torch.float64, device=device) / d
    return (1.0 / theta ** e).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, D_head); positions: broadcastable to (..., T)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, H, T, D); positions: (3, B, T),
    one position stream per (t, h, w) section of the rotary dims. Section
    s owns freqs[start:start + sections[s]] of the D/2 frequencies; the
    section ids are cut or padded (with the last) to D/2, as the
    reference's `jnp.repeat(..., total_repeat_length=D/2)`: at a head dim
    below 2·sum(sections) the later sections drop out."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=sum(sections))
    sec_id = torch.cat([sec_id, sec_id[-1:].expand(half)])[:half]
    pos = positions[sec_id].movedim(0, -1)               # (B, T, half)
    ang = pos[:, None].float() * freqs                   # (B, 1, T, half)
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


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None, norm=rmsnorm,
         mrope_positions: torch.Tensor | None = None):
    """q (B, H, T, hd), k and v (B, Hkv, T, hd) of x, qk_norm'd where the
    config says so, then rotated: by M-RoPE where the config has sections
    and `mrope_positions` (3, B, T) are given, else by RoPE at
    `positions`, as the reference's branch order."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"]).reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = matmul(x, p["wk"]).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = matmul(x, p["wv"]).reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = norm(q, p["q_norm"])
        k = norm(k, p["k_norm"])
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    elif positions is not None:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, cfg: ModelConfig, *, window: int = 0,
            causal: bool = True) -> torch.Tensor:
    """Full-sequence attention of (B, H, T, hd) queries against the
    (B, Hkv, Tk, hd) keys/values, queries right-aligned to the keys;
    returns (B, T, H·hd) in q's dtype."""
    B, _, T, hd = q.shape
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    return out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              window: int = 0, causal: bool = True,
              positions: torch.Tensor | None = None,
              mrope_positions: torch.Tensor | None = None,
              block_q: int = 512) -> torch.Tensor:
    """Full-sequence attention (prefill). `block_q` is accepted for the
    reference's signature; the kernel and its plain version tile the
    queries themselves."""
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions, mrope_positions=mrope_positions)
    out = _attend(q, k, v, cfg, window=window, causal=causal)
    return out @ p["wo"]


def _sdpa_block(q, k, v, mask, scale: float, softcap: float,
                remask: bool = True):
    """One (bq × Tk) attention rectangle in f32; returns (out, m, l), as
    the reference's. remask=False skips the re-mask after the exp, which
    is exact where every query row sees at least one key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m)
    if remask:
        w = torch.where(mask, w, 0.0)
    l = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    return o, m, l


def train_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: int = 0, causal: bool = True,
                    positions: torch.Tensor | None = None,
                    mrope_positions: torch.Tensor | None = None,
                    block_q: int = 512) -> torch.Tensor:
    """Full-sequence attention for training, differentiable: the
    reference's q-block `attention`, in its branch order: the banded path
    for a causal window narrower than the sequence; with
    `cfg.attn_kv_block` = bk where bk < Tk divides Tk, the online-softmax
    scan over KV blocks (each q block against bk keys at a time, the
    running max m, sum l and output in f32); else every q block against
    all keys. Each rectangle is one `_sdpa_block`."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions, norm=train_rmsnorm,
                   mrope_positions=mrope_positions)
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    Tk = k.shape[2]
    bq = min(block_q, T)
    if T % bq:
        bq = T
    banded = window > 0 and causal and Tk == T and window < T
    bk = cfg.attn_kv_block
    if not banded and bk and Tk % bk == 0 and bk < Tk:
        out = _kv_block_scan(q, k, v, cfg, bq, bk, window, causal, x.dtype)
        return matmul(out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd),
                      p["wo"])
    span = min(bq + (window // bq + 1) * bq, Tk) if banded else Tk
    ar = torch.arange(max(bq, span), device=x.device)
    outs = []
    for qi in range(T // bq):
        start = min(max(qi * bq - (span - bq), 0), Tk - span) if banded \
            else 0
        qpos = qi * bq + ar[:bq, None] + (Tk - T)
        kpos = start + ar[None, :span]
        mask = torch.ones((bq, span), dtype=torch.bool, device=x.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        o, _, l = _sdpa_block(q[:, :, qi * bq:(qi + 1) * bq],
                              k[:, :, start:start + span],
                              v[:, :, start:start + span], mask,
                              hd ** -0.5, cfg.attn_softcap,
                              remask=not causal)
        outs.append((o / (l + 1e-30)).to(x.dtype))
    out = torch.cat(outs, dim=2)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)
    return matmul(out, p["wo"])


def _kv_block_scan(q, k, v, cfg: ModelConfig, bq: int, bk: int,
                   window: int, causal: bool, dtype) -> torch.Tensor:
    """The reference's flash-in-XLA scan: (B, H, T, hd) queries, q block
    by q block, against the (B, H, Tk, hd) keys bk at a time; each KV
    block's `_sdpa_block` (re-masked after the exp: a whole block can be
    masked) folds into the running (o, m, l) by the online softmax.
    Returns (B, H, T, hd) in `dtype`."""
    B, H, T, hd = q.shape
    Tk = k.shape[2]
    ar_q = torch.arange(bq, device=q.device)[:, None]
    ar_k = torch.arange(bk, device=q.device)[None, :]
    outs = []
    for qi in range(T // bq):
        qb = q[:, :, qi * bq:(qi + 1) * bq]
        qpos = qi * bq + ar_q + (Tk - T)
        o_acc = torch.zeros((B, H, bq, hd), dtype=torch.float32,
                            device=q.device)
        m_acc = torch.full((B, H, bq, 1), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_acc = torch.zeros((B, H, bq, 1), dtype=torch.float32,
                            device=q.device)
        for ki in range(Tk // bk):
            kpos = ki * bk + ar_k
            mask = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            o, m, l = _sdpa_block(qb, k[:, :, ki * bk:(ki + 1) * bk],
                                  v[:, :, ki * bk:(ki + 1) * bk], mask,
                                  hd ** -0.5, cfg.attn_softcap)
            m_new = torch.maximum(m_acc, m)
            alpha = torch.exp(m_acc - m_new)
            beta = torch.exp(m - m_new)
            o_acc = o_acc * alpha + o * beta
            l_acc = l_acc * alpha + l * beta
            m_acc = m_new
        outs.append((o_acc / (l_acc + 1e-30)).to(dtype))
    return torch.cat(outs, dim=2)


def attention_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, window: int = 0,
                     kv_len: torch.Tensor | None = None,
                     mrope_positions: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); cache_{k,v}: (B, Hkv, S, hd);
    pos: (B,) current write position; kv_len: pos + 1, where the caller
    has formed it once for all layers. Writes the new K/V into the cache
    at `pos` IN PLACE (the cache is the caller's decode state) and
    returns the attention output (B, 1, D)."""
    B = x.shape[0]
    hd = cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None],
                           mrope_positions=mrope_positions)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, :, pos] = k_new[:, :, 0]
    cache_v[rows, :, pos] = v_new[:, :, 0]
    # row b's query sits at pos[b] and sees the cache up to it
    if kv_len is None:
        kv_len = pos + 1
    out = ops.flash_attention(q, cache_k, cache_v, window=window,
                              softcap=cfg.attn_softcap, kv_len=kv_len)
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


def _swiglu(g: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * i


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return tp_ffn(x, (p["wg"], p["wi"]), _swiglu, p["wo"], _promoted)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) → (B, T, D) rows of the (vocab, D) table. Where the
    auto engine's "model" line shards the table on D, the rows of this
    rank's columns, gathered along D."""
    ctx = actsharding.tp_context()
    d = None if ctx is None else ctx.dim(table)
    if d is None:
        return table[tokens]
    if d != table.dim() - 1:
        raise ValueError(f"an embedding table sharded on dim {d} of "
                         f"{tuple(table.shape)}; the rule shards its D")
    return ctx.gather(table[tokens], -1)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device="cpu") -> Params:
    """The reference's leaves: the router in f32, the routed experts'
    SwiGLU weights stacked (E, ...), the shared experts one wide MLP."""
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, E), scale=0.02, dtype=torch.float32,
                             device=device),
        "wi": dense_init(gen, (E, d, fe), dtype=dtype, device=device),
        "wg": dense_init(gen, (E, d, fe), dtype=dtype, device=device),
        "wo": dense_init(gen, (E, fe, d), dtype=dtype, device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, fe * cfg.n_shared_experts, dtype,
                               device)
    return p


def moe_capacity(n: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert takes from a block of n tokens: the reference's
    int(n·k·cf / E) + 1, rounded up to 8, at least 8."""
    cap = int(n * k * capacity_factor / E) + 1
    return max(8, -(-cap // 8) * 8)


def moe_route(p: Params, xt: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of the (n, D) tokens in f32: softmax, the top k with ties
    to the lower expert (`lax.top_k`'s order: a stable descending sort),
    renormalised. Returns (probs (n, E), topv (n, k), topi (n, k))."""
    probs = torch.softmax(tp_dot(xt.float(), p["router"]), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    return probs, topv / (topv.sum(-1, keepdim=True) + 1e-9), topi


def _experts(p: Params, eb: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert on its (E, rows, D) buffer rows."""
    return tp_ffn(eb, (p["wg"], p["wi"]), _swiglu, p["wo"], torch.bmm)


def _moe_sorted(p: Params, xg: torch.Tensor, topi: torch.Tensor,
                topv: torch.Tensor, E: int, capacity_factor: float
                ) -> torch.Tensor:
    """Capacity-bounded sorted dispatch of G independent token blocks:
    xg (G, ng, D), topi / topv (G, ng, k) → (G, ng, D) in f32. The
    reference's `_moe_sorted_block` / `_moe_sorted_block_ns` (one
    function) on each block: the n·k slots sorted stably by expert, the
    first `cap` of each expert's run kept (in slot order), the rest
    dropped (zero); the buffers filled and the combine read by gathers."""
    G, ng, D = xg.shape
    k = topi.shape[-1]
    nk = ng * k
    cap = moe_capacity(ng, k, E, capacity_factor)
    e_flat = topi.reshape(G, nk)
    order = torch.argsort(e_flat, dim=-1, stable=True)      # sorted → slot
    sorted_e = torch.gather(e_flat, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=xg.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(nk, device=xg.device)
    rank = ar - torch.gather(starts, 1, sorted_e)      # within its run
    # buffer cell (e, c) holds the token at sorted position starts[e] + c
    cells = torch.arange(cap, device=xg.device)
    pos = (starts[:, :, None] + cells).clamp(max=nk - 1).reshape(G, E * cap)
    tok = torch.gather(order, 1, pos) // k
    eb = torch.gather(xg, 1, tok[..., None].expand(G, E * cap, D))
    valid = (cells < counts[:, :, None]).reshape(G, E * cap, 1)
    eb = torch.where(valid, eb, 0.0)
    eb = eb.reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    y = _experts(p, eb).reshape(E, G, cap, D).transpose(0, 1)
    y = y.reshape(G, E * cap, D)
    # slot j sits at sorted position inv[j]
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(G, nk))
    rank_of_slot = torch.gather(rank, 1, inv)
    keep = rank_of_slot < cap
    buf = (e_flat * cap + rank_of_slot).clamp(max=E * cap - 1)
    rows = torch.gather(y, 1, buf[..., None].expand(G, nk, D)).float()
    rows = torch.where(keep[..., None], rows, 0.0)
    return torch.einsum("gnkd,gnk->gnd", rows.reshape(G, ng, k, D),
                        topv.float())


def moe_blocks(cfg: ModelConfig, n: int) -> int:
    """Blocks the sorted dispatch splits n tokens into: cfg.moe_groups
    where it is over 1 and divides n, else one."""
    G = cfg.moe_groups
    return G if G > 1 and n % G == 0 else 1


def moe_drops(topi: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25) -> int:
    """Slots the sorted dispatch drops for the (n, k) routing `topi`: in
    each block, past the first `cap` of an expert."""
    n, k = topi.shape
    G = moe_blocks(cfg, n)
    cap = moe_capacity(n // G, k, cfg.n_experts, capacity_factor)
    counts = torch.zeros((G, cfg.n_experts), dtype=torch.long,
                         device=topi.device)
    slots = topi.reshape(G, -1).long()
    counts.scatter_add_(1, slots, torch.ones_like(slots))
    return int((counts - cap).clamp(min=0).sum())


def _moe_ep_block(xts: Sequence[torch.Tensor], topis: Sequence[torch.Tensor],
                  topvs: Sequence[torch.Tensor], ws: Sequence[Params],
                  ep_n: int, E: int, capacity_factor: float,
                  exchange: Callable[[torch.Tensor], torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The reference's `_moe_ep_block` on every rank of the local mesh at
    once: xts[r] (n, D) rank r's tokens, topis / topvs[r] (n, k) their
    routing, ws[r] rank r's E/ep_n local experts ({"wi", "wg", "wo"},
    (E/ep_n, ...)); `exchange` the AllToAll over the EP axis of the
    (ranks, E·cap·D) stack of the ranks' buffers. Per rank, as the
    reference on its device: capacity over its own n tokens (no
    `moe_groups` blocking); a stable argsort of the flat expert ids; a
    slot's rank in its expert's run, kept below cap; dropped slots
    written to a spill row at E·cap; the buffer owner-major, (ep_n,
    e_local·cap·D), so that chunk j goes to the owner of experts [j·e_local,
    (j+1)·e_local); the exchange; the owner's (e_local, ep_n·cap, D)
    SiLU-gated products (one `bmm` a product); the exchange back into
    the buffer layout; the combine by gathers in f32, weighted by topv.
    Returns the (n, D) f32 outputs, rank by rank."""
    n, D = xts[0].shape
    k = topis[0].shape[-1]
    el = E // ep_n
    cap = moe_capacity(n, k, E, capacity_factor)
    nk = n * k
    ar = torch.arange(nk, device=xts[0].device)
    sends, combine = [], []
    for xt, topi in zip(xts, topis):
        e_flat = topi.reshape(-1)
        order = torch.argsort(e_flat, stable=True)
        sorted_e = e_flat[order]
        counts = torch.zeros(E, dtype=torch.long, device=xt.device)
        counts.scatter_add_(0, e_flat, torch.ones_like(e_flat))
        starts = torch.cumsum(counts, 0) - counts
        rank = ar - starts[sorted_e]
        keep = rank < cap
        buf_idx = torch.where(keep, sorted_e * cap + rank, E * cap)
        buf = xt.new_zeros((E * cap + 1, D)).index_put(
            (buf_idx,), xt[order // k])
        sends.append(buf[:E * cap].reshape(-1))
        # slot j sits at sorted position inv[j]
        inv = torch.empty_like(order).scatter_(0, order, ar)
        combine.append((buf_idx[inv], keep[inv]))
    recv = exchange(torch.stack(sends))       # row r: the ranks' rows for r
    back = []
    for r, w in enumerate(ws):
        eb = recv[r].reshape(ep_n, el, cap, D).transpose(0, 1).reshape(
            el, ep_n * cap, D)
        y = _experts(w, eb)                   # (e_local, ep_n·cap, D)
        back.append(y.reshape(el, ep_n, cap, D).transpose(0, 1).reshape(-1))
    got = exchange(torch.stack(back))         # row r: r's buffer layout
    outs = []
    for r, (slot_buf, slot_keep) in enumerate(combine):
        rows = got[r].reshape(E * cap, D)[slot_buf.clamp(max=E * cap - 1)]
        rows = torch.where(slot_keep[:, None], rows.float(), 0.0)
        outs.append(torch.einsum("nkd,nk->nd", rows.reshape(n, k, D),
                                 topvs[r].float()))
    return outs


def moe_ep(ps: Sequence[Params], xs: Sequence[torch.Tensor],
           cfg: ModelConfig, *, mesh: Sequence[tuple[str, int]],
           capacity_factor: float = 1.25) -> list[torch.Tensor]:
    """The reference's `moe(dispatch="ep")` inside its trainer, on every
    rank of the local mesh at once: `mesh` its live (axis, size) pairs
    (ranks in row-major order), ps[r] rank r's MoE leaves, xs[r] its (B,
    T, D) activations. Under the active `core.sync.EPContext` (the
    trainer's `expert_parallel`, whose axis must split the E experts)
    rank r, at index i along the context's axis, runs experts [i·E/size,
    (i+1)·E/size): `ps[r]["wi"]` / `"wg"` / `"wo"` are its full (E, ...)
    gathered copy, sliced here as the reference's `dynamic_slice`, or
    that slice already. The tokens go through `_moe_ep_block` and the
    differentiable exchange `core.sync.ep_exchange` (the context's
    planned all-to-all, or the flat copy program). The shared experts
    are one MLP a rank, added in f32; each output is cast to its
    input's dtype."""
    from repro_torch.core import sync

    E, k = cfg.n_experts, cfg.top_k
    ctx = sync.ep_context()
    if ctx is None or ctx.size <= 1 or E % ctx.size:
        raise ValueError(f"moe_ep runs under an EP context whose axis "
                         f"splits the {E} experts; got {ctx}")
    mesh = [(str(a), int(s)) for a, s in mesh]
    sizes = [s for _, s in mesh]
    if len(ps) != len(xs) or len(ps) != math.prod(sizes):
        raise ValueError(f"moe_ep: {len(ps)} ranks' leaves and {len(xs)} "
                         f"activations on a mesh of {mesh}")
    el = E // ctx.size
    xts, topis, topvs, ws = [], [], [], []
    for r, (p, x) in enumerate(zip(ps, xs)):
        xt = x.reshape(-1, x.shape[-1])
        _, topv, topi = moe_route(p, xt, k)
        xts.append(xt)
        topis.append(topi)
        topvs.append(topv)
        e0 = ctx.index(mesh, r) * el
        ws.append({w: p[w] if p[w].shape[0] == el else p[w][e0:e0 + el]
                   for w in ("wi", "wg", "wo")})
    lead = sizes if len(sizes) > 1 else [len(ps)]
    kw = {"mesh": mesh} if len(sizes) > 1 else {}

    def exchange(t: torch.Tensor) -> torch.Tensor:
        return sync.ep_exchange(t.reshape(*lead, -1), ctx.axis,
                                **kw).reshape(t.shape)
    outs = _moe_ep_block(xts, topis, topvs, ws, ctx.size, E,
                         capacity_factor, exchange)
    res = []
    for p, x, xt, out in zip(ps, xs, xts, outs):
        if cfg.n_shared_experts:
            out = out + mlp(p["shared"], xt).float()
        res.append(out.to(x.dtype).reshape(x.shape))
    return res


def _moe_ep_rank(p: Params, xt: torch.Tensor, topi: torch.Tensor,
                 topv: torch.Tensor, ctx, E: int,
                 capacity_factor: float) -> torch.Tensor:
    """`_moe_ep_block` as this rank of the process mesh `ctx.mesh`: its
    (n, D) tokens, its slice of the experts (the full (E, ...) gathered
    copy sliced, or that slice already), the exchanges over the EP
    axis's process group. Returns the (n, D) f32 output."""
    from repro_torch.core import sync

    pm = ctx.mesh
    el = E // ctx.size
    e0 = ctx.index(pm, pm.rank) * el
    w = {k: p[k] if p[k].shape[0] == el else p[k][e0:e0 + el]
         for k in ("wi", "wg", "wo")}

    def exchange(t: torch.Tensor) -> torch.Tensor:
        return sync.ep_exchange(t.reshape(-1), ctx.axis,
                                mesh=pm).reshape(t.shape)
    return _moe_ep_block([xt], [topi], [topv], [w], ctx.size, E,
                         capacity_factor, exchange)[0]


def _auto_dp_line():
    """(mesh, line) of the auto engine's mesh context
    (`actsharding.mesh_ctx`) where its data-parallel line holds more
    than one rank, else None."""
    from . import actsharding
    c = actsharding.mesh_ctx()
    if c is None or not c[1]:
        return None
    mesh, dp = c
    line = mesh.line(dp)
    return (mesh, line) if line.size > 1 else None


def _moe_auto(p: Params, xt: torch.Tensor, topi: torch.Tensor,
              topv: torch.Tensor, cfg: ModelConfig, one_block: bool,
              capacity_factor: float, mesh, line) -> torch.Tensor:
    """The reference's global sorted dispatch (what GSPMD computes on its
    sharded tokens) from one rank of the auto engine's data-parallel
    `line`, whose (n, D) tokens `xt` are rows [i·n, (i+1)·n) of the
    global n·dpn (i its index on the line). Returns its (n, D) f32 rows.

      * one block (`dispatch="local"`, `cfg.moe_local`): the reference's
        `_moe_local_shardmap` sorts each DP shard's tokens alone, so the
        rank dispatches its own n as one block (one token a rank is its
        global one block);
      * "sorted": capacity and the stable sort are the global token
        count's, in `moe_blocks(cfg, n·dpn)` blocks of contiguous
        tokens. Where dpn divides that count G, the rank's tokens are
        exactly G/dpn of the blocks, and it dispatches them alone;
        otherwise it gathers every rank's tokens and routing over the
        line (differentiable: `core.transport.all_gather_rows_diff`),
        dispatches them all, and keeps its rows. A rank-local blocking
        (`moe_blocks(cfg, n)`) would take another capacity, and so
        compute another function wherever capacity binds."""
    from repro_torch.core.transport import (all_gather_rows,
                                            all_gather_rows_diff)

    n, D = xt.shape
    k = topi.shape[-1]
    E = cfg.n_experts
    dpn = line.size
    n_all = n * dpn
    G = 1
    if one_block:
        if n > 1:
            return _moe_sorted(p, xt[None], topi[None], topv[None], E,
                               capacity_factor)[0]
    else:
        G = moe_blocks(cfg, n_all)
        if G > 1 and G % dpn == 0:
            g = G // dpn
            return _moe_sorted(p, xt.reshape(g, n // g, D),
                               topi.reshape(g, n // g, k),
                               topv.reshape(g, n // g, k), E,
                               capacity_factor).reshape(n, D)
    xa = all_gather_rows_diff(mesh, line, xt).reshape(G, n_all // G, D)
    va = all_gather_rows_diff(mesh, line, topv).reshape(G, n_all // G, k)
    ia = all_gather_rows(mesh, line, topi.contiguous()).reshape(
        G, n_all // G, k)
    out = _moe_sorted(p, xa, ia, va, E, capacity_factor).reshape(n_all, D)
    return out[line.index * n:(line.index + 1) * n]


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
        dispatch: str = "sorted", capacity_factor: float = 1.25
        ) -> torch.Tensor:
    """x: (B, T, D) → (B, T, D), the reference's `moe`. dispatch:
    "sorted" (capacity-bounded sorted pack; with cfg.moe_groups > 1
    dividing the tokens, G blocks each with its own capacity, else one
    block), "dense" (every expert on every token, masked by the top-k
    gate), "ep" or "local". The shared experts are one MLP, added in
    f32; the output is cast to x's dtype.

    "ep" and "local" (and "sorted" with cfg.moe_local) are the
    reference's expert-parallel and shard_map dispatches. Where its
    `_moe_ep` finds no EP context and its `_moe_local_shardmap` no
    GSPMD mesh context, each runs `_moe_sorted_block`: one block, no
    `moe_groups`. The port has no GSPMD engine, so on one rank that is
    their function in every context but the trainer's EP context with
    experts split over its axis. There, on a process mesh (the
    context's `mesh`), "ep" runs `_moe_ep_block` on this rank's tokens
    alone and its experts [i·E/size, (i+1)·E/size) (i its coordinate on
    the axis), the exchanges `core.sync.ep_exchange` over the axis's
    process group; on the local mesh one rank alone cannot exchange:
    the trainer runs every rank at once through `moe_ep`, and this
    raises. Neither is a fallback from a device or a kernel: neither
    dispatch has a kernel.

    Under the auto engine's mesh context (`actsharding.mesh_ctx`, a
    data-parallel line of more than one process) x is this rank's rows
    of the batch and "sorted", "local" and `cfg.moe_local` compute the
    reference's global function on them (`_moe_auto`); "ep" there is
    the reference's expert-parallel region under GSPMD, which raises
    (ROADMAP §1 item 8f)."""
    if dispatch not in ("sorted", "dense", "ep", "local"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    ctx = None
    auto = _auto_dp_line()
    if dispatch == "ep" and auto is not None:
        raise NotImplementedError(
            f"{cfg.name}: dispatch 'ep' under the auto engine's mesh "
            "context (the reference's expert-parallel shard_map region "
            "under GSPMD) is ROADMAP §1 item 8f")
    if dispatch == "ep":
        from repro_torch.core import sync
        ctx = sync.ep_context()
        if ctx is None or ctx.size <= 1 or E % ctx.size:
            ctx = None
        elif ctx.mesh is None:
            raise ValueError(
                f"{cfg.name}: dispatch 'ep' under an EP context of "
                f"{ctx.size} ranks exchanges between ranks; run every rank "
                "at once with layers.moe_ep")
    xt = x.reshape(n, D)
    _, topv, topi = moe_route(p, xt, k)
    if ctx is not None:
        out = _moe_ep_rank(p, xt, topi, topv, ctx, E, capacity_factor)
    elif dispatch == "dense":
        gate = torch.zeros((n, E), dtype=torch.float32, device=x.device)
        gate.scatter_(1, topi, topv)
        xe = xt.expand(E, n, D)
        y = _experts(p, xe)                                 # (E, n, D)
        out = torch.einsum("end,ne->nd", y.float(), gate)
    elif auto is not None:
        out = _moe_auto(p, xt, topi, topv, cfg,
                        dispatch == "local" or cfg.moe_local,
                        capacity_factor, *auto)
    else:
        one_block = dispatch in ("ep", "local") or cfg.moe_local
        G = 1 if one_block else moe_blocks(cfg, n)
        out = _moe_sorted(p, xt.reshape(G, n // G, D),
                          topi.reshape(G, n // G, k),
                          topv.reshape(G, n // G, k), E,
                          capacity_factor).reshape(n, D)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xt).float()
    return out.to(x.dtype).reshape(B, T, D)
