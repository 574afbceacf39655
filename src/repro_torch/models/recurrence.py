"""Linear-recurrence layers: RWKV6 (Finch) time mix and channel mix, and
the Mamba-style selective SSM of Hymba's parallel branch.

Mirrors the reference `models/recurrence.py` op for op, with its layouts
and dtypes (projections in the weights' dtype, recurrences and gates in
f32). The reference evaluates the WKV recurrence in a chunked parallel
form and the SSM as a chunk-checkpointed scan off the TPU, and through its
Pallas kernels on it.

Serving (`rwkv_time_mix`, `mamba_ssm`) goes through the kernel wrappers
(`kernels.ops.wkv`, `kernels.ops.ssm_scan`), which launch the CUDA kernel
for a CUDA tensor and run the plain version for a CPU one. The kernels
have no backward (nor have the reference's Pallas kernels, which its
training therefore never reaches), so training takes the reference's
off-TPU forms in differentiable torch ops: `_wkv_chunk`, the chunked
parallel WKV, and `_ssm_scan_chunked`, the step-by-step scan with each
chunk under activation checkpointing (the reference's
`jax.checkpoint(chunk_body)`), through `train_rwkv_time_mix` and
`train_mamba_ssm`, whose norms are `layers.train_rmsnorm`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .actsharding import whole
from .config import ModelConfig
from .layers import (Params, dense_init, rmsnorm, tp_dot, tp_ffn,
                     train_rmsnorm)

RWKV_LORA = 64        # rank of the data-dependent decay's low-rank map


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
def init_rwkv(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
              device="cpu") -> Params:
    """One layer's time-mix and channel-mix weights, drawn from `gen` (a
    generator on `device`); the decay base `w0` and bonus `u` in f32."""
    d = cfg.d_model
    hk = cfg.n_heads * cfg.head_dim

    def w(shape, scale=None):
        return dense_init(gen, shape, scale, dtype, device)

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    def rand(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device).to(dtype)

    return {
        "mu": rand((5, d)),
        "wr": w((d, hk)), "wk": w((d, hk)), "wv": w((d, hk)),
        "wg": w((d, hk)), "wo": w((hk, d)),
        "w0": randn((hk,)) * 0.5 - 2.0,
        "w_a": w((d, RWKV_LORA)),
        "w_b": w((RWKV_LORA, hk), scale=0.01),
        "u": randn((cfg.n_heads, cfg.head_dim)) * 0.1,
        "ln_x": torch.zeros((hk,), dtype=dtype, device=device),
        # channel mix
        "cm_mu": rand((2, d)),
        "cm_k": w((d, cfg.d_ff)),
        "cm_v": w((cfg.d_ff, d)),
        "cm_r": w((d, d)),
    }


def _widened(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w widened to f32 (the reference's `x @ w.astype(f32)`)."""
    return x @ w.float()


def _relu_sq(k: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(k))


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x: (B, T, D) → x shifted right by one (first slot = prev or 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _heads(a: torch.Tensor, B: int, T: int, H: int, hd: int
           ) -> torch.Tensor:
    """(B, T, H·hd) → contiguous f32 (B, H, T, hd), the kernel's layout."""
    return a.reshape(B, T, H, hd).transpose(1, 2).float().contiguous()


def _time_mix_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     shift_prev: torch.Tensor | None):
    """The WKV recurrence's f32 (B, H, T, hd) r, k, v and log-decay
    (≤ 0), and the (B, T, H·hd) f32 output gate, of x (B, T, D)."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, shift_prev)
    mu = whole(p["mu"]).float()
    xf, xsf = x.float(), xs.float()

    def mix(i):
        return (xf + mu[i] * (xsf - xf)).to(x.dtype)

    r = _heads(tp_dot(mix(0), p["wr"]), B, T, H, hd)
    k = _heads(tp_dot(mix(1), p["wk"]), B, T, H, hd)
    v = _heads(tp_dot(mix(2), p["wv"]), B, T, H, hd)
    g = F.silu(tp_dot(mix(3), p["wg"]).float())
    # data-dependent decay (RWKV6): w = exp(−exp(w0 + tanh(x A) B))
    dd = tp_dot(torch.tanh(tp_dot(mix(4), p["w_a"]).float()), p["w_b"],
                _widened)
    logw = _heads(-torch.exp(whole(p["w0"]) + dd), B, T, H, hd)   # ≤ 0
    return r, k, v, logw, g


def _time_mix_out(p: Params, x: torch.Tensor, out: torch.Tensor,
                  g: torch.Tensor, norm) -> torch.Tensor:
    B, H, T, hd = out.shape
    out = out.transpose(1, 2).reshape(B, T, H * hd)
    out = norm(out, p["ln_x"]) * g
    return tp_dot(out.to(x.dtype), p["wo"])


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: torch.Tensor | None = None,
                  shift_prev: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → (out (B, T, D), final WKV state (B, H, K, V) f32).
    state: the (B, H, K, V) state before the first token (default 0)."""
    r, k, v, logw, g = _time_mix_inputs(p, x, cfg, shift_prev)
    if state is None:
        B, H, _, hd = r.shape
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    out, s_fin = ops.wkv(r, k, v, logw, p["u"], state.contiguous())
    return _time_mix_out(p, x, out, g, rmsnorm), s_fin


def _chunk_of(T: int, chunk: int) -> int:
    """The largest divisor of T not exceeding `chunk`, as the reference
    chooses its chunk."""
    C = min(chunk, T)
    while T % C:
        C -= 1
    return C


def _wkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked WKV, differentiable. r/k/logw (B, H, T, K),
    v (B, H, T, V), logw ≤ 0, u (H, K), s0 (B, H, K, V), all f32 →
    (out (B, H, T, V), final state). Within a chunk of C tokens (the
    largest divisor of T not exceeding `chunk`) the pair (t, s < t)
    weighs exp(Λ_t − Λ_s) per channel, Λ the running log-decay sum, so
    every exponent is ≤ 0; the state carries across chunks. The pairs
    s ≥ t are masked to −inf before the exp: their exponents are large
    and positive, and a product of exp by a mask would put inf · 0 into
    the backward."""
    C = _chunk_of(k.shape[2], chunk)
    ar = torch.arange(C, device=k.device)
    tmask = (ar[:, None] > ar[None, :])[:, :, None]         # (C, C, 1)
    s, outs = s0, []
    # split, not slices: one backward concatenation, not a zero-filled
    # full-length gradient a chunk
    for rc, kc, vc, lw in zip(*(torch.split(a, C, dim=2)
                                for a in (r, k, v, logw))):
        linc = torch.cumsum(lw, dim=2)        # inclusive Λ (B, H, C, K)
        lexc = linc - lw                      # exclusive
        # the state's contribution
        o1 = torch.einsum("bhtk,bhkv->bhtv", rc * torch.exp(lexc), s)
        # intra-chunk pairs (s < t): exponent lexc_t − linc_s ≤ 0
        expo = lexc[:, :, :, None, :] - linc[:, :, None, :, :]
        pair = torch.exp(torch.where(tmask, expo, -torch.inf))
        att = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * pair).sum(-1)
        o2 = torch.einsum("bhts,bhsv->bhtv", att, vc)
        # the bonus of the current token
        bonus = (rc * (kc * u[None, :, None, :])).sum(-1)
        o3 = bonus[..., None] * vc
        # the state update
        ltot = linc[:, :, -1:, :]                           # (B, H, 1, K)
        s = torch.exp(ltot.squeeze(2))[..., None] * s + torch.einsum(
            "bhtk,bhtv->bhkv", kc * torch.exp(ltot - linc), vc)
        outs.append(o1 + o2 + o3)
    return torch.cat(outs, dim=2), s


def train_rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                        chunk: int = 32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`rwkv_time_mix` for training, differentiable: from a zero state and
    shift, through `_wkv_chunk` and `train_rmsnorm`, no kernel."""
    r, k, v, logw, g = _time_mix_inputs(p, x, cfg, None)
    B, H, _, hd = r.shape
    s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    out, s_fin = _wkv_chunk(r, k, v, logw, whole(p["u"]), s0, chunk)
    return _time_mix_out(p, x, out, g, train_rmsnorm), s_fin


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     shift_prev: torch.Tensor | None = None) -> torch.Tensor:
    xs = _token_shift(x, shift_prev)
    mu = whole(p["cm_mu"]).float()
    xf, xsf = x.float(), xs.float()
    xk = (xf + mu[0] * (xsf - xf)).to(x.dtype)
    xr = (xf + mu[1] * (xsf - xf)).to(x.dtype)
    return torch.sigmoid(tp_dot(xr, p["cm_r"]).float()).to(x.dtype) * \
        tp_ffn(xk, (p["cm_k"],), _relu_sq, p["cm_v"])


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba branch)
# ---------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device="cpu") -> Params:
    """One layer's SSM branch, drawn from `gen` (a generator on `device`);
    the step-size map, decays and skip in f32."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state

    def w(shape, scale=None, wdtype=dtype):
        return dense_init(gen, shape, scale, wdtype, device)

    return {
        "in_x": w((d, di)),
        "in_z": w((d, di)),
        "w_dt": w((di, 1), scale=0.1, wdtype=torch.float32),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "w_b": w((di, n)),
        "w_c": w((di, n)),
        "log_a": -torch.exp(torch.randn((di, n), generator=gen,
                                        dtype=torch.float32,
                                        device=device) * 0.5),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out": w((di, d)),
    }


def _ssm_inputs(p: Params, x: torch.Tensor):
    """The scan's f32 inputs u, dt (B, T, Di) and b, c (B, T, N) of x
    (B, T, D), and the f32 output gate z (B, T, Di)."""
    xb = tp_dot(x, p["in_x"]).float()                     # (B, T, Di)
    di = xb.shape[-1]
    z = F.silu(tp_dot(x, p["in_z"]).float())
    # per-channel step size: the rank-1 dt broadcast over channels + bias
    dt = F.softplus(tp_dot(xb, p["w_dt"]) + whole(p["dt_bias"]))
    b_t = tp_dot(xb, p["w_b"], _widened) / di ** 0.5      # (B, T, N)
    c_t = tp_dot(xb, p["w_c"], _widened) / di ** 0.5
    return F.silu(xb), dt, b_t, c_t, z


def _ssm_out(p: Params, x: torch.Tensor, ys: torch.Tensor, u: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    y = (ys + u * whole(p["d_skip"])) * z
    return tp_dot(y.to(x.dtype), p["out"])


def mamba_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → (out (B, T, D), final SSM state (B, Di, N) f32).
    state: the (B, Di, N) state before the first token (default 0)."""
    u, dt, b_t, c_t, z = _ssm_inputs(p, x)
    if state is None:
        di, n = p["log_a"].shape
        state = torch.zeros((x.shape[0], di, n), dtype=torch.float32,
                            device=x.device)
    ys, s_fin = ops.ssm_scan(u, dt, b_t, c_t, p["log_a"], state.contiguous())
    return _ssm_out(p, x, ys, u, z), s_fin


def _ssm_chunk(s: torch.Tensor, u: torch.Tensor, dt: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, log_a: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the selective scan, step by step from the state s (B,
    Di, N): u, dt (B, C, Di), b, c (B, C, N) → (the state after it, y
    (B, C, Di)). Each step's decay exp(dt · A) and input dt·u·b are the
    reference step's elementwise products, taken for the chunk at once;
    y contracts each step's state with its c. The steps take `unbind`
    views, whose backward is one stack (a step's `select` would write a
    zero-filled chunk-sized gradient)."""
    decay = torch.exp(dt[..., None] * log_a)              # (B, C, Di, N)
    inc = (dt * u)[..., None] * b[:, :, None, :]
    states = []
    for d_i, x_i in zip(decay.unbind(1), inc.unbind(1)):
        s = torch.addcmul(x_i, d_i, s)
        states.append(s)
    return s, torch.einsum("bcdn,bcn->bcd", torch.stack(states, 1), c)


def _ssm_scan_chunked(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, log_a: torch.Tensor, s0: torch.Tensor,
                      chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunk-checkpointed selective scan, differentiable:
    u, dt (B, T, Di), b, c (B, T, N), log_a (Di, N), s0 (B, Di, N), all
    f32 → (y (B, T, Di), final state). Chunks of C steps (the largest
    divisor of T not exceeding `chunk`), each under activation
    checkpointing: the backward keeps one state a chunk and recomputes
    the chunk's steps, so activation memory is T/C states, not T."""
    C = _chunk_of(u.shape[1], chunk)
    s, ys = s0, []
    for parts in zip(*(torch.split(a, C, dim=1) for a in (u, dt, b, c))):
        s, y = checkpoint(_ssm_chunk, s, *parts, log_a, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def train_mamba_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """`mamba_ssm` for training, differentiable: from a zero state through
    `_ssm_scan_chunked`, no kernel."""
    u, dt, b_t, c_t, z = _ssm_inputs(p, x)
    log_a = whole(p["log_a"])
    di, n = log_a.shape
    s0 = torch.zeros((x.shape[0], di, n), dtype=torch.float32,
                     device=x.device)
    ys, s_fin = _ssm_scan_chunked(u, dt, b_t, c_t, log_a, s0, chunk)
    return _ssm_out(p, x, ys, u, z), s_fin
