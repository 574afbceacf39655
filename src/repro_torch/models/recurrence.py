"""Linear-recurrence layers: RWKV6 (Finch) time mix and channel mix, and
the Mamba-style selective SSM of Hymba's parallel branch.

Mirrors the reference `models/recurrence.py` op for op, with its layouts
and dtypes (projections in the weights' dtype, recurrences and gates in
f32). The reference evaluates the WKV recurrence in a chunked parallel
form and the SSM as a chunk-checkpointed scan off the TPU, and through its
Pallas kernels on it; here both recurrences always go through their kernel
wrappers (`kernels.ops.wkv`, `kernels.ops.ssm_scan`), which launch the
CUDA kernel for a CUDA tensor and run the plain version for a CPU one.
Only the serving path is ported: no backward pass, so no checkpointing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import Params, dense_init, rmsnorm

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


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: torch.Tensor | None = None,
                  shift_prev: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → (out (B, T, D), final WKV state (B, H, K, V) f32).
    state: the (B, H, K, V) state before the first token (default 0)."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, shift_prev)
    mu = p["mu"].float()
    xf, xsf = x.float(), xs.float()

    def mix(i):
        return (xf + mu[i] * (xsf - xf)).to(x.dtype)

    r = _heads(mix(0) @ p["wr"], B, T, H, hd)
    k = _heads(mix(1) @ p["wk"], B, T, H, hd)
    v = _heads(mix(2) @ p["wv"], B, T, H, hd)
    g = F.silu((mix(3) @ p["wg"]).float())
    # data-dependent decay (RWKV6): w = exp(−exp(w0 + tanh(x A) B))
    dd = torch.tanh((mix(4) @ p["w_a"]).float()) @ p["w_b"].float()
    logw = _heads(-torch.exp(p["w0"] + dd), B, T, H, hd)   # ≤ 0
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    out, s_fin = ops.wkv(r, k, v, logw, p["u"], state.contiguous())
    out = out.transpose(1, 2).reshape(B, T, H * hd)
    out = rmsnorm(out, p["ln_x"]) * g
    return out.to(x.dtype) @ p["wo"], s_fin


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     shift_prev: torch.Tensor | None = None) -> torch.Tensor:
    xs = _token_shift(x, shift_prev)
    mu = p["cm_mu"].float()
    xf, xsf = x.float(), xs.float()
    xk = (xf + mu[0] * (xsf - xf)).to(x.dtype)
    xr = (xf + mu[1] * (xsf - xf)).to(x.dtype)
    kk = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid((xr @ p["cm_r"]).float()).to(x.dtype) * \
        (kk @ p["cm_v"])


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


def mamba_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → (out (B, T, D), final SSM state (B, Di, N) f32).
    state: the (B, Di, N) state before the first token (default 0)."""
    B = x.shape[0]
    di, n = p["log_a"].shape
    xb = (x @ p["in_x"]).float()                          # (B, T, Di)
    z = F.silu((x @ p["in_z"]).float())
    # per-channel step size: the rank-1 dt broadcast over channels + bias
    dt = F.softplus(xb @ p["w_dt"] + p["dt_bias"])        # (B, T, Di)
    b_t = xb @ p["w_b"].float() / di ** 0.5               # (B, T, N)
    c_t = xb @ p["w_c"].float() / di ** 0.5
    u = F.silu(xb)
    if state is None:
        state = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    ys, s_fin = ops.ssm_scan(u, dt, b_t, c_t, p["log_a"], state.contiguous())
    y = (ys + u * p["d_skip"]) * z
    return y.to(x.dtype) @ p["out"], s_fin
