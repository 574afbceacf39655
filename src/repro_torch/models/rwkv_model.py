"""RWKV6 (Finch) language model — attention-free, with a recurrent state.

Mirrors the reference `models/rwkv_model.py`. The state per layer is the
(B, H, K, V) WKV matrix plus the one-token shift buffers of the time mix
and the channel mix, stacked on a leading (L,) axis as in the reference;
`params["layers"]` is a list of per-layer dicts run by a Python loop
(`convert.params_from_jax` unstacks the reference's layout).

`forward` and `loss_fn` are the training path: differentiable torch ops
(`recurrence.train_rwkv_time_mix`, the chunked WKV; `layers.
train_rmsnorm`), each layer under activation checkpointing when `remat`
is set, as the reference's `jax.checkpoint` body, from a zero state.
Prefill and decode serve through the kernels (`_serve`), decode a
one-token forward that carries the state, O(1) per token whatever the
context length.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .actsharding import constrain
from .config import ModelConfig
from .layers import (Params, dense_init, embed, rmsnorm, tp_dot,
                     train_rmsnorm)
from .recurrence import (init_rwkv, rwkv_channel_mix, rwkv_time_mix,
                         train_rwkv_time_mix)
from .transformer import _nll


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights drawn from `gen` (a generator on `device`)."""
    d = cfg.d_model

    def layer():
        p = init_rwkv(gen, cfg, dtype, device)
        p["ln1"] = torch.zeros((d,), dtype=dtype, device=device)
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
        return p

    return {
        "layers": [layer() for _ in range(cfg.n_layers)],
        "ln_f": torch.zeros((d,), dtype=dtype, device=device),
        "embed": dense_init(gen, (cfg.vocab, d), scale=0.02, dtype=dtype,
                            device=device),
        "lm_head": dense_init(gen, (d, cfg.vocab), dtype=dtype,
                              device=device),
    }


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Zero state: WKV matrices in f32, shift buffers in the activations'
    dtype (storing them narrower would break prefill → decode
    consistency)."""
    hd = cfg.head_dim
    shift = (cfg.n_layers, batch, 1, cfg.d_model)
    return {
        "wkv": torch.zeros((cfg.n_layers, batch, cfg.n_heads, hd, hd),
                           dtype=torch.float32, device=device),
        "tm_shift": torch.zeros(shift, dtype=dtype, device=device),
        "cm_shift": torch.zeros(shift, dtype=dtype, device=device),
    }


def _train_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, chunk: int
                 ) -> tuple[torch.Tensor, ...]:
    """One layer from a zero state: (x after it, its final WKV state, and
    its two shift buffers, the last token of each mix's input)."""
    z = train_rmsnorm(x, lp["ln1"])
    h, s_new = train_rwkv_time_mix(lp, z, cfg, chunk=chunk)
    x = x + h
    z2 = train_rmsnorm(x, lp["ln2"])
    return (constrain(x + rwkv_channel_mix(lp, z2)), s_new, z[:, -1:],
            z2[:, -1:])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            chunk: int = 32, remat: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """tokens (B, T) → (logits (B, T, V), the state after the last token),
    differentiable, from a zero state; the WKV in chunks of `chunk`."""
    x = embed(params["embed"], tokens)
    wkv, tms, cms = [], [], []
    for lp in params["layers"]:
        if remat:
            x, s, tm, cm = checkpoint(_train_layer, cfg, lp, x, chunk,
                                      use_reentrant=False)
        else:
            x, s, tm, cm = _train_layer(cfg, lp, x, chunk)
        wkv.append(s)
        tms.append(tm)
        cms.append(cm)
    x = train_rmsnorm(x, params["ln_f"])
    return tp_dot(x, params["lm_head"], gather=False), {
        "wkv": torch.stack(wkv), "tm_shift": torch.stack(tms),
        "cm_shift": torch.stack(cms)}


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            chunk: int = 32, remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL of the f32 log-softmax of batch["tokens"]'s
    logits at batch["labels"], weighted by batch["mask"] where given."""
    return _nll(forward(params, cfg, batch["tokens"], chunk=chunk,
                        remat=remat)[0], batch)


def _serve(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
           state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Logits (B, T, V) over tokens (B, T) through the kernels, and the
    state after the last token: `state` updated in place, or a new one
    from zeros."""
    x = embed(params["embed"], tokens)
    st = state if state is not None else init_state(
        cfg, x.shape[0], x.dtype, x.device)
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        h, s_new = rwkv_time_mix(lp, z, cfg, state=st["wkv"][i],
                                 shift_prev=st["tm_shift"][i].to(z.dtype))
        x = x + h
        z2 = rmsnorm(x, lp["ln2"])
        x = x + rwkv_channel_mix(lp, z2,
                                 shift_prev=st["cm_shift"][i].to(z2.dtype))
        st["wkv"][i] = s_new
        st["tm_shift"][i] = z[:, -1:]
        st["cm_shift"][i] = z2[:, -1:]
    x = rmsnorm(x, params["ln_f"])
    return x @ params["lm_head"], st


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int = 0) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt from a zero state; returns (last-token
    logits (B, 1, V), state). The state does not grow with the sequence,
    so `cache_len` is ignored."""
    logits, state = _serve(params, cfg, tokens)
    return logits[:, -1:], state


def decode_step(params: Params, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token (B, 1): a T=1 forward threading the recurrent state.
    Returns (logits (B, 1, V), the state, updated in place)."""
    return _serve(params, cfg, tokens, state=state)
