"""Hymba-style hybrid: every layer runs attention heads and a Mamba SSM
branch in parallel on the same input, normalizes each branch's output and
averages them (arXiv:2411.13676; meta-tokens omitted, as in the
reference).

Mirrors the reference `models/hybrid_model.py`. `params["layers"]` is a
list of per-layer dicts run by a Python loop; each layer's sliding window
is `cfg.window_for_layer(i)`. The decode state is the KV cache in the
reference's (L, B, Hkv, S, hd) layout plus the per-layer (B, Di, N) SSM
state, updated in place by `decode_step`.

`forward` and `loss_fn` are the training path: differentiable torch ops
(`layers.train_attention`, `recurrence.train_mamba_ssm`, the
chunk-checkpointed scan, `layers.train_rmsnorm`), each layer under
activation checkpointing when `remat` is set, as the reference's
`jax.checkpoint` body. Prefill and decode serve through the kernels.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .actsharding import constrain
from .config import ModelConfig
from .layers import (Params, _attend, _qkv, attention_decode, dense_init,
                     embed, init_attention, init_mlp, mlp, rmsnorm,
                     tp_dot, train_attention, train_rmsnorm)
from .recurrence import init_mamba, mamba_ssm, train_mamba_ssm
from .transformer import _nll


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights drawn from `gen` (a generator on `device`)."""
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    layers = [{"ln1": zeros(), "ln2": zeros(), "ln_attn": zeros(),
               "ln_ssm": zeros(),
               "attn": init_attention(gen, cfg, dtype, device),
               "ssm": init_mamba(gen, cfg, dtype, device),
               "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}
              for _ in range(cfg.n_layers)]
    return {
        "layers": layers,
        "ln_f": zeros(),
        "embed": dense_init(gen, (cfg.vocab, d), scale=0.02, dtype=dtype,
                            device=device),
        "lm_head": dense_init(gen, (d, cfg.vocab), dtype=dtype,
                              device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    hd = cfg.head_dim
    di = cfg.ssm_expand * cfg.d_model
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, seq, hd)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, di, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.long, device=device),
    }


def _combine(lp: Params, a: torch.Tensor, s: torch.Tensor, norm=rmsnorm
             ) -> torch.Tensor:
    """Mean of the two branches, each RMS-normalized, summed in f32."""
    a = norm(a, lp["ln_attn"])
    s = norm(s, lp["ln_ssm"])
    return ((a.float() + s.float()) * 0.5).to(a.dtype)


def _train_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int,
                 positions: torch.Tensor, ssm_chunk: int) -> torch.Tensor:
    z = train_rmsnorm(x, lp["ln1"])
    a = train_attention(lp["attn"], z, cfg, window=window,
                        positions=positions)
    s, _ = train_mamba_ssm(lp["ssm"], z, cfg, chunk=ssm_chunk)
    x = x + _combine(lp, a, s, norm=train_rmsnorm)
    return constrain(x + mlp(lp["mlp"], train_rmsnorm(x, lp["ln2"])))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = True, ssm_chunk: int = 16) -> torch.Tensor:
    """tokens (B, T) → logits (B, T, V), differentiable; the SSM scan
    checkpointed in chunks of `ssm_chunk`."""
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in enumerate(params["layers"]):
        w = cfg.window_for_layer(i)
        if remat:
            x = checkpoint(_train_layer, cfg, lp, x, w, positions, ssm_chunk,
                           use_reentrant=False)
        else:
            x = _train_layer(cfg, lp, x, w, positions, ssm_chunk)
    x = train_rmsnorm(x, params["ln_f"])
    return tp_dot(x, params["lm_head"], gather=False)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, ssm_chunk: int = 16) -> torch.Tensor:
    """Mean next-token NLL of the f32 log-softmax of batch["tokens"]'s
    logits at batch["labels"], weighted by batch["mask"] where given."""
    return _nll(forward(params, cfg, batch["tokens"], remat=remat,
                        ssm_chunk=ssm_chunk), batch)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt (B, T), recording K/V and the SSM states
    into a fresh cache of `cache_len` slots. Returns (last-token logits
    (B, 1, V), cache)."""
    x = embed(params["embed"], tokens)
    B, T, _ = x.shape
    if T > cache_len:
        raise ValueError(f"prompt of {T} tokens exceeds cache_len "
                         f"{cache_len}")
    positions = torch.arange(T, device=x.device)[None, :]
    cache = init_cache(cfg, B, cache_len, x.dtype, x.device)
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(lp["attn"], z, cfg, positions)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
        a = _attend(q, k, v, cfg, window=cfg.window_for_layer(i)) \
            @ lp["attn"]["wo"]
        s, cache["ssm"][i] = mamba_ssm(lp["ssm"], z, cfg)
        x = x + _combine(lp, a, s)
        x = constrain(x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"])))
    cache["pos"].fill_(T)
    x = rmsnorm(x[:, -1:], params["ln_f"])
    return x @ params["lm_head"], cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache, updated in place)."""
    x = embed(params["embed"], tokens)
    pos = cache["pos"]
    kv_len = pos + 1
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        a = attention_decode(lp["attn"], z, cache["k"][i], cache["v"][i],
                             pos, cfg, window=cfg.window_for_layer(i),
                             kv_len=kv_len)
        s, cache["ssm"][i] = mamba_ssm(lp["ssm"], z, cfg,
                                       state=cache["ssm"][i])
        x = x + _combine(lp, a, s)
        x = constrain(x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"])))
    cache["pos"] = kv_len
    x = rmsnorm(x, params["ln_f"])
    return x @ params["lm_head"], cache
