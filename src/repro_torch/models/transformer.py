"""Dense decoder-only transformer: init, KV cache, prefill, decode.

Mirrors the dense family of the reference `models/transformer.py`. The
reference stacks every layer's parameters on a leading (L,) axis and
scans; here `params["layers"]` is a list of per-layer dicts run by a
Python loop (`convert.params_from_jax` unstacks the reference's layout).
The KV cache keeps the reference's (L, B, Hkv, S, hd) layout and is
updated in place by `decode_step`.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (Params, _attend, _check_supported, _qkv,
                     attention_decode, dense_init, embed, init_attention,
                     init_mlp, mlp, rmsnorm)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts or cfg.family not in ("dense",):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (got "
            f"family={cfg.family!r}, n_experts={cfg.n_experts})")
    _check_supported(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights drawn from `gen` (a generator on `device`)."""
    _check_dense(cfg)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = [{"ln1": zeros(d), "ln2": zeros(d),
               "attn": init_attention(gen, cfg, dtype, device),
               "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}
              for _ in range(cfg.n_layers)]
    p: Params = {
        "layers": layers,
        "ln_f": zeros(d),
        "embed": dense_init(gen, (cfg.vocab, d), scale=0.02, dtype=dtype,
                            device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (d, cfg.vocab), dtype=dtype,
                                  device=device)
    return p


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rmsnorm(x, params["ln_f"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap > 0:
        logits = (torch.tanh(logits.float() / cfg.final_softcap)
                  * cfg.final_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# KV cache + prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.long, device=device),
    }


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt (B, T), recording K/V into a fresh cache of
    `cache_len` slots. Returns (last-token logits (B, 1, V), cache)."""
    _check_dense(cfg)
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
        h = _attend(q, k, v, cfg, window=cfg.window_for_layer(i))
        x = x + h @ lp["attn"]["wo"]
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"]))
    cache["pos"].fill_(T)
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache, updated in place)."""
    x = embed(params["embed"], tokens)
    pos = cache["pos"]
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        x = x + attention_decode(lp["attn"], z, cache["k"][i],
                                 cache["v"][i], pos, cfg,
                                 window=cfg.window_for_layer(i))
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"]))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
