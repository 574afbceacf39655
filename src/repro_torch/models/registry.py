"""Uniform model API over the ported families.

`build(cfg)` returns a ModelAPI exposing init / prefill / decode / cache
over the dense transformer, the RWKV6 model (family "ssm") or the Hymba
hybrid (family "hybrid"); the reference registry's other families (MoE,
encoder-decoder) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import hybrid_model, rwkv_model, transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable        # (generator, dtype, device) -> params
    prefill: Callable            # (params, batch, cache_len) -> (logits, cache)
    decode_step: Callable        # (params, cache, batch) -> (logits, cache)
    init_cache: Callable         # (batch, seq, dtype, device) -> cache


def _dense_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cpu":
            transformer.init_params(gen, cfg, dtype, device),
        prefill=lambda params, batch, cache_len: transformer.prefill(
            params, cfg, batch["tokens"], cache_len=cache_len),
        decode_step=lambda params, cache, batch: transformer.decode_step(
            params, cfg, cache, batch["tokens"]),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cpu":
            transformer.init_cache(cfg, b, s, dtype, device),
    )


def _rwkv_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cpu":
            rwkv_model.init_params(gen, cfg, dtype, device),
        prefill=lambda params, batch, cache_len: rwkv_model.prefill(
            params, cfg, batch["tokens"], cache_len=cache_len),
        decode_step=lambda params, state, batch: rwkv_model.decode_step(
            params, cfg, state, batch["tokens"]),
        # the recurrent state does not depend on the sequence length
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cpu":
            rwkv_model.init_state(cfg, b, dtype, device),
    )


def _hybrid_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cpu":
            hybrid_model.init_params(gen, cfg, dtype, device),
        prefill=lambda params, batch, cache_len: hybrid_model.prefill(
            params, cfg, batch["tokens"], cache_len=cache_len),
        decode_step=lambda params, cache, batch: hybrid_model.decode_step(
            params, cfg, cache, batch["tokens"]),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cpu":
            hybrid_model.init_cache(cfg, b, s, dtype, device),
    )


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.n_experts or cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    if cfg.family == "ssm":
        return _rwkv_api(cfg)
    if cfg.family == "hybrid":
        return _hybrid_api(cfg)
    return _dense_api(cfg)
