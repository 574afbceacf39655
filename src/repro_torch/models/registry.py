"""Uniform model API (dense family).

`build(cfg)` returns a ModelAPI exposing init / prefill / decode / cache
over the dense transformer; the other families of the reference registry
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import transformer
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


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return _dense_api(cfg)
