"""Uniform model API over the ported families.

`build(cfg)` returns a ModelAPI exposing init / prefill / decode / cache
over the transformer (families "dense" and "moe"), the RWKV6 model
(family "ssm") or the Hymba hybrid (family "hybrid"), and the training
`forward` / `loss_fn` of the dense transformer. MoE training (ROADMAP §1
item 4), the recurrent families' training forward (item 6) and the
reference registry's encoder-decoder family are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import hybrid_model, rwkv_model, transformer
from .config import ModelConfig
from .tree import stack_layers


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable        # (generator, dtype, device) -> params
    prefill: Callable            # (params, batch, cache_len) -> (logits, cache)
    decode_step: Callable        # (params, cache, batch) -> (logits, cache)
    init_cache: Callable         # (batch, seq, dtype, device) -> cache
    loss_fn: Callable            # (params, batch, remat=) -> scalar
    forward: Callable            # (params, batch, remat=) -> logits

    def params_spec(self, dtype=torch.bfloat16) -> dict:
        """The reference's parameter tree as meta tensors (shapes and
        dtypes, nothing allocated): its layout, the layer leaves stacked
        (L, ...), bf16 by default as the reference's `params_spec`.
        `models.tree.tree_items` visits it in the reference's order."""
        return stack_layers(self.init_params(torch.Generator(), dtype,
                                             "meta"))


def _no_training(cfg: ModelConfig, what: str | None = None,
                 item: int = 6) -> Callable:
    what = what or f"the {cfg.family!r} family's training forward"

    def refuse(*args, **kw):
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP §1 item "
            f"{item}); only the dense family trains")
    return refuse


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
        loss_fn=lambda params, batch, **kw: transformer.loss_fn(
            params, cfg, batch, **kw),
        forward=lambda params, batch, **kw: transformer.forward(
            params, cfg, batch["tokens"], **kw),
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
        loss_fn=_no_training(cfg),
        forward=_no_training(cfg),
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
        loss_fn=_no_training(cfg),
        forward=_no_training(cfg),
    )


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    if cfg.family == "ssm":
        return _rwkv_api(cfg)
    if cfg.family == "hybrid":
        return _hybrid_api(cfg)
    if cfg.n_experts:
        # MoE serves through the transformer's API and does not train
        refuse = _no_training(cfg, "MoE training (the expert-parallel "
                              "dispatch in the trainer)", item=4)
        return dataclasses.replace(_dense_api(cfg), loss_fn=refuse,
                                   forward=refuse)
    return _dense_api(cfg)
