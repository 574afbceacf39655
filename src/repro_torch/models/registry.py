"""Uniform model API over the ported families.

`build(cfg)` returns a ModelAPI exposing init / prefill / decode / cache
and the training `forward` / `loss_fn` over the transformer (families
"dense", "moe" and "vlm"; `loss_fn_ep`, the MoE family's expert-parallel
loss of every rank of a local mesh at once), the RWKV6 model (family
"ssm"), the Hymba hybrid (family "hybrid") or the encoder-decoder
(family "audio"), with the reference registry's return shapes and batch
keys: `forward` gives the logits; a vlm batch carries "embeds" and
"mrope_positions" (decode: "embeds" alone) where the others carry
"tokens", an audio batch "frames" beside "tokens". `train_specs`,
`prefill_specs` and `decode_specs` are the reference's per-cell input
specs as meta tensors, `params_spec` / `meta_params` the parameters so.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import encdec, hybrid_model, rwkv_model, transformer
from .config import ModelConfig, ShapeConfig
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
    # (per-rank params, per-rank batches, mesh=, remat=) -> per-rank losses
    loss_fn_ep: Callable | None = None

    def params_spec(self, dtype=torch.bfloat16) -> dict:
        """The reference's parameter tree as meta tensors (shapes and
        dtypes, nothing allocated): its layout, the layer leaves stacked
        (L, ...), bf16 by default as the reference's `params_spec`.
        `models.tree.tree_items` visits it in the reference's order."""
        return stack_layers(self.meta_params(dtype))

    def meta_params(self, dtype=torch.bfloat16) -> dict:
        """The parameters in the port's own layout (per-layer lists), as
        meta tensors: what prefill and decode take, with no full-size
        leaf drawn."""
        return self.init_params(torch.Generator(), dtype, "meta")

    # -- the reference's per-cell input specs, as meta tensors: its shapes
    # and float dtypes; integer inputs int64, as `launch.train.
    # batch_tensors` gives them ---------------------------------------------
    def train_specs(self, shape: ShapeConfig) -> dict:
        B, T = shape.global_batch, shape.seq_len
        batch = {"labels": _meta((B, T), torch.long)}
        return {**batch, **self._inputs(B, T)}

    def prefill_specs(self, shape: ShapeConfig) -> dict:
        return self._inputs(shape.global_batch, shape.seq_len)

    def decode_specs(self, shape: ShapeConfig) -> dict:
        """{"batch": one token a row (a vlm: its embedding row), "cache":
        the family's cache of `shape.seq_len` slots}."""
        B, S = shape.global_batch, shape.seq_len
        batch = ({"embeds": _meta((B, 1, self.cfg.d_model), torch.bfloat16)}
                 if self.cfg.family == "vlm"
                 else {"tokens": _meta((B, 1), torch.long)})
        return {"batch": batch,
                "cache": self.init_cache(B, S, torch.bfloat16, "meta")}

    def _inputs(self, B: int, T: int) -> dict:
        cfg = self.cfg
        if cfg.family == "vlm":
            return {"embeds": _meta((B, T, cfg.d_model), torch.bfloat16),
                    "mrope_positions": _meta((3, B, T), torch.long)}
        batch = {"tokens": _meta((B, T), torch.long)}
        if cfg.family == "audio":
            batch["frames"] = _meta((B, encdec.N_AUDIO_FRAMES, cfg.d_model),
                                    torch.bfloat16)
        return batch


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dense_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cpu":
            transformer.init_params(gen, cfg, dtype, device),
        prefill=lambda params, batch, cache_len: transformer.prefill(
            params, cfg, batch.get("tokens"), cache_len=cache_len,
            embeds=batch.get("embeds"),
            mrope_positions=batch.get("mrope_positions")),
        decode_step=lambda params, cache, batch: transformer.decode_step(
            params, cfg, cache, batch.get("tokens"),
            embeds=batch.get("embeds")),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cpu":
            transformer.init_cache(cfg, b, s, dtype, device),
        loss_fn=lambda params, batch, **kw: transformer.loss_fn(
            params, cfg, batch, **kw),
        forward=lambda params, batch, **kw: transformer.forward(
            params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
            mrope_positions=batch.get("mrope_positions"), **kw),
        loss_fn_ep=(lambda params, batches, **kw: transformer.loss_fn_ep(
            params, cfg, batches, **kw)) if cfg.n_experts else None,
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
        loss_fn=lambda params, batch, **kw: rwkv_model.loss_fn(
            params, cfg, batch, **kw),
        forward=lambda params, batch, **kw: rwkv_model.forward(
            params, cfg, batch["tokens"], **kw)[0],
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
        loss_fn=lambda params, batch, **kw: hybrid_model.loss_fn(
            params, cfg, batch, **kw),
        forward=lambda params, batch, **kw: hybrid_model.forward(
            params, cfg, batch["tokens"], **kw),
    )


def _encdec_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, dtype=torch.bfloat16, device="cpu":
            encdec.init_params(gen, cfg, dtype, device),
        prefill=lambda params, batch, cache_len: encdec.prefill(
            params, cfg, batch["tokens"], frames=batch["frames"],
            cache_len=cache_len),
        decode_step=lambda params, cache, batch: encdec.decode_step(
            params, cfg, cache, batch["tokens"]),
        init_cache=lambda b, s, dtype=torch.bfloat16, device="cpu":
            encdec.init_cache(cfg, b, s, dtype, device),
        loss_fn=lambda params, batch, **kw: encdec.loss_fn(
            params, cfg, batch, **kw),
        forward=lambda params, batch, **kw: encdec.forward(
            params, cfg, batch["tokens"], frames=batch["frames"], **kw),
    )


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported")
    if cfg.family == "ssm":
        return _rwkv_api(cfg)
    if cfg.family == "hybrid":
        return _hybrid_api(cfg)
    if cfg.family == "audio":
        return _encdec_api(cfg)
    # dense / moe / vlm share the decoder stack
    return _dense_api(cfg)
