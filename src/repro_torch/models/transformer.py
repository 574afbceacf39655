"""Decoder-only transformer, dense, MoE and vision-language: init,
training forward and loss, KV cache, prefill, decode.

Mirrors the dense, MoE and vlm families of the reference
`models/transformer.py`: a MoE layer (`layers.moe`) stands where the
dense layer's MLP does, in prefill and decode, with the reference's
`moe_dispatch`. The vlm family (qwen2-vl-7b) takes embeddings in place of
token ids (`embeds`, from a stubbed vision frontend) and rotates by
M-RoPE where the prefill is given (t, h, w) position streams
(`mrope_positions`); its decode takes the embedding rows of the last
token and, as the reference's, plain RoPE at the cache position; its
training forward takes the embeddings and position streams as the
reference's does, its f32 embeddings keeping the residual stream in
f32 (`layers.matmul` widens the bf16 weights at each product), and its
unused `embed` gets no gradient. The reference stacks every layer's
parameters on a leading (L,) axis and scans; here `params["layers"]` is a list of per-layer dicts run by a
Python loop (`convert.params_from_jax` unstacks the reference's
layout). The KV cache keeps the reference's (L, B, Hkv, S, hd) layout and is
updated in place by `decode_step`.

`forward` and `loss_fn` are the training path: differentiable torch ops
throughout (`layers.train_rmsnorm`, `layers.train_attention`, the MoE
layer's torch ops), each layer under activation checkpointing when
`remat` is set, as the reference's `jax.checkpoint` body. `forward_ep` /
`loss_fn_ep` run every rank of the trainer's local mesh layer by layer
in one graph, for the expert-parallel dispatch (`layers.moe_ep`), whose
exchange needs every rank's buffer at once. Prefill and decode serve
through the kernels.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .actsharding import constrain, tp_context
from .config import ModelConfig
from .layers import (Params, _attend, _qkv, attention_decode, dense_init,
                     embed, init_attention, init_mlp, init_moe, matmul, mlp,
                     moe, moe_ep, rmsnorm, train_attention, train_rmsnorm)


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the dense, MoE and vlm families are ported here "
            f"(got family={cfg.family!r}, n_experts={cfg.n_experts})")


def _ffn(lp: Params, cfg: ModelConfig, z: torch.Tensor,
         moe_dispatch: str) -> torch.Tensor:
    if cfg.n_experts:
        return moe(lp["moe"], z, cfg, dispatch=moe_dispatch)
    return mlp(lp["mlp"], z)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights drawn from `gen` (a generator on `device`); a MoE
    layer's `"moe"` stands where a dense layer's `"mlp"` does."""
    _check_served(cfg)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer() -> Params:
        lp = {"ln1": zeros(d), "ln2": zeros(d),
              "attn": init_attention(gen, cfg, dtype, device)}
        if cfg.n_experts:
            lp["moe"] = init_moe(gen, cfg, dtype, device)
        else:
            lp["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
        return lp

    layers = [layer() for _ in range(cfg.n_layers)]
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


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            norm=rmsnorm) -> torch.Tensor:
    x = norm(x, params["ln_f"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = matmul(x, head, gather=False)
    if cfg.final_softcap > 0:
        logits = (torch.tanh(logits.float() / cfg.final_softcap)
                  * cfg.final_softcap).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------
def _train_attn(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int,
                positions: torch.Tensor,
                mrope_positions: torch.Tensor | None = None) -> torch.Tensor:
    return x + train_attention(lp["attn"], train_rmsnorm(x, lp["ln1"]), cfg,
                               window=window, positions=positions,
                               mrope_positions=mrope_positions)


def _train_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int,
                 positions: torch.Tensor,
                 mrope_positions: torch.Tensor | None = None,
                 moe_dispatch: str = "sorted") -> torch.Tensor:
    x = _train_attn(cfg, lp, x, window, positions, mrope_positions)
    return constrain(x + _ffn(lp, cfg, train_rmsnorm(x, lp["ln2"]),
                              moe_dispatch))


def _train_block_ep(cfg: ModelConfig, lps: Sequence[Params],
                    xs: Sequence[torch.Tensor], window: int,
                    positions: torch.Tensor, mesh) -> list[torch.Tensor]:
    """One layer on every rank of `mesh`: each rank's attention, then one
    `moe_ep` over all of them."""
    xs = [_train_attn(cfg, lp, x, window, positions)
          for lp, x in zip(lps, xs)]
    fs = moe_ep([lp["moe"] for lp in lps],
                [train_rmsnorm(x, lp["ln2"]) for lp, x in zip(lps, xs)],
                cfg, mesh=mesh)
    return [x + f for x, f in zip(xs, fs)]


def _embed_in(params: Params, cfg: ModelConfig, tokens: torch.Tensor
              ) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    if cfg.family == "dense" and cfg.tie_embeddings:
        x = x * (cfg.d_model ** 0.5)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor | None,
            *, embeds: torch.Tensor | None = None,
            mrope_positions: torch.Tensor | None = None,
            moe_dispatch: str = "sorted", remat: bool = True
            ) -> torch.Tensor:
    """tokens (B, T) — or embeddings `embeds` (B, T, D) as they are, in
    their dtype, M-RoPE'd at `mrope_positions` (3, B, T) where the config
    has sections — → logits (B, T, V), differentiable. A tied embedding
    is scaled by √d_model in the dense family, as the reference's
    `forward` does (its `prefill` and `decode_step` do not). A MoE layer
    dispatches by `moe_dispatch` ("sorted", "dense", "ep", "local"; see
    `layers.moe`: on one rank "ep" is the sorted block without groups;
    one rank of a process mesh exchanges under the trainer's EP
    context). With `remat` each layer is checkpointed; under "ep" with
    early stop off, as `forward_ep`'s, so the backward recomputes a
    layer's exchanges in full on every rank alike."""
    _check_served(cfg)
    x = _embed_in(params, cfg, tokens) if embeds is None else embeds
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in enumerate(params["layers"]):
        w = cfg.window_for_layer(i)
        if remat:
            with (set_checkpoint_early_stop(False) if moe_dispatch == "ep"
                  else contextlib.nullcontext()):
                x = checkpoint(_train_block, cfg, lp, x, w, positions,
                               mrope_positions, moe_dispatch,
                               use_reentrant=False)
        else:
            x = _train_block(cfg, lp, x, w, positions, mrope_positions,
                             moe_dispatch)
    return _logits(params, cfg, x, norm=train_rmsnorm)


def forward_ep(params: Sequence[Params], cfg: ModelConfig,
               tokens: Sequence[torch.Tensor], *, mesh,
               remat: bool = True) -> list[torch.Tensor]:
    """The reference's `forward(moe_dispatch="ep")` of every rank of the
    local mesh `mesh` (an int n, or the live (axis, size) pairs, ranks in
    row-major order) in one graph, layer by layer: params[r] and
    tokens[r] are rank r's leaves and (B, T) tokens; each MoE layer runs
    `layers.moe_ep` over all ranks under the active EPContext. With
    `remat` each layer is checkpointed over all ranks at once, the
    exchanges inside, as the reference's `jax.checkpoint` layer body: the
    backward recomputes each layer in full (early stop off), so a
    layer's exchanges run in the forward, again in the recompute and
    once each as a transpose. Returns the ranks' logits."""
    _check_served(cfg)
    if not cfg.n_experts:
        raise ValueError(f"{cfg.name}: forward_ep runs the MoE family")
    xs = [_embed_in(p, cfg, t) for p, t in zip(params, tokens)]
    positions = torch.arange(xs[0].shape[1], device=xs[0].device)[None, :]
    for i in range(cfg.n_layers):
        lps = [p["layers"][i] for p in params]
        w = cfg.window_for_layer(i)
        if remat:
            with set_checkpoint_early_stop(False):
                xs = checkpoint(_train_block_ep, cfg, lps, xs, w, positions,
                                mesh, use_reentrant=False)
        else:
            xs = _train_block_ep(cfg, lps, xs, w, positions, mesh)
    return [_logits(p, cfg, x, norm=train_rmsnorm)
            for p, x in zip(params, xs)]


def _nll(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The masked mean NLL of the f32 log-softmax of `logits` at
    batch["labels"]. Logits that are this rank's slice of the vocabulary
    (`actsharding.TPContext.vocab_slice`) take the vocabulary-parallel
    form: the rows' max and sum of exponentials over the "model" line,
    each label's logit from the rank that holds it."""
    labels = batch["labels"].long()
    ctx = tp_context()
    start = None if ctx is None else ctx.vocab_slice(logits)
    if start is None:
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
    else:
        nll = _nll_vocab_parallel(ctx, logits.float(), labels, start)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _nll_vocab_parallel(ctx, lf: torch.Tensor, labels: torch.Tensor,
                        start: int) -> torch.Tensor:
    """−log softmax(logits)[label] of f32 logits `lf` whose last dim is
    entries [start, start + n) of the vocabulary: max + log Σ exp(l − max)
    − l[label], the max and the sum over the line's slices, the label's
    logit summed over the line from the one rank that holds it."""
    from repro_torch.core.transport import all_gather_rows
    n = lf.shape[-1]
    with torch.no_grad():
        m = all_gather_rows(ctx.mesh, ctx.line,
                            lf.amax(dim=-1)).amax(dim=0)[..., None]
    se = ctx.reduce(torch.exp(lf - m).sum(dim=-1))
    local = labels - start
    held = (local >= 0) & (local < n)
    picked = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = ctx.reduce(torch.where(held, picked, 0.0))
    return torch.log(se) + m[..., 0] - picked


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            moe_dispatch: str = "sorted", remat: bool = True
            ) -> torch.Tensor:
    """Mean next-token NLL of the f32 log-softmax of the logits of
    batch["tokens"] (or of batch["embeds"] at batch["mrope_positions"])
    at batch["labels"], weighted by batch["mask"] where given."""
    return _nll(forward(params, cfg, batch.get("tokens"),
                        embeds=batch.get("embeds"),
                        mrope_positions=batch.get("mrope_positions"),
                        moe_dispatch=moe_dispatch, remat=remat), batch)


def loss_fn_ep(params: Sequence[Params], cfg: ModelConfig,
               batches: Sequence[dict], *, mesh, remat: bool = True
               ) -> list[torch.Tensor]:
    """Every rank's `loss_fn` under the expert-parallel dispatch, in one
    graph (`forward_ep`); one backward of their sum gives each rank's
    leaves the cotangent the reference's per-device `value_and_grad`
    gives them, the exchanges' transposes carrying the other ranks'
    share."""
    logits = forward_ep(params, cfg, [b["tokens"] for b in batches],
                        mesh=mesh, remat=remat)
    return [_nll(lg, b) for lg, b in zip(logits, batches)]


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


def _embed_or(params: Params, tokens: torch.Tensor | None,
              embeds: torch.Tensor | None) -> torch.Tensor:
    """The rows of `tokens`, or `embeds` as they are where given."""
    return embed(params["embed"], tokens) if embeds is None else embeds


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor | None,
            *, cache_len: int, embeds: torch.Tensor | None = None,
            mrope_positions: torch.Tensor | None = None,
            moe_dispatch: str = "sorted") -> tuple[torch.Tensor, dict]:
    """Forward over the prompt (B, T) — or its embeddings `embeds` (B, T,
    D), M-RoPE'd at `mrope_positions` (3, B, T) where the config has
    sections — recording K/V into a fresh cache of `cache_len` slots.
    Returns (last-token logits (B, 1, V), cache)."""
    _check_served(cfg)
    x = _embed_or(params, tokens, embeds)
    B, T, _ = x.shape
    if T > cache_len:
        raise ValueError(f"prompt of {T} tokens exceeds cache_len "
                         f"{cache_len}")
    positions = torch.arange(T, device=x.device)[None, :]
    cache = init_cache(cfg, B, cache_len, x.dtype, x.device)
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(lp["attn"], z, cfg, positions,
                       mrope_positions=mrope_positions)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
        h = _attend(q, k, v, cfg, window=cfg.window_for_layer(i))
        x = x + h @ lp["attn"]["wo"]
        x = constrain(x + _ffn(lp, cfg, rmsnorm(x, lp["ln2"]),
                               moe_dispatch))
    cache["pos"].fill_(T)
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor | None, *,
                embeds: torch.Tensor | None = None,
                moe_dispatch: str = "sorted") -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1), or embeds (B, 1, D) where given.
    Returns (logits (B, 1, V), the cache, updated in place)."""
    x = _embed_or(params, tokens, embeds)
    pos = cache["pos"]
    kv_len = pos + 1
    for i, lp in enumerate(params["layers"]):
        z = rmsnorm(x, lp["ln1"])
        x = x + attention_decode(lp["attn"], z, cache["k"][i],
                                 cache["v"][i], pos, cfg,
                                 window=cfg.window_for_layer(i),
                                 kv_len=kv_len)
        x = constrain(x + _ffn(lp, cfg, rmsnorm(x, lp["ln2"]),
                               moe_dispatch))
    cache["pos"] = kv_len
    return _logits(params, cfg, x), cache
