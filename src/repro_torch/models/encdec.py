"""Whisper-style encoder-decoder (whisper-large-v3): init, KV cache,
prefill, decode.

Mirrors the reference `models/encdec.py`. The conv/mel frontend is a
stub there too: the caller gives precomputed frame embeddings (B, T_audio,
D). The encoder is bidirectional (non-causal attention with RoPE at the
frame positions), then `ln_enc`; the decoder is causal self-attention,
cross-attention to the encoder states, and a SwiGLU MLP. Norms and
self-attention go through the kernel wrappers (`layers.rmsnorm`,
`layers.attention` / `_attend`, `attention_decode`); cross-attention has
no kernel in the reference (f32 einsums and a softmax) and is torch ops
here, in its order and dtypes.

The reference stacks each stack's layers on a leading (L,) axis; here
`params["encoder"]` and `params["decoder"]` are lists of per-layer dicts
(`convert.params_from_jax` splits the reference's). Prefill computes a
decoder layer's q, k and v once (the reference projects K/V twice). The
decode state is the self-attention cache plus each layer's
cross-attention K/V of the encoder output, computed once at prefill.

`forward` and `loss_fn` are the training path, the reference's in
differentiable torch ops (`layers.train_rmsnorm`, `layers.
train_attention`: non-causal in the encoder, causal in the decoder;
cross-attention as served), each encoder and decoder layer under
activation checkpointing when `remat` is set, as the reference's
`jax.checkpoint` bodies. The stub frames come in f32, so the encoder
runs in f32 against widened bf16 weights (`layers.matmul`, the
reference's promotion), and the decoder in the weights' dtype.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .actsharding import constrain
from .config import ModelConfig
from .layers import (Params, _attend, _qkv, attention, attention_decode,
                     dense_init, embed, init_attention, init_mlp, matmul,
                     mlp, rmsnorm, train_attention, train_rmsnorm)
from .transformer import _nll

N_AUDIO_FRAMES = 1500   # whisper: 30 s of audio → 1500 frames post-conv


def _init_cross(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dtype,
                         device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype,
                         device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dtype,
                         device=device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dtype,
                         device=device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights drawn from `gen` (a generator on `device`), the
    reference's leaves: per encoder layer ln1, ln2, attn, mlp; per
    decoder layer ln1, ln_x, ln2, attn, xattn, mlp; ln_enc, ln_f, embed,
    lm_head."""
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def enc_layer() -> Params:
        return {"ln1": zeros(d), "ln2": zeros(d),
                "attn": init_attention(gen, cfg, dtype, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}

    def dec_layer() -> Params:
        return {"ln1": zeros(d), "ln_x": zeros(d), "ln2": zeros(d),
                "attn": init_attention(gen, cfg, dtype, device),
                "xattn": _init_cross(gen, cfg, dtype, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device)}

    return {
        "encoder": [enc_layer() for _ in range(cfg.n_encoder_layers)],
        "decoder": [dec_layer() for _ in range(cfg.n_layers)],
        "ln_enc": zeros(d),
        "ln_f": zeros(d),
        "embed": dense_init(gen, (cfg.vocab, d), scale=0.02, dtype=dtype,
                            device=device),
        "lm_head": dense_init(gen, (d, cfg.vocab), dtype=dtype,
                              device=device),
    }


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, T_audio, D) stub embeddings → encoder states."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["encoder"]:
        x = x + attention(lp["attn"], rmsnorm(x, lp["ln1"]), cfg,
                          causal=False, positions=positions)
        x = constrain(x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"])))
    return rmsnorm(x, params["ln_enc"])


def _cross_kv(xp: Params, enc: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, Hkv, Te, hd) cross-attention K/V of the encoder states."""
    B, Te, _ = enc.shape
    hd = cfg.head_dim
    k = matmul(enc, xp["wk"]).reshape(B, Te, cfg.n_kv_heads, hd)
    v = matmul(enc, xp["wv"]).reshape(B, Te, cfg.n_kv_heads, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_attend(xp: Params, z: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """z: (B, T, D) queries; xk/xv: (B, Hkv, Te, hd) precomputed. Every
    query sees every frame; scores, softmax and the weighted sum in f32,
    as the reference's."""
    B, T, _ = z.shape
    hd = cfg.head_dim
    q = matmul(z, xp["wq"]).reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    rep = cfg.n_heads // cfg.n_kv_heads
    k = xk.repeat_interleave(rep, dim=1) if rep > 1 else xk
    v = xv.repeat_interleave(rep, dim=1) if rep > 1 else xv
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    o = o.to(z.dtype).transpose(1, 2).reshape(B, T, -1)
    return matmul(o, xp["wo"])


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------
def _train_enc_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    x = x + train_attention(lp["attn"], train_rmsnorm(x, lp["ln1"]), cfg,
                            causal=False, positions=positions)
    return constrain(x + mlp(lp["mlp"], train_rmsnorm(x, lp["ln2"])))


def _train_dec_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     enc: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
    x = x + train_attention(lp["attn"], train_rmsnorm(x, lp["ln1"]), cfg,
                            positions=positions)
    xk, xv = _cross_kv(lp["xattn"], enc, cfg)
    x = x + _cross_attend(lp["xattn"], train_rmsnorm(x, lp["ln_x"]), xk, xv,
                          cfg)
    return constrain(x + mlp(lp["mlp"], train_rmsnorm(x, lp["ln2"])))


def _run(block, cfg: ModelConfig, layers: list, x: torch.Tensor,
         *args, remat: bool) -> torch.Tensor:
    for lp in layers:
        x = (checkpoint(block, cfg, lp, x, *args, use_reentrant=False)
             if remat else block(cfg, lp, x, *args))
    return x


def train_encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                 remat: bool = True) -> torch.Tensor:
    """The reference's `encode`, differentiable: frames (B, T_audio, D)
    → encoder states, in the frames' dtype."""
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = _run(_train_enc_block, cfg, params["encoder"], frames, positions,
             remat=remat)
    return train_rmsnorm(x, params["ln_enc"])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor, remat: bool = True, **_kw) -> torch.Tensor:
    """Teacher-forced training forward, differentiable: audio frames (B,
    T_audio, D) and decoder tokens (B, T) → logits (B, T, V)."""
    enc = train_encode(params, cfg, frames, remat=remat)
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _run(_train_dec_block, cfg, params["decoder"], x, enc, positions,
             remat=remat)
    return matmul(train_rmsnorm(x, params["ln_f"]), params["lm_head"],
                  gather=False)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, **kw
            ) -> torch.Tensor:
    """Mean next-token NLL of batch["tokens"]' logits given
    batch["frames"], at batch["labels"] (weighted by batch["mask"])."""
    return _nll(forward(params, cfg, batch["tokens"], frames=batch["frames"],
                        **kw), batch)


def _self_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
                device) -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.long, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """The decode state's layout: self-attention K/V (L, B, Hkv, seq,
    hd), cross-attention K/V (L, B, Hkv, N_AUDIO_FRAMES, hd), positions.
    `prefill` builds its own, with the cross K/V of the frames given."""
    cache = _self_cache(cfg, batch, seq, dtype, device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, N_AUDIO_FRAMES,
             cfg.head_dim)
    cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor, cache_len: int
            ) -> tuple[torch.Tensor, dict]:
    """Encode `frames` (B, T_audio, D), then run the decoder over the
    prompt `tokens` (B, T), recording its K/V into a fresh cache of
    `cache_len` slots and each layer's cross K/V of the encoder states.
    Returns (last-token logits (B, 1, V), cache)."""
    enc = encode(params, cfg, frames)
    x = embed(params["embed"], tokens)
    B, T, _ = x.shape
    if T > cache_len:
        raise ValueError(f"prompt of {T} tokens exceeds cache_len "
                         f"{cache_len}")
    positions = torch.arange(T, device=x.device)[None, :]
    cache = _self_cache(cfg, B, cache_len, x.dtype, x.device)
    xks, xvs = [], []
    for i, lp in enumerate(params["decoder"]):
        z = rmsnorm(x, lp["ln1"])
        q, k, v = _qkv(lp["attn"], z, cfg, positions)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
        x = x + _attend(q, k, v, cfg) @ lp["attn"]["wo"]
        xk, xv = _cross_kv(lp["xattn"], enc, cfg)
        xks.append(xk)
        xvs.append(xv)
        x = x + _cross_attend(lp["xattn"], rmsnorm(x, lp["ln_x"]), xk, xv,
                              cfg)
        x = constrain(x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"])))
    cache["xk"] = torch.stack(xks)
    cache["xv"] = torch.stack(xvs)
    cache["pos"].fill_(T)
    x = rmsnorm(x[:, -1:], params["ln_f"])
    return x @ params["lm_head"], cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache, its self-attention K/V updated in place)."""
    x = embed(params["embed"], tokens)
    pos = cache["pos"]
    kv_len = pos + 1
    for i, lp in enumerate(params["decoder"]):
        z = rmsnorm(x, lp["ln1"])
        x = x + attention_decode(lp["attn"], z, cache["k"][i],
                                 cache["v"][i], pos, cfg, kv_len=kv_len)
        x = x + _cross_attend(lp["xattn"], rmsnorm(x, lp["ln_x"]),
                              cache["xk"][i], cache["xv"][i], cfg)
        x = constrain(x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"])))
    cache["pos"] = kv_len
    x = rmsnorm(x, params["ln_f"])
    return x @ params["lm_head"], cache
