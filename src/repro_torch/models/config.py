"""Model + shape configuration schema for all assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 → d_model // n_heads
    # --- attention features ---
    qk_norm: bool = False
    attn_softcap: float = 0.0        # gemma2 logit softcap
    final_softcap: float = 0.0       # gemma2 final-logit softcap
    window_pattern: tuple[int, ...] = (0,)   # per-layer sliding windows,
    #                                          cycled over layers; 0 = global
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl (t, h, w)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2              # mamba inner expansion
    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    encoder_bidir: bool = True
    # --- embedding frontend stub (vlm/audio) ---
    embeds_input: bool = False       # forward takes embeddings, not token ids
    tie_embeddings: bool = False
    # --- perf knobs (hillclimbed in EXPERIMENTS.md §Perf) ---
    attn_kv_block: int = 0           # >0: online-softmax scan over KV blocks
    #                                  (flash in XLA — bounds materialized
    #                                  logits to block_q × attn_kv_block)
    moe_groups: int = 0              # >0: block the MoE dispatch into G
    #                                  DP-local groups (per-group argsort +
    #                                  capacity) so the expert buffers shard
    #                                  instead of replicating
    moe_local: bool = False          # shard_map the dispatch over the DP
    #                                  axes (device-local sort + explicit
    #                                  ZeRO weight gather)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def window_for_layer(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def params_count(self) -> int:
        """Total parameter count (embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.family == "ssm":
            # rwkv6: time-mix r/k/v/g/out (5 d²) + decay LoRA + channel mix
            per_layer = 5 * d * d + 2 * d * 64 + (2 * d * f + d * d)
        elif self.n_experts:
            shared = self.n_shared_experts * 3 * d * self.d_ff_expert
            routed = self.n_experts * 3 * d * self.d_ff_expert
            per_layer = attn + shared + routed + d * self.n_experts
        else:
            per_layer = attn + 3 * d * f
        if self.family == "hybrid":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + di * self.ssm_state * 2 + di
        n = self.n_layers * per_layer
        if self.is_encdec:
            enc_attn = 4 * d * d
            n += self.n_encoder_layers * (enc_attn + 2 * d * f)
            n += self.n_layers * attn                 # cross attention
        n += v * d * (1 if self.tie_embeddings else 2)
        return n

    def active_params_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if not self.n_experts:
            return self.params_count()
        d = self.d_model
        dense_moe = self.n_experts * 3 * d * self.d_ff_expert
        active_moe = (self.top_k) * 3 * d * self.d_ff_expert
        return self.params_count() - self.n_layers * (dense_moe - active_moe)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
        d_head=16,
        d_ff=128,
        vocab=512,
        d_ff_expert=32 if cfg.n_experts else 0,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        window_pattern=tuple(min(w, 32) if w else 0
                             for w in cfg.window_pattern),
        mrope_sections=(8, 4, 4) if cfg.mrope_sections else None,
    )
