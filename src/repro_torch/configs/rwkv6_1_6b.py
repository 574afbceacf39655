"""rwkv6-1.6b (Finch) [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — data-dependent per-channel decay. [arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # wkv heads (head_dim 64)
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab=65536,
    ssm_state=64,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
