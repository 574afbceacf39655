"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    d_head=256,
    # 5 local (sliding 1024) : 1 global
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    rope_theta=1e6,
)

# Mostly-local attention → long_500k runs (global layers decode linearly).
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
