"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    d_ff_expert=16384,
    window_pattern=(4096,),     # SWA everywhere
    rope_theta=1e6,
    moe_groups=16,      # DP-local dispatch groups (EXPERIMENTS.md §Perf)
)

# SWA → decode touches a bounded window; long_500k runs.
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
