"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408(expert)
vocab=102400, 2 shared + 64 routed experts top-6, fine-grained.
[arXiv:2401.06066; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408 * 8,        # dense-equivalent (first layer is dense in the
    #                       original; we keep all layers MoE for uniform scan)
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    moe_groups=16,      # DP-local dispatch groups (EXPERIMENTS.md §Perf)
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
