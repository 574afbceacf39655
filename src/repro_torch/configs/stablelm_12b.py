"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    rope_theta=1e4,
)

# Pure full attention → long_500k skipped (DESIGN.md §Arch-applicability).
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
