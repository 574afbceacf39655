"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution. Vision frontend is a STUB:
input_specs() provides precomputed patch/token embeddings + 3D position
ids. [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),   # t/h/w sections of the 128-dim head
    embeds_input=True,
    rope_theta=1e6,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
