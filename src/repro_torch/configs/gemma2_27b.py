"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap. [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    d_head=128,
    window_pattern=(4096, 0),      # alternating local(4096)/global
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=1e4,
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
