"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads in each layer
(outputs mean-combined after per-branch norm). Meta-tokens omitted
(DESIGN.md §Arch-applicability). [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_expand=2,
    # hymba uses SWA in most layers; 3 global full-attn layers
    window_pattern=(1024,) * 10 + (0,),
)

SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
