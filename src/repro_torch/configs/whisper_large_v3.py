"""whisper-large-v3 [audio] — 32L(dec) d_model=1280 20H d_ff=5120
vocab=51866 — encoder-decoder; conv frontend is a STUB (input_specs()
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    embeds_input=True,      # frame embeddings from the stubbed conv stem
)

# Enc-dec full attention → long_500k skipped.
SUPPORTED_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
