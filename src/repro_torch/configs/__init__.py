"""Assigned architecture configs (public literature) + registry.

Each module defines CONFIG (full scale) and SUPPORTED_SHAPES.
`get_config(name)` resolves by id.
"""
from __future__ import annotations

import importlib

# All ten of the reference's configurations: the dense and MoE
# transformers, RWKV6, the Hymba hybrid, the vision-language transformer
# (M-RoPE, embeddings as input) and the encoder-decoder.
ARCHS = [
    "stablelm_12b",
    "rwkv6_1_6b",
    "hymba_1_5b",
    "gemma2_27b",
    "qwen3_32b",
    "gemma3_4b",
    "deepseek_moe_16b",
    "mixtral_8x22b",
    "qwen2_vl_7b",
    "whisper_large_v3",
]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.CONFIG


def supported_shapes(name: str) -> list[str]:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return list(mod.SUPPORTED_SHAPES)


def all_cells():
    """Every (arch, shape) cell; unsupported ones are flagged
    so the dry-run records them as documented skips."""
    from repro_torch.models.config import SHAPES
    cells = []
    for a in ARCHS:
        sup = supported_shapes(a)
        for s in SHAPES:
            cells.append((a, s, s in sup))
    return cells
