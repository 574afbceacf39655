"""Assigned architecture configs (public literature) + registry.

Each module defines CONFIG (full scale) and SUPPORTED_SHAPES.
`get_config(name)` resolves by id.
"""
from __future__ import annotations

import importlib

# The configurations of the ported model families (dense, MoE, RWKV6,
# Hymba hybrid); the reference's other architectures join as their
# families are ported.
ARCHS = [
    "stablelm_12b",
    "rwkv6_1_6b",
    "hymba_1_5b",
    "gemma2_27b",
    "qwen3_32b",
    "gemma3_4b",
    "deepseek_moe_16b",
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
