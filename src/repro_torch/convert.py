"""Parameters of the reference JAX package → the port's layout.

`params_from_jax` takes a parameter tree of the reference's dense,
MoE or vision-language transformer, RWKV6 model, Hymba hybrid or
encoder-decoder with every leaf already
converted to numpy (e.g. `jax.tree.map(np.asarray, params)`, done by the
caller: this package never imports JAX) and returns the port's state: the
same arrays as torch tensors, each in its own dtype (bf16 weights, f32
leaves such as RWKV's `w0` and `u` or Mamba's `log_a`), with the
reference's stacked (L, ...) layer leaves, nested `attn` / `ssm` / `mlp`
dicts included, split into a list of per-layer dicts: under "layers",
and under the encoder-decoder's "encoder" and "decoder"
(`models.tree.LAYER_KEYS`). Both packages then compute the same
function from the same weights.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.tree import LAYER_KEYS


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a private copy


def _layer(tree: Mapping[str, Any], i: int, device) -> dict:
    return {k: (_layer(v, i, device) if isinstance(v, Mapping)
                else _tensor(np.asarray(v)[i], device))
            for k, v in tree.items()}


def _layers(stacked: Mapping[str, Any], device) -> list[dict]:
    n_layers = int(np.asarray(stacked["ln1"]).shape[0])
    return [_layer(stacked, i, device) for i in range(n_layers)]


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> dict:
    """Reference params (numpy leaves) of any ported model → port
    state."""
    return {k: _layers(v, device) if k in LAYER_KEYS else _tensor(v, device)
            for k, v in tree.items()}
