"""Parameters of the reference JAX package → the port's layout.

`params_from_jax` takes the reference dense transformer's parameter tree
with every leaf already converted to numpy (e.g.
`jax.tree.map(np.asarray, params)`, done by the caller: this package
never imports JAX) and returns the port's state: the same arrays as
torch tensors, with the reference's stacked (L, ...) layer leaves split
into a list of per-layer dicts. Both packages then compute the same
function from the same weights.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


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


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> dict:
    """Reference dense-transformer params (numpy leaves) → port state."""
    stacked = tree["layers"]
    n_layers = int(np.asarray(stacked["ln1"]).shape[0])
    state = {"layers": [_layer(stacked, i, device)
                        for i in range(n_layers)]}
    for k, v in tree.items():
        if k != "layers":
            state[k] = _tensor(v, device)
    return state
