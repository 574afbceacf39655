"""Activation-sharding constraints: the reference's `models/actsharding.py`.

The reference pins activations explicitly: model code calls
`constrain(x)` at block boundaries and the launcher installs a
mesh-aware hook, because XLA's propagation can drop the batch sharding
inside scan bodies (hymba's 25-head attention replicated the global
batch on every device, a 16× HBM and FLOP inflation). The launcher also
installs the mesh that layer-level regions read (`mesh_ctx`: the MoE
layer's dispatch).

In the port's auto engine (`launch.train.make_train_step`) a rank
computes on its own rows of the batch as local tensors, so the batch
constraint holds by construction; `batch_dp_hook` checks it: an
activation whose leading dim is the global batch raises. With no hook
installed `constrain` is the identity, so the manual engine and serving
run as they did. The mesh of `mesh_ctx` is the engine's
`core.transport.ProcessMesh`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_HOOK: Optional[Callable] = None
_MESH = None          # the mesh of layer-level regions (MoE)


def set_hook(fn: Optional[Callable], mesh=None) -> None:
    global _HOOK, _MESH
    _HOOK = fn
    _MESH = mesh


def mesh_ctx():
    """(mesh, dp_axes) for layer-level regions, or None."""
    if _MESH is None:
        return None
    dp = tuple(a for a in _MESH.axis_names if a != "model")
    return _MESH, dp


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Apply the installed activation constraint (identity by default)."""
    if _HOOK is None:
        return x
    return _HOOK(x)


def batch_dp_hook(mesh, global_batch: int) -> Callable:
    """The check of the batch constraint on a mesh (a `ProcessMesh`, or
    (axis, size) pairs) whose DP axes split a batch of `global_batch`
    rows: an activation of two dims or more whose leading dim is the
    whole batch, where the DP ranks are more than one and split it,
    raises, since it would replicate the global batch on every rank."""
    pairs = mesh.axes if hasattr(mesh, "axes") else tuple(mesh)
    dpn = 1
    for a, s in pairs:
        if a != "model":
            dpn *= int(s)
    split = dpn > 1 and global_batch > 1 and global_batch % dpn == 0

    def hook(x: torch.Tensor) -> torch.Tensor:
        if split and x.dim() >= 2 and x.shape[0] == global_batch:
            raise RuntimeError(
                f"an activation {tuple(x.shape)} holds the global batch of "
                f"{global_batch} rows on one of {dpn} data-parallel ranks, "
                f"each of which computes on its {global_batch // dpn}")
        return x

    return hook
