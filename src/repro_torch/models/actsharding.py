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

On a "model" axis above 1 the engine also installs a `TPContext`
(`set_tp`): this rank's line of the "model" axis and, for every
parameter leaf the forward takes, the dim that line shards (the leaf a
local tensor of 1/m of it there) or None. The layers' products read it
(`layers.tp_dot`): a product whose weight is sharded runs on the local
slice through the operators of `core.transport`, and a leaf used outside
a product is gathered over the line where it is used (`TPContext.whole`).
With no context the layers run as they did.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

_HOOK: Optional[Callable] = None
_MESH = None          # the mesh of layer-level regions (MoE)
_TP: Optional["TPContext"] = None


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


@dataclass(eq=False)
class TPContext:
    """Tensor parallelism on one "model" line of a process mesh: `mesh`
    (the `ProcessMesh`), `line` (this rank's line of "model"), `vocab`
    (the model's whole vocabulary: logits narrower than it are this
    rank's slice, `vocab_slice`), and `dims`, id of each parameter leaf
    the forward takes → the dim the line shards, or None. `leaves` keeps
    those tensors alive, so that no id is reused while it is installed;
    `paths` names them (id → the leaf's path, "/"-joined)."""
    mesh: object
    line: object
    vocab: int
    dims: dict
    leaves: list = field(default_factory=list, repr=False)
    paths: dict = field(default_factory=dict, repr=False)

    @classmethod
    def for_tree(cls, mesh, line, vocab: int, tree: dict,
                 dims: dict) -> "TPContext":
        """The context of the port's parameter tree `tree` (per-layer
        views of the stacked leaves, as the auto step's forward takes
        them): `dims` maps each stacked leaf's path to the dim the line
        shards, or None; a layer view's dim is its stacked leaf's less
        one."""
        from .tree import LAYER_KEYS, tree_items

        ids, keep, names = {}, [], {}
        for k, v in tree.items():
            if k in LAYER_KEYS:
                items = [((k,) + path, t, 1) for lp in v
                         for path, t in tree_items(lp)]
            else:
                items = [(path, t, 0) for path, t in tree_items(v, (k,))]
            for path, t, skip in items:
                d = dims[path]
                ids[id(t)] = None if d is None else d - skip
                keep.append(t)
                names[id(t)] = "/".join(path)
        return cls(mesh, line, vocab, ids, keep, names)

    def dim(self, w: torch.Tensor) -> Optional[int]:
        """The dim of the leaf `w` the line shards, or None (replicated,
        or not a parameter leaf)."""
        return self.dims.get(id(w))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import transport
        return transport.copy_to_line(self.mesh, self.line, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import transport
        return transport.reduce_over_line(self.mesh, self.line, x)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        from repro_torch.core import transport
        return transport.gather_over_line(self.mesh, self.line, x, dim)

    def slice(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        from repro_torch.core import transport
        return transport.slice_for_line(self.mesh, self.line, x, dim)

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """The whole leaf `w` where the line shards it (a leaf the forward
        uses outside a product: gathered over the line, its cotangent
        sliced back), else `w`."""
        d = self.dim(w)
        return w if d is None else self.gather(w, d)

    def vocab_slice(self, logits: torch.Tensor) -> Optional[int]:
        """The first vocabulary entry of `logits` where they are this
        rank's slice of the vocabulary, else None."""
        n = logits.shape[-1]
        if n == self.vocab:
            return None
        if n * self.line.size != self.vocab:
            raise ValueError(f"logits of {n} entries on a line of "
                             f"{self.line.size} over a vocabulary of "
                             f"{self.vocab}")
        return self.line.index * n


def set_tp(ctx: Optional[TPContext]) -> None:
    global _TP
    _TP = ctx


def tp_context() -> Optional[TPContext]:
    """The installed `TPContext`, or None."""
    return _TP


def whole(w: torch.Tensor) -> torch.Tensor:
    """`TPContext.whole` under the installed context; `w` with none."""
    return w if _TP is None else _TP.whole(w)
