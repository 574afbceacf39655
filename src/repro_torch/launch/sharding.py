"""Sharding rules: map every leaf of a tree to a spec, and a spec to
DTensor placements.

The reference's `launch/sharding.py` (FSDP × TP, ZeRO over data):
  * pick the largest axis divisible by the 'model' size → TP axis;
  * among the remaining axes, pick the largest divisible by the 'data'
    size → FSDP axis (only for leaves above a size threshold — norms and
    biases replicate);
  * the 'pod' axis (multi-pod mesh) is pure DP for params (replicated) and
    batch-sharded for data — cross-pod traffic is gradient sync only.

Batch / cache rules:
  * leading batch axis shards over all DP axes when divisible;
  * KV caches: KV-head axis over 'model' when divisible, else the sequence
    axis (long-context sequence sharding);
  * recurrent states: channel axis over 'model'.

A spec is a plain tuple in the reference's PartitionSpec layout: per
dimension None, an axis name, or a tuple of names (sharded over their
product, the first the major). A mesh is the port's (axis, size) pairs,
a `core.transport.ProcessMesh` or a `torch.distributed` `DeviceMesh`.
Trees are nested dicts and lists whose leaves have a `.shape` (tensors,
meta tensors); a spec tree has the same containers with tuples as its
leaves. `to_placements` turns a spec into one DTensor placement a mesh
dimension: `Shard(d)` on the axes the spec names at dimension d,
`Replicate()` on the others.

Parameter trees are taken in the reference's stacked layout
(`models.tree.stack_layers`, `ModelAPI.params_spec`): axis 0 of a layer
leaf is the layer axis and is never sharded (`skip_first`), so a leaf's
spec equals the reference's for the same stacked leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable

REPLICATE_BELOW = 1 << 18       # leaves smaller than 256 Ki elements replicate

Spec = tuple


def _pairs(mesh) -> tuple[tuple[str, int], ...]:
    """(axis, size) pairs of any of the mesh kinds the module takes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                           # a DeviceMesh
        return tuple(zip(names, (int(s) for s in mesh.shape)))
    axes = getattr(mesh, "axes", None)
    if axes is not None:                            # a ProcessMesh
        return tuple(axes)
    return tuple((str(a), int(s)) for a, s in mesh)


def _sizes(mesh) -> dict[str, int]:
    return dict(_pairs(mesh))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(a for a, _ in _pairs(mesh))


def _map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """fn(path, leaf) over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaf_spec(shape: tuple[int, ...], mesh, *, skip_first: bool = True,
              fsdp: bool = True) -> Spec:
    """Generic TP(+FSDP) spec for a parameter leaf.

    skip_first: axis 0 is the stacked layer axis — never sharded."""
    shape = tuple(int(s) for s in shape)
    sz = _sizes(mesh)
    model = sz.get("model", 1)
    data = sz.get("data", 1)
    n = math.prod(shape) if shape else 1
    spec: list[Any] = [None] * len(shape)
    if n < REPLICATE_BELOW or not shape:
        return tuple(spec)
    lo = 1 if (skip_first and len(shape) > 1) else 0
    # TP axis: largest axis divisible by model size
    cands = [(shape[i], i) for i in range(lo, len(shape))
             if model > 1 and shape[i] % model == 0]
    ti = None
    if cands:
        _, ti = max(cands)
        spec[ti] = "model"
    # FSDP axis: largest remaining axis divisible by data size
    if fsdp and data > 1:
        cands = [(shape[i], i) for i in range(lo, len(shape))
                 if i != ti and shape[i] % data == 0]
        if cands:
            _, di = max(cands)
            spec[di] = "data"
    return tuple(spec)


def params_specs(params: Any, mesh, *, fsdp: bool = True) -> Any:
    return _map(lambda _, x: leaf_spec(tuple(x.shape), mesh, fsdp=fsdp),
                params)


def opt_specs(opt_state: Any, params_spec_tree: Any, mesh=None) -> Any:
    """Optimizer moments are ALWAYS fully sharded (ZeRO): when params are
    FSDP-sharded they share the spec; when params are replicated over the
    DP axes (ZeRO-1) the moments still shard there — pass `mesh` to derive
    the sharded spec independently of the param spec."""
    if mesh is not None:
        mv = _map(lambda _, x: leaf_spec(tuple(x.shape), mesh, fsdp=True),
                  opt_state["m"])
    else:
        mv = params_spec_tree
    return {"m": mv, "v": mv, "step": ()}


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a != "model")


def _dp_size(mesh) -> int:
    sz = _sizes(mesh)
    return math.prod(sz[a] for a in _dp_axes(mesh))


def batch_specs(batch: Any, mesh) -> Any:
    """Shard the leading batch axis over the DP axes (mrope_positions has
    batch at axis 1)."""
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)

    def spec(path, x) -> Spec:
        name = str(path[-1])
        shape = tuple(x.shape)
        if name == "mrope_positions":       # (3, B, T)
            return (None, dp if shape[1] % dpn == 0 else None, None)
        s: list[Any] = [None] * len(shape)
        if shape and shape[0] % dpn == 0 and shape[0] > 1:
            s[0] = dp
        return tuple(s)

    return _map(spec, batch)


def cache_specs(cache: Any, mesh) -> Any:
    """KV caches (L, B, Hkv, S, hd): batch over DP if divisible; then
    KV-heads over 'model' if divisible, else sequence over 'model'.
    Recurrent states (L, B, H|Di, ...): channel axis over 'model'."""
    sz = _sizes(mesh)
    model = sz.get("model", 1)
    dp = _dp_axes(mesh)
    dpn = _dp_size(mesh)

    def spec(path, x) -> Spec:
        name = str(path[-1])
        shape = tuple(x.shape)
        if name == "pos":
            return (dp if shape[0] % dpn == 0 and dp else None,)
        s: list[Any] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dpn == 0 and shape[1] > 1:
            s[1] = dp          # batch axis of (L, B, ...)
        if name in ("k", "v", "xk", "xv") and len(shape) == 5:
            # KV heads over 'model' when divisible, else sequence
            if model > 1 and shape[2] % model == 0:
                s[2] = "model"                  # KV heads
            elif model > 1 and shape[3] % model == 0:
                s[3] = "model"                  # sequence
            # long-context, small batch: spend the idle DP axes on the
            # sequence axis too
            if s[1] is None and s[3] is None and len(dp) \
                    and shape[3] % dpn == 0 and shape[3] >= 4 * dpn:
                s[3] = dp
        elif name == "wkv" and len(shape) == 5:
            if model > 1 and shape[2] % model == 0:
                s[2] = "model"                  # wkv heads
        elif name == "ssm" and len(shape) == 4:
            if model > 1 and shape[2] % model == 0:
                s[2] = "model"                  # expanded channels
        elif name in ("tm_shift", "cm_shift") and len(shape) == 4:
            if model > 1 and shape[3] % model == 0:
                s[3] = "model"
        return tuple(s)

    return _map(spec, cache)


def spec_placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement a mesh dimension for one leaf's spec:
    `Shard(d)` where the spec names the dimension's axis at dim d,
    `Replicate()` otherwise. An axis named twice raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    at: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            if a in at:
                raise ValueError(f"axis {a!r} is named twice in {spec!r}")
            at[a] = d
    names = _axis_names(mesh)
    unknown = set(at) - set(names)
    if unknown:
        raise ValueError(f"spec {spec!r} names {sorted(unknown)}, not axes "
                         f"of the mesh {list(names)}")
    return tuple(Shard(at[a]) if a in at else Replicate() for a in names)


def to_placements(spec_tree: Any, mesh) -> Any:
    """The tree of `spec_placements` of every spec of `spec_tree`."""
    return _map(lambda _, s: spec_placements(s, mesh), spec_tree)
