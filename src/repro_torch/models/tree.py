"""Parameter trees in the reference's layout.

The reference keeps a model's parameters as one nested dict whose layer
leaves are stacked on a leading (L,) axis, and visits the leaves in
`jax.tree` order: keys sorted, depth first. The port serves from a list
of per-layer dicts (`params["layers"]`). These helpers give the
reference's order and its stacked layout, for the trainer's ZeRO-3
shards and for `ModelAPI.params_spec`.
"""
from __future__ import annotations

from typing import Any, Iterable

import torch

Path = tuple[str, ...]


def tree_items(tree: Any, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """(path, leaf) pairs of a nested dict in the reference's tree order:
    keys sorted, depth first."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_items(tree[k], prefix + (k,))
    return out


def tree_from_items(items: Iterable[tuple[Path, Any]]) -> dict:
    """The nested dict of (path, leaf) pairs (`tree_items`' inverse)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def stack_layers(params: dict) -> dict:
    """The port's params (a list of per-layer dicts under "layers") in the
    reference's layout: every layer leaf stacked on a leading (L,) axis
    (`torch.stack`, so the stacked leaves are copies)."""
    per_layer = [tree_items(lp) for lp in params["layers"]]
    return {**params, "layers": tree_from_items(
        (group[0][0], torch.stack([leaf for _, leaf in group]))
        for group in zip(*per_layer, strict=True))}


def unstack_layers(tree: dict) -> dict:
    """The reference's layout → the port's: each stacked (L, ...) layer
    leaf as L views, one a layer, so autograd sums the layers' gradients
    into the stacked leaf."""
    items = [(path, leaf.unbind(0)) for path, leaf in
             tree_items(tree["layers"])]
    n_layers = len(items[0][1])
    return {**tree, "layers": [
        tree_from_items((path, views[i]) for path, views in items)
        for i in range(n_layers)]}
