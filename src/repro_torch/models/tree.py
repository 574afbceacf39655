"""Parameter trees in the reference's layout.

The reference keeps a model's parameters as one nested dict whose layer
leaves are stacked on a leading (L,) axis, and visits the leaves in
`jax.tree` order: keys sorted, depth first. The port serves from lists
of per-layer dicts (`params["layers"]`; the encoder-decoder's
`params["encoder"]` and `params["decoder"]`, `LAYER_KEYS`). These
helpers give the reference's order and its stacked layout, for the
trainer's ZeRO-3 shards and for `ModelAPI.params_spec`.
"""
from __future__ import annotations

from typing import Any, Iterable

import torch

Path = tuple[str, ...]
# the keys whose value is a list of per-layer dicts in the port's layout
# and one stacked (L, ...) tree in the reference's
LAYER_KEYS = ("layers", "encoder", "decoder")


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


def _stack(layers: list[dict]) -> dict:
    per_layer = [tree_items(lp) for lp in layers]
    return tree_from_items(
        (group[0][0], torch.stack([leaf for _, leaf in group]))
        for group in zip(*per_layer, strict=True))


def _unstack(stacked: dict) -> list[dict]:
    items = [(path, leaf.unbind(0)) for path, leaf in tree_items(stacked)]
    return [tree_from_items((path, views[i]) for path, views in items)
            for i in range(len(items[0][1]))]


def stack_layers(params: dict) -> dict:
    """The port's params (lists of per-layer dicts under LAYER_KEYS) in
    the reference's layout: every layer leaf stacked on a leading (L,)
    axis (`torch.stack`, so the stacked leaves are copies)."""
    return {k: _stack(v) if k in LAYER_KEYS else v
            for k, v in params.items()}


def unstack_layers(tree: dict) -> dict:
    """The reference's layout → the port's: each stacked (L, ...) layer
    leaf as L views, one a layer, so autograd sums the layers' gradients
    into the stacked leaf."""
    return {k: _unstack(v) if k in LAYER_KEYS else v
            for k, v in tree.items()}
