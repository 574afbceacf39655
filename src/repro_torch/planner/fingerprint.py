"""Canonical fingerprints for topologies, GenModel params and plan requests.

Two topologies that differ only in node names or child ordering produce the
same AllReduce plan (GenTree only looks at structure, level classes and
link capacities), so they must share a cache entry.  We hash a *canonical
form*: each node is reduced to (level, uplink_bw, uplink_latency, sorted
child forms); server names and ids never enter the hash.

Floats are formatted with `%.9g` before hashing so that values which
round-trip through JSON (disk persistence) keep the same fingerprint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

from repro_torch.core.cost_model import GenModelParams
from repro_torch.core.topology import TopoNode


def _f(x: float) -> str:
    return "%.9g" % float(x)


def topo_canonical(node: TopoNode) -> tuple:
    """Order-invariant canonical form of a topology subtree. Health state
    is part of the form (DESIGN.md §12): a degraded link already hashes
    differently through its reduced uplink_bw, but a dead node with
    unchanged capacities must not alias its healthy twin — plans built
    before a failure would otherwise stay reachable after it."""
    children = tuple(sorted(topo_canonical(c) for c in node.children))
    return (node.level, _f(node.uplink_bw), _f(node.uplink_latency),
            getattr(node, "health", "ok"), children)


def params_canonical(params: Mapping[str, GenModelParams] | None) -> tuple:
    if not params:
        return ()
    out = []
    for level in sorted(params):
        p = params[level]
        out.append((level,) + tuple(
            _f(getattr(p, f.name)) for f in dataclasses.fields(p)))
    return tuple(out)


def _digest(obj: Any) -> str:
    payload = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


def fingerprint_topo(topo: TopoNode) -> str:
    """Stable hex digest; equal for isomorphic trees."""
    return _digest(topo_canonical(topo))


def fingerprint_params(params: Mapping[str, GenModelParams] | None) -> str:
    return _digest(params_canonical(params))


def plan_key(topo: TopoNode, params: Mapping[str, GenModelParams] | None,
             nbytes_bucket: int, dtype: str = "float32",
             extra: tuple = ()) -> str:
    """Cache key for a full GenTree plan request."""
    return _digest([topo_canonical(topo), params_canonical(params),
                    int(nbytes_bucket), dtype, list(extra)])


def axis_key(axes: Sequence[tuple[str, int]],
             params: Mapping[str, GenModelParams] | None,
             size_bucket: int, extra: tuple = ()) -> str:
    """Cache key for a per-mesh-axis plan request (launch.train hot path).

    The axis *names* matter (they name mesh levels with different param
    classes), the sizes matter, and so do the params. `extra` carries
    service configuration that changes the answer (pricing engine,
    gentree kwargs) so differently-configured services never share an
    axis-plan entry.
    """
    return _digest([[list(a) for a in axes], params_canonical(params),
                    int(size_bucket), list(extra)])
