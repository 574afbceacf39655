"""Tree-like physical topologies (paper §4.2, Figure 6/11).

A topology is a rooted tree. Leaves are servers (compute endpoints holding
data); internal nodes are switches. Every non-root node has an uplink to its
parent with a bandwidth (bytes/s) and a latency contribution. GenModel
parameters (alpha/beta/gamma/delta/epsilon/w_t) attach per *level class*
(paper Table 5: Cross-DC / Root-SW / Middle-SW / Server).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np


class RoutingIndex:
    """Dense array view of a finalized topology (built by `finalize()`).

    Assigns every node a DFS index and every *directed* uplink a dense link
    id (`2*node` = 'up' through node's uplink, `2*node+1` = 'down'), and
    tabulates each server's ancestor chain so the links on any src→dst path
    become pure array lookups: a level-`l` ancestor of `src` lies strictly
    below the LCA — and hence its uplink is on the path — exactly when it
    differs from `dst`'s level-`l` ancestor. `core.simfast` vectorizes the
    whole per-step routing of a Plan over these tables; `path_links()`
    remains the reference implementation (property-tested against this).
    """

    def __init__(self, root: "TopoNode"):
        self.root = root
        self.nodes: list[TopoNode] = list(root.iter_nodes())
        idx = {id(n): i for i, n in enumerate(self.nodes)}
        self.n_nodes = len(self.nodes)
        self.n_links = 2 * self.n_nodes
        servers = root.servers()
        self.n_servers = len(servers)
        # Server arrays are indexed by _sid. For a tree finalized at this
        # root, sids are contiguous 0..n-1; for a subtree of an enclosing
        # finalized tree they are a sparse subset of the global ids, so
        # size by the largest sid instead of the count.
        self.sids = tuple(s._sid for s in servers)   # staleness check key
        self.sid_cap = max(self.sids, default=-1) + 1

        # Per-node (and so per-link-pair) physical attributes. A link's
        # GenModel level class is its *parent switch*'s level (the fabric
        # the uplink plugs into), matching the reference simulator.
        self.link_bw = np.zeros(self.n_nodes)
        self.link_latency = np.zeros(self.n_nodes)
        levels: list[str] = []
        level_idx: dict[str, int] = {}
        self.link_level = np.zeros(self.n_nodes, dtype=np.int64)
        depth_of: dict[int, int] = {id(root): 0}
        for i, n in enumerate(self.nodes):
            self.link_bw[i] = n.uplink_bw
            self.link_latency[i] = n.uplink_latency
            lvl = n.parent.level if n.parent is not None else n.level
            if lvl not in level_idx:
                level_idx[lvl] = len(levels)
                levels.append(lvl)
            self.link_level[i] = level_idx[lvl]
            if n is not root:
                depth_of[id(n)] = depth_of[id(n.parent)] + 1
        self.levels = levels                    # level-class names, indexed
        self.level_idx = level_idx

        # Per-server tables (indexed by _sid).
        self.max_depth = max((depth_of[id(s)] for s in servers), default=0)
        self.srv_node = np.zeros(self.sid_cap, dtype=np.int64)
        self.srv_bw = np.zeros(self.sid_cap)
        self.srv_level = np.zeros(self.sid_cap, dtype=np.int64)
        # anc[s, l] = node index of server s's ancestor at tree depth l
        # (root = depth 0, the server itself at its own depth); -1 pads
        # levels below the server in ragged-depth trees.
        self.anc = np.full((self.sid_cap, self.max_depth + 1), -1,
                           dtype=np.int64)
        for s in servers:
            sid = s._sid
            self.srv_node[sid] = idx[id(s)]
            self.srv_bw[sid] = s.uplink_bw
            plvl = s.parent.level if s.parent is not None else "root_sw"
            if plvl not in level_idx:
                level_idx[plvl] = len(levels)
                levels.append(plvl)
            self.srv_level[sid] = level_idx[plvl]
            chain = []
            n = s
            while True:     # climb to this index's root, never above it
                chain.append(idx[id(n)])
                if n is root:
                    break
                n = n.parent
            for l, node_i in enumerate(reversed(chain)):
                self.anc[sid, l] = node_i

    def path_link_ids(self, src_sid: int, dst_sid: int) -> list[int]:
        """Dense link ids on the src→dst path (src-side 'up' links first,
        then dst-side 'down' links root-to-leaf). Mirrors `path_links`."""
        out_up, out_down = [], []
        for l in range(1, self.max_depth + 1):
            a, b = self.anc[src_sid, l], self.anc[dst_sid, l]
            if a == b:
                continue
            if a != -1:
                out_up.append(2 * int(a))
            if b != -1:
                out_down.append(2 * int(b) + 1)
        return out_up[::-1] + out_down


@dataclass
class TopoNode:
    name: str
    children: list["TopoNode"] = field(default_factory=list)
    # Uplink to parent (irrelevant for root).
    uplink_bw: float = 0.0          # bytes / s
    uplink_latency: float = 0.0     # s
    level: str = "server"           # "server" | "middle_sw" | "root_sw" | "cross_dc"
    parent: "TopoNode | None" = None
    # Health state (DESIGN.md §12): "ok" | "degraded" | "dead". A degraded
    # link keeps serving at reduced uplink_bw (nominal_bw preserves the
    # healthy value for restore); a dead node is excluded by prune_dead().
    health: str = "ok"
    nominal_bw: float | None = None
    _sid: int = -1                  # server id (leaves only, assigned by finalize)
    _routing: "RoutingIndex | None" = field(default=None, repr=False,
                                            compare=False)

    # ---- structure helpers -------------------------------------------------
    @property
    def is_server(self) -> bool:
        return not self.children

    def servers(self) -> list["TopoNode"]:
        if self.is_server:
            return [self]
        out: list[TopoNode] = []
        for c in self.children:
            out.extend(c.servers())
        return out

    def num_servers(self) -> int:
        return len(self.servers())

    def switches(self) -> list["TopoNode"]:
        """All internal nodes, bottom-up (children before parents)."""
        if self.is_server:
            return []
        out: list[TopoNode] = []
        for c in self.children:
            out.extend(c.switches())
        out.append(self)
        return out

    def iter_nodes(self):
        yield self
        for c in self.children:
            yield from c.iter_nodes()

    def finalize(self) -> "TopoNode":
        """Assign parent pointers, contiguous server ids (DFS order) and
        build the dense RoutingIndex. Idempotent; call again after
        structural edits to refresh the index."""
        sid = itertools.count()

        def walk(node: TopoNode, parent: TopoNode | None):
            node.parent = parent
            if node.is_server:
                node._sid = next(sid)
            for c in node.children:
                walk(c, node)

        walk(self, None)
        self._routing = RoutingIndex(self)
        return self

    def routing(self) -> "RoutingIndex":
        """The dense routing index (building it on demand if needed).

        For a node that is itself the finalized root, this returns the
        index built by `finalize()`. For a *subtree* of an enclosing
        finalized tree (valid server ids already assigned) it builds a
        local index without re-finalizing — re-finalizing would sever the
        subtree's parent pointer and renumber the enclosing tree's ids.
        A cached index is discarded when the server ids it was built
        against no longer match (e.g. the enclosing tree was edited and
        re-finalized, renumbering sids DFS-wide).
        """
        sids = tuple(s._sid for s in self.servers())
        if (self._routing is None or self._routing.root is not self
                or self._routing.sids != sids):
            if -1 in sids or len(set(sids)) != len(sids):
                self.finalize()          # never finalized: safe to assign
            else:
                self._routing = RoutingIndex(self)
        return self._routing

    def server_ids(self) -> list[int]:
        return [s._sid for s in self.servers()]

    # ---- health (DESIGN.md §12) --------------------------------------------
    def _invalidate_routing(self) -> None:
        """Drop cached routing indices that bake in this node's uplink.
        The uplink appears only in indices rooted at this node or at an
        ancestor, so climbing to the root suffices; descendant subtree
        indices never route over it."""
        n = self
        while n is not None:
            n._routing = None
            n = n.parent

    def mark_degraded(self, factor: float) -> "TopoNode":
        """Degrade this node's uplink to `factor` × its nominal bandwidth
        (0 < factor ≤ 1). The changed uplink_bw flows into the planner
        fingerprint (`topo_canonical` hashes it), so any PlannerService
        keyed on this topology reprices from a cold cache entry — no
        schedule priced for the healthy link survives."""
        factor = float(factor)
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"degrade factor must be in (0, 1]: {factor}")
        if self.nominal_bw is None:
            self.nominal_bw = self.uplink_bw
        self.uplink_bw = self.nominal_bw * factor
        self.health = "ok" if factor == 1.0 else "degraded"
        self._invalidate_routing()
        return self

    def mark_dead(self) -> "TopoNode":
        """Mark this node (and implicitly its subtree) failed. Dead nodes
        still fingerprint distinctly (health is hashed) and are removed
        from planning topologies via `prune_dead()`."""
        self.health = "dead"
        self._invalidate_routing()
        return self

    def restore_health(self) -> "TopoNode":
        if self.nominal_bw is not None:
            self.uplink_bw = self.nominal_bw
        self.health = "ok"
        self._invalidate_routing()
        return self

    def has_dead(self) -> bool:
        return any(n.health == "dead" for n in self.iter_nodes())

    def prune_dead(self) -> "TopoNode":
        """A finalized deep copy of this tree without dead subtrees (a
        switch whose children all died is itself removed). Raises
        ValueError when nothing survives — the caller has no topology
        left to plan over."""
        def copy(node: "TopoNode") -> "TopoNode | None":
            if node.health == "dead":
                return None
            kids = [k for k in (copy(c) for c in node.children)
                    if k is not None]
            if node.children and not kids:
                return None
            out = TopoNode(name=node.name, children=kids,
                           uplink_bw=node.uplink_bw,
                           uplink_latency=node.uplink_latency,
                           level=node.level, health=node.health,
                           nominal_bw=node.nominal_bw)
            return out

        root = copy(self)
        if root is None or not root.servers():
            raise ValueError("prune_dead: no live servers remain")
        return root.finalize()

    # ---- routing -----------------------------------------------------------
    def path_links(self, src: "TopoNode", dst: "TopoNode") -> list["TopoNode"]:
        """Links (represented by their child endpoint node) on src→dst path.

        Full-duplex links: the 'up' direction of node X's uplink and the
        'down' direction are distinct capacities; we return (node, dir) pairs.
        """
        a_path = []
        n = src
        while n is not None:
            a_path.append(n)
            n = n.parent
        anc = set(id(x) for x in a_path)
        down = []
        n = dst
        while id(n) not in anc:
            down.append(n)
            n = n.parent
        lca = n
        up = []
        for x in a_path:
            if x is lca:
                break
            up.append(x)
        # 'up' direction uses src-side uplinks; 'down' uses dst-side uplinks.
        return [(x, "up") for x in up] + [(x, "down") for x in reversed(down)]


def _server(name: str, bw: float, lat: float) -> TopoNode:
    return TopoNode(name=name, uplink_bw=bw, uplink_latency=lat, level="server")


# ---------------------------------------------------------------------------
# Builders (paper Figure 11 instances)
# ---------------------------------------------------------------------------
GBPS = 1e9 / 8.0  # 1 Gbps in bytes/s


def single_switch(n: int, *, bw: float = 10 * GBPS, lat: float = 5e-6,
                  name: str = "root", level: str = "middle_sw") -> TopoNode:
    """In-rack cluster: n servers on one switch. The paper's testbed switch
    is a 10 Gbps ToR — parameter class 'middle_sw' in Table 5."""
    root = TopoNode(name=name, level=level)
    root.children = [_server(f"s{i}", bw, lat) for i in range(n)]
    return root.finalize()


def symmetric_tree(n_middle: int, servers_per_middle: int, *,
                   server_bw: float = 10 * GBPS,
                   uplink_bw: float = 100 * GBPS,
                   lat: float = 5e-6) -> TopoNode:
    root = TopoNode(name="root", level="root_sw")
    for m in range(n_middle):
        sw = TopoNode(name=f"msw{m}", uplink_bw=uplink_bw, uplink_latency=lat,
                      level="middle_sw")
        sw.children = [_server(f"s{m}_{i}", server_bw, lat)
                       for i in range(servers_per_middle)]
        root.children.append(sw)
    return root.finalize()


def asymmetric_tree(n_middle: int = 16, big: int = 32, small: int = 16, *,
                    server_bw: float = 10 * GBPS,
                    uplink_bw: float = 100 * GBPS,
                    lat: float = 5e-6) -> TopoNode:
    root = TopoNode(name="root", level="root_sw")
    for m in range(n_middle):
        k = big if m < n_middle // 2 else small
        sw = TopoNode(name=f"msw{m}", uplink_bw=uplink_bw, uplink_latency=lat,
                      level="middle_sw")
        sw.children = [_server(f"s{m}_{i}", server_bw, lat) for i in range(k)]
        root.children.append(sw)
    return root.finalize()


def cross_dc(*, dc0_middle: int = 8, dc0_servers: int = 32,
             dc1_middle: int = 8, dc1_servers: int = 16,
             server_bw: float = 10 * GBPS, uplink_bw: float = 100 * GBPS,
             wan_bw: float = 10 * GBPS, wan_lat: float = 30e-3,
             lat: float = 5e-6) -> TopoNode:
    """Two DCs joined by a WAN link. Modelled as a virtual root whose two
    children are the DC root switches; the WAN link is dc1-root's uplink
    (dc0-root's uplink to the virtual root is considered infinite/local)."""
    top = TopoNode(name="wan_root", level="cross_dc")
    for d, (nm, ns, bw, lt) in enumerate(
            [(dc0_middle, dc0_servers, 1e18, 0.0),
             (dc1_middle, dc1_servers, wan_bw, wan_lat)]):
        dc = TopoNode(name=f"dc{d}", uplink_bw=bw, uplink_latency=lt,
                      level="root_sw")
        for m in range(nm):
            sw = TopoNode(name=f"dc{d}_msw{m}", uplink_bw=uplink_bw,
                          uplink_latency=lat, level="middle_sw")
            sw.children = [_server(f"dc{d}_s{m}_{i}", server_bw, lat)
                           for i in range(ns)]
            dc.children.append(sw)
        top.children.append(dc)
    return top.finalize()

