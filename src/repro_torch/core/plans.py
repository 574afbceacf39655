"""AllReduce plan IR + builders for the classic plan types (paper §2.1).

A Plan is a sequence of synchronized Steps. Each Step contains point-to-point
Transfers (server→server, some number of data *blocks*) and ReduceOps (a
server folds `fan_in` blocks into one). Sizes are in data units ("floats" in
the paper); the cost model/simulator multiplies by unit size.

Block identity (DESIGN.md §8): an *executable* plan additionally records,
per Transfer and per ReduceOp, WHICH blocks move or fold. The AllReduce
input vector of `size` units is split into `Plan.num_blocks` equal blocks;
`Transfer.blocks` names the block shards whose current partial sum moves,
`ReduceOp.blocks` the shards being folded. The cost engines ignore these
fields entirely (pricing is byte-identical with or without them); they
exist so `core.lower` can compile the plan into an executable shard_map
schedule and structurally validate it (every server contribution of every
block reduced exactly once, all-gather completeness).

The IR is consumed by:
  * core.cost_model.evaluate_plan  — GenModel closed-form style accounting
  * core.simulator.simulate        — link-aware flow-level simulation
  * core.lower.lower_plan          — compilation to executable schedules
  * core.collectives               — mapping onto JAX lax collectives
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# Collective families a Plan can describe (DESIGN.md §14). The cost
# engines are family-agnostic — they price whatever steps the plan
# contains — but `core.lower` validates and compiles each family against
# its own dataflow contract:
#   allreduce      — every contribution of every block reduced once, then
#                    every server holds every block (the PR-3 contract);
#   reduce_scatter — the RS half alone: each block fully reduced at ≥1
#                    holder; output is the canonical shard per server;
#   allgather      — movement only: initial holders are inferred from the
#                    steps, and every server must end holding every block;
#   all_to_all     — movement only: block b of src's operand row for dst
#                    lands at dst as src's row (lax.all_to_all semantics);
#   p2p            — movement only: each (src, dst) edge replaces dst's
#                    buffer with src's payload (pipeline boundary shift).
FAMILIES = ("allreduce", "reduce_scatter", "allgather", "all_to_all", "p2p")


@dataclass(frozen=True)
class Transfer:
    src: int
    dst: int
    size: float  # data units moved (e.g. floats)
    # Block identity: which shards' partials move (None = unannotated IR;
    # priced identically, but not lowerable to an executable schedule).
    # size == len(blocks) * (plan.size / plan.num_blocks) when annotated.
    blocks: tuple[int, ...] | None = None


@dataclass(frozen=True)
class ReduceOp:
    server: int
    fan_in: int   # number of operand blocks folded into one output block
    size: float   # size of ONE block (= output size)
    # Block identity: which shards this fold produces (None = unannotated).
    # size == len(blocks) * (plan.size / plan.num_blocks) when annotated.
    blocks: tuple[int, ...] | None = None

    @property
    def adds(self) -> float:
        """γ-term ops: (fan_in - 1) * size."""
        return (self.fan_in - 1) * self.size

    @property
    def mem_ops(self) -> float:
        """δ-term ops: fan_in reads + 1 write per element (paper §3.1)."""
        return (self.fan_in + 1) * self.size


@dataclass(frozen=True)
class QuantReduceOp(ReduceOp):
    """A fold on a compressed wire (`cost_model.compressed_plan`): the
    quant/dequant passes ride as extra γ adds and δ mem_ops on top of the
    fold's own (fan_in − 1)·S / (fan_in + 1)·S accounting, so every
    pricer charges compression through the ops it already reads."""
    extra_adds: float = 0.0
    extra_mem_ops: float = 0.0

    @property
    def adds(self) -> float:
        return (self.fan_in - 1) * self.size + self.extra_adds

    @property
    def mem_ops(self) -> float:
        return (self.fan_in + 1) * self.size + self.extra_mem_ops


@dataclass
class Step:
    """One synchronized round.

    Mutation rules: plan builders append to `transfers`/`reduces` while
    constructing a step and must finish before the step is priced — the
    per-destination aggregates below are cached on first use. The cache is
    keyed on `len(transfers)`, so the common builder pattern (append, then
    simulate, then append more — e.g. `_merge_concurrent` extending a step)
    invalidates naturally; *replacing* a transfer without changing the list
    length is not supported (call `invalidate_caches()` by hand if you must).
    Callers must treat the returned dicts as read-only.
    """
    transfers: list[Transfer] = field(default_factory=list)
    reduces: list[ReduceOp] = field(default_factory=list)
    _dst_cache: tuple | None = field(default=None, repr=False, compare=False)

    def invalidate_caches(self) -> None:
        self._dst_cache = None

    def _by_dst(self) -> tuple[dict[int, float], dict[int, int]]:
        cache = self._dst_cache
        if cache is not None and cache[0] == len(self.transfers):
            return cache[1], cache[2]
        recv: dict[int, float] = {}
        fan: dict[int, int] = {}
        seen = set()
        for t in self.transfers:
            recv[t.dst] = recv.get(t.dst, 0.0) + t.size
            if (t.src, t.dst) not in seen:
                seen.add((t.src, t.dst))
                fan[t.dst] = fan.get(t.dst, 0) + 1
        self._dst_cache = (len(self.transfers), recv, fan)
        return recv, fan

    def recv_bytes_by_dst(self) -> dict[int, float]:
        return self._by_dst()[0]

    def fan_in_by_dst(self) -> dict[int, int]:
        return self._by_dst()[1]


@dataclass
class Plan:
    name: str
    n: int                 # number of participating servers
    size: float            # S: total data units per server
    steps: list[Step] = field(default_factory=list)
    servers: list[int] | None = None  # actual server ids (default 0..n-1)
    # Block granularity of the annotated IR: the size-unit vector is split
    # into num_blocks equal shards, indexed 0..num_blocks-1. None marks a
    # legacy/unannotated plan (prices fine, cannot be lowered).
    num_blocks: int | None = None
    # Which collective this plan computes (one of FAMILIES). Pricing walks
    # the steps either way; lowering and the execution entry points key off
    # this to pick the right validation contract and runtime surface.
    family: str = "allreduce"

    def ids(self) -> list[int]:
        return self.servers if self.servers is not None else list(range(self.n))

    # -- invariants (used by property tests) --------------------------------
    def total_traffic_per_server(self) -> dict[int, float]:
        out = {i: 0.0 for i in self.ids()}
        for st in self.steps:
            for t in st.transfers:
                out[t.src] = out.get(t.src, 0.0) + t.size
        return out

    def total_mem_ops(self) -> float:
        return sum(r.mem_ops for st in self.steps for r in st.reduces)

    def mem_ops_per_server(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for st in self.steps:
            for r in st.reduces:
                out[r.server] = out.get(r.server, 0.0) + r.mem_ops
        return out

    def max_mem_ops_per_server(self) -> float:
        """The parallel memory-access cost (Theorem 1 compares this: every
        server reduces its own block concurrently)."""
        per = self.mem_ops_per_server()
        return max(per.values()) if per else 0.0

    def total_adds(self) -> float:
        return sum(r.adds for st in self.steps for r in st.reduces)

    def max_fan_in(self) -> int:
        """Max communication fan-in w (paper counts the receiver's own
        block: w = #senders + 1)."""
        fi = [0]
        for st in self.steps:
            fi.extend(v + 1 for v in st.fan_in_by_dst().values())
        return max(fi)


# ---------------------------------------------------------------------------
# Builders — single-switch, N servers, S data units each.
# ---------------------------------------------------------------------------
def ring(n: int, size: float, servers: list[int] | None = None) -> Plan:
    """Ring AllReduce: 2(N-1) steps of S/N-sized neighbor exchanges.

    Block schedule (the canonical ring walk): at ReduceScatter step s,
    server i forwards its partial of block (i - s) mod n to i+1, so after
    N-1 folds server j owns block (j + 1) mod n; the AllGather phase walks
    the finished blocks the same direction."""
    ids = servers if servers is not None else list(range(n))
    blk = size / n
    p = Plan("ring", n, size, servers=servers, num_blocks=n)
    # ReduceScatter phase.
    for s in range(n - 1):
        st = Step()
        for i in range(n):
            b = (i - s) % n
            st.transfers.append(Transfer(ids[i], ids[(i + 1) % n], blk,
                                         blocks=(b,)))
            st.reduces.append(ReduceOp(ids[(i + 1) % n], 2, blk,
                                       blocks=(b,)))
        p.steps.append(st)
    # AllGather phase.
    for a in range(n - 1):
        st = Step()
        for i in range(n):
            b = (i + 1 - a) % n
            st.transfers.append(Transfer(ids[i], ids[(i + 1) % n], blk,
                                         blocks=(b,)))
        p.steps.append(st)
    return p


def cps(n: int, size: float, servers: list[int] | None = None) -> Plan:
    """Co-located PS: 1 full-mesh ReduceScatter step (fan-in N) + 1 AllGather."""
    ids = servers if servers is not None else list(range(n))
    blk = size / n
    p = Plan("cps", n, size, servers=servers, num_blocks=n)
    rs = Step()
    for i in range(n):
        for j in range(n):
            if i != j:
                # server i ships its contribution to block j's owner
                rs.transfers.append(Transfer(ids[i], ids[j], blk,
                                             blocks=(j,)))
        rs.reduces.append(ReduceOp(ids[i], n, blk, blocks=(i,)))
    p.steps.append(rs)
    ag = Step()
    for i in range(n):
        for j in range(n):
            if i != j:
                ag.transfers.append(Transfer(ids[i], ids[j], blk,
                                             blocks=(i,)))
    p.steps.append(ag)
    return p


def reduce_broadcast(n: int, size: float, servers: list[int] | None = None) -> Plan:
    """Naive PS: everyone → root (reduce), root → everyone (broadcast)."""
    ids = servers if servers is not None else list(range(n))
    root = ids[0]
    # The root folds whole vectors — a single block of all `size` units.
    p = Plan("reduce_broadcast", n, size, servers=servers, num_blocks=1)
    rs = Step()
    for i in ids[1:]:
        rs.transfers.append(Transfer(i, root, size, blocks=(0,)))
    rs.reduces.append(ReduceOp(root, n, size, blocks=(0,)))
    p.steps.append(rs)
    bc = Step()
    for i in ids[1:]:
        bc.transfers.append(Transfer(root, i, size, blocks=(0,)))
    p.steps.append(bc)
    return p


def rhd(n: int, size: float, servers: list[int] | None = None) -> Plan:
    """Recursive Halving & Doubling. Non-power-of-two handled with the
    standard fold-in/fold-out patch (the χ(N) extra steps of Table 1).

    Blocks are sized at the pow2 core's final-shard granularity
    (num_blocks = pow2): at halving step j, core server i holds the range
    of 2·dist blocks selected by its high bits and sends the half NOT
    matching bit (i//dist)%2 to peer i^dist, ending with server i owning
    block i; doubling mirrors the ranges back."""
    ids = servers if servers is not None else list(range(n))
    pow2 = 1 << (n.bit_length() - 1)
    extra = n - pow2  # servers folded into partners
    p = Plan("rhd", n, size, servers=servers, num_blocks=pow2)
    all_blocks = tuple(range(pow2))

    if extra:
        st = Step()
        for e in range(extra):
            # server pow2+e sends everything to server e.
            st.transfers.append(Transfer(ids[pow2 + e], ids[e], size,
                                         blocks=all_blocks))
            st.reduces.append(ReduceOp(ids[e], 2, size, blocks=all_blocks))
        p.steps.append(st)

    core = ids[:pow2]
    # Halving (ReduceScatter): step j exchanges size/2^(j+1).
    for j in range(int(math.log2(pow2))):
        dist = pow2 >> (j + 1)
        sz = size / (1 << (j + 1))
        st = Step()
        for i in range(pow2):
            peer = i ^ dist
            bit = (i // dist) % 2
            base = i & ~(2 * dist - 1)
            sent = tuple(range(base + (1 - bit) * dist,
                               base + (1 - bit) * dist + dist))
            st.transfers.append(Transfer(core[i], core[peer], sz,
                                         blocks=sent))
            st.reduces.append(ReduceOp(core[peer], 2, sz, blocks=sent))
        p.steps.append(st)
    # Doubling (AllGather).
    for j in reversed(range(int(math.log2(pow2)))):
        dist = pow2 >> (j + 1)
        sz = size / (1 << (j + 1))
        st = Step()
        for i in range(pow2):
            peer = i ^ dist
            base = i & ~(dist - 1)
            held = tuple(range(base, base + dist))
            st.transfers.append(Transfer(core[i], core[peer], sz,
                                         blocks=held))
        p.steps.append(st)

    if extra:
        st = Step()
        for e in range(extra):
            st.transfers.append(Transfer(ids[e], ids[pow2 + e], size,
                                         blocks=all_blocks))
        p.steps.append(st)
    return p


def hcps(factors: list[int], size: float,
         servers: list[int] | None = None) -> Plan:
    """m-step Hierarchical Co-located PS with orthogonal groupings
    (paper Figure 5). factors = [f_0, ..., f_{m-1}], N = prod(factors).

    Grouping for step i: servers whose mixed-radix digits differ only in
    digit i form a group of size f_i. Each step is a CPS ReduceScatter on
    the surviving block shard; AllGather mirrors in reverse.
    """
    n = 1
    for f in factors:
        n *= f
    ids = servers if servers is not None else list(range(n))
    p = Plan("hcps_" + "x".join(map(str, factors)), n, size, servers=servers,
             num_blocks=n)

    def digits(x: int) -> list[int]:
        d = []
        for f in factors:
            d.append(x % f)
            x //= f
        return d

    def groups(step: int) -> list[list[int]]:
        """Indices grouped by all digits except digit `step`. Members are
        listed in index order == increasing digit-`step` order."""
        by_key: dict[tuple, list[int]] = {}
        for i in range(n):
            d = digits(i)
            key = tuple(d[:step] + d[step + 1:])
            by_key.setdefault(key, []).append(i)
        return list(by_key.values())

    # Block bookkeeping: every server starts holding the full block range;
    # at RS stage si each group member keeps the sub-range indexed by its
    # own digit and ships sub-range j to the member with digit j.
    rng: dict[int, tuple[int, int]] = {i: (0, n) for i in range(n)}

    # ReduceScatter stages: after stage i each member of a group owns 1/f_i
    # of the shard it held before the stage.
    shard = size
    for si, f in enumerate(factors):
        st = Step()
        blk = shard / f
        for g in groups(si):
            assert len(g) == f
            start, length = rng[g[0]]       # shared across the group
            piece = length // f
            for ja, a in enumerate(g):
                for jb, b in enumerate(g):
                    if a != b:
                        sub = tuple(range(start + jb * piece,
                                          start + (jb + 1) * piece))
                        st.transfers.append(Transfer(ids[a], ids[b], blk,
                                                     blocks=sub))
            for ja, a in enumerate(g):
                own = tuple(range(start + ja * piece,
                                  start + (ja + 1) * piece))
                st.reduces.append(ReduceOp(ids[a], f, blk, blocks=own))
                rng[a] = (start + ja * piece, piece)
        p.steps.append(st)
        shard = blk

    # AllGather stages (reverse order, same groupings, no reduce).
    for si in reversed(range(len(factors))):
        f = factors[si]
        blk = shard
        st = Step()
        for g in groups(si):
            for a in g:
                sa, la = rng[a]
                sub = tuple(range(sa, sa + la))
                for b in g:
                    if a != b:
                        st.transfers.append(Transfer(ids[a], ids[b], blk,
                                                     blocks=sub))
            lo = min(rng[a][0] for a in g)
            length = sum(rng[a][1] for a in g)
            for a in g:
                rng[a] = (lo, length)
        p.steps.append(st)
        shard = shard * f
    return p


# ---------------------------------------------------------------------------
# Per-family builders (DESIGN.md §14). `size` follows each family's natural
# operand convention:
#   allgather_plan      — size = the FULL result vector (each server starts
#                         with its 1/n shard and ends with all of it);
#   reduce_scatter_plan — size = the full per-server input vector (each
#                         server ends with its reduced 1/n shard);
#   alltoall_plan       — size = the per-server operand (each server ships
#                         (n-1)/n of it and keeps its diagonal chunk);
#   p2p_plan            — size = the full buffer each edge moves.
# The evaluators need no changes: wire bytes, incast fan-in and memory
# passes fall out of the steps themselves (AG moves (n-1)/n of the result,
# AllToAll (n-1)/n of the operand, and neither folds anything).
# ---------------------------------------------------------------------------
def allgather_plan(n: int, size: float, servers: list[int] | None = None,
                   strategy: str = "ring") -> Plan:
    """Standalone AllGather: server i starts holding block i of the
    `size`-unit result; after the plan every server holds every block.

    strategy="ring": n-1 rounds of neighbor forwarding (block (i - a) mod n
    moves i → i+1 at round a — the AG half of the ring walk). "mesh": one
    full-mesh round (the CPS AG half: fan-in n-1, one α)."""
    ids = servers if servers is not None else list(range(n))
    blk = size / n
    p = Plan(f"allgather_{strategy}", n, size, servers=servers,
             num_blocks=n, family="allgather")
    if n == 1:
        return p
    if strategy == "mesh":
        st = Step()
        for i in range(n):
            for j in range(n):
                if i != j:
                    st.transfers.append(Transfer(ids[i], ids[j], blk,
                                                 blocks=(i,)))
        p.steps.append(st)
    elif strategy == "ring":
        for a in range(n - 1):
            st = Step()
            for i in range(n):
                b = (i - a) % n
                st.transfers.append(Transfer(ids[i], ids[(i + 1) % n], blk,
                                             blocks=(b,)))
            p.steps.append(st)
    else:
        raise ValueError(f"unknown allgather strategy: {strategy!r}")
    return p


def reduce_scatter_plan(n: int, size: float,
                        servers: list[int] | None = None,
                        strategy: str = "ring") -> Plan:
    """Standalone ReduceScatter: every server contributes a `size`-unit
    vector; server i ends owning the fully-reduced block i (canonical
    shard — `core.lower` appends the reorder movement when the walk's
    natural owner differs).

    strategy="ring": the n-1 fold rounds of the ring walk. "mesh": one
    full-mesh round (the CPS RS half, fan-in n)."""
    ids = servers if servers is not None else list(range(n))
    blk = size / n
    p = Plan(f"reduce_scatter_{strategy}", n, size, servers=servers,
             num_blocks=n, family="reduce_scatter")
    if n == 1:
        return p
    if strategy == "mesh":
        st = Step()
        for i in range(n):
            for j in range(n):
                if i != j:
                    st.transfers.append(Transfer(ids[i], ids[j], blk,
                                                 blocks=(j,)))
            st.reduces.append(ReduceOp(ids[i], n, blk, blocks=(i,)))
        p.steps.append(st)
    elif strategy == "ring":
        for s in range(n - 1):
            st = Step()
            for i in range(n):
                b = (i - s) % n
                st.transfers.append(Transfer(ids[i], ids[(i + 1) % n], blk,
                                             blocks=(b,)))
                st.reduces.append(ReduceOp(ids[(i + 1) % n], 2, blk,
                                           blocks=(b,)))
            p.steps.append(st)
    else:
        raise ValueError(f"unknown reduce_scatter strategy: {strategy!r}")
    return p


def alltoall_plan(n: int, size: float,
                  servers: list[int] | None = None) -> Plan:
    """Single-switch AllToAll: each server's `size`-unit operand is split
    into n destination chunks (block j = the chunk bound for server j);
    one full-mesh round ships the n-1 off-diagonal chunks — (n-1)/n·size
    wire units per server, fan-in n-1, zero reduces. Matches
    `lax.all_to_all(x.reshape(n, -1), axis, 0, 0)` up to the row→chunk
    transpose the lowered schedule performs."""
    ids = servers if servers is not None else list(range(n))
    blk = size / n
    p = Plan("alltoall", n, size, servers=servers, num_blocks=n,
             family="all_to_all")
    if n == 1:
        return p
    st = Step()
    for i in range(n):
        for j in range(n):
            if i != j:
                st.transfers.append(Transfer(ids[i], ids[j], blk,
                                             blocks=(j,)))
    p.steps.append(st)
    return p


def p2p_plan(n: int, size: float, servers: list[int] | None = None,
             pairs: list[tuple[int, int]] | None = None) -> Plan:
    """Point-to-point exchange: each (src, dst) pair moves the full
    `size`-unit buffer in one round — the pipeline-parallel boundary
    shift. Default pairs: the ring shift i → (i+1) mod n. Indices in
    `pairs` are positions (0..n-1), mapped through `servers`."""
    ids = servers if servers is not None else list(range(n))
    if pairs is None:
        pairs = [(i, (i + 1) % n) for i in range(n)] if n > 1 else []
    p = Plan("p2p", n, size, servers=servers, num_blocks=1, family="p2p")
    if not pairs:
        return p
    st = Step()
    for s, d in pairs:
        if s == d:
            raise ValueError(f"p2p pair with src == dst: {s}")
        st.transfers.append(Transfer(ids[s], ids[d], size, blocks=(0,)))
    p.steps.append(st)
    return p


def family_halves(plan: Plan) -> tuple[Plan, Plan]:
    """Kolmakov–Zhang decomposition (arXiv 2004.09362): split a
    block-annotated AllReduce plan at its last folding step into the
    standalone ReduceScatter-family prefix and the AllGather-family
    suffix. The AG half starts from the RS half's ownership layout —
    `core.lower` infers each block's initial holder from the steps, so
    any GenTree/builder AllReduce yields a lowerable RS and AG plan for
    free. Steps are shared by reference (treat them as read-only)."""
    if plan.family != "allreduce":
        raise ValueError(f"family_halves needs an allreduce plan, "
                         f"got family={plan.family!r}")
    folds = [i for i, st in enumerate(plan.steps) if st.reduces]
    if not folds:
        raise ValueError(f"plan {plan.name} has no reduces — cannot split")
    cut = folds[-1] + 1
    rs = Plan(plan.name + ":rs", plan.n, plan.size, steps=plan.steps[:cut],
              servers=plan.servers, num_blocks=plan.num_blocks,
              family="reduce_scatter")
    ag = Plan(plan.name + ":ag", plan.n, plan.size, steps=plan.steps[cut:],
              servers=plan.servers, num_blocks=plan.num_blocks,
              family="allgather")
    return rs, ag


def factorizations(n: int, max_factor: int | None = None,
                   max_steps: int = 3) -> list[list[int]]:
    """All ordered factorizations of n into 2..max_steps factors ≥2
    (optionally capped per-factor). Used by GenTree's plan-type search."""
    out: list[list[int]] = []

    def rec(rem: int, cur: list[int]):
        if len(cur) >= 2 and rem == 1:
            out.append(list(cur))
            return
        if len(cur) >= max_steps and rem != 1:
            return
        if rem == 1:
            return
        f = 2
        while f <= rem:
            if rem % f == 0 and (max_factor is None or f <= max_factor):
                cur.append(f)
                rec(rem // f, cur)
                cur.pop()
            f += 1

    rec(n, [])
    return out
