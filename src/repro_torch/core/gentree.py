"""GenTree — recursive AllReduce plan generation on tree topologies (paper §4).

Faithful reimplementation of Algorithms 1 & 2:

  * Algorithm 1 (`generate_basic_plan`): bottom-up computation of the
    initial/final data placement for every switch-local sub-tree. Each block
    is assigned to a destination server that already holds it under some
    child, preferring its own child's holdings ("taken" bookkeeping).
  * Algorithm 2 (`generate_final_plan`): per switch, (a) the *data
    rearrangement* decision per child (aggregate the child's scattered
    results onto a subset sized by the uplink convergence ratio before
    crossing the switch) and (b) *plan type selection* among
    CPS / m×n HCPS / Ring / RHD (balanced children) or Asymmetric CPS
    (unbalanced), each candidate priced by GenModel — here, by simulating
    the candidate's step IR with the incast-aware simulator, which embodies
    Eq. (11) on the actual tree.

The output is a complete AllReduce Plan IR (ReduceScatter + mirrored
AllGather), the per-switch decisions, and the predicted time.

Candidate search runs in one of two modes (DESIGN.md §7):

  * engine="fast" (default): candidates are *lowered* straight to integer
    holder/destination arrays (`_lowered_*`), every candidate for a switch
    is priced in one batched `FastEngine.totals` call, the shared
    `pre_steps` prefix (rearrangement moves) is compiled once and its cost
    reused across candidates, and only the winning candidate is
    materialized back into Plan IR.
  * engine="reference": the original per-candidate IR construction +
    pure-Python simulation, kept verbatim as the equivalence oracle and as
    the pre-PR baseline for `benchmarks/simfast_bench.py`'s speedup gate.

Both modes must select identical per-switch decisions (pinned in
tests/test_simfast.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cost_model import GenModelParams, PAPER_TABLE5
from .plans import Plan, ReduceOp, Step, Transfer, factorizations, ring as ring_plan, \
    rhd as rhd_plan, cps as cps_plan, hcps as hcps_plan
from .simulator import Simulator
from .topology import TopoNode


@dataclass
class SwitchDecision:
    algo: str
    factors: list[int] | None = None
    rearrange: dict[int, int] = field(default_factory=dict)  # child idx -> subset size
    cost: float = 0.0


@dataclass
class GenTreeResult:
    plan: Plan
    decisions: dict[str, SwitchDecision]
    predicted_time: float


# ---------------------------------------------------------------------------
# Algorithm 1 — basic placement
# ---------------------------------------------------------------------------
def generate_basic_plan(node: TopoNode, n_total: int,
                        place: dict[str, dict[int, list[int]]]) -> None:
    if node.is_server:
        place[node.name] = {node._sid: list(range(n_total))}
        return
    for c in node.children:
        generate_basic_plan(c, n_total, place)

    servers = node.server_ids()
    n = len(servers)
    num_blocks = n_total // n
    remain = n_total % n
    taken = [False] * n_total
    final: dict[int, list[int]] = {}
    quota: dict[int, int] = {}
    for c in node.children:
        for server, blocks in place[c.name].items():
            q = num_blocks + (1 if remain > 0 else 0)
            if remain > 0:
                remain -= 1
            quota[server] = q
            final[server] = []
            for b in blocks:
                if not taken[b]:
                    taken[b] = True
                    final[server].append(b)
                    q -= 1
                    if q == 0:
                        break
            quota[server] = q
    # Fix-up: hand any still-untaken blocks to servers with remaining quota.
    leftovers = [b for b in range(n_total) if not taken[b]]
    if leftovers:
        it = iter(leftovers)
        for server in final:
            while quota[server] > 0:
                try:
                    b = next(it)
                except StopIteration:
                    break
                final[server].append(b)
                taken[b] = True
                quota[server] -= 1
    place[node.name] = final


# ---------------------------------------------------------------------------
# Switch-local exchange IR builders (cross-children copy combining)
# ---------------------------------------------------------------------------
def _index_holders(children_places: list[dict[int, list[int]]],
                   n_total: int) -> list[dict[int, int]]:
    out = []
    for cp in children_places:
        m: dict[int, int] = {}
        for srv, blocks in cp.items():
            for b in blocks:
                m[b] = srv
        out.append(m)
    return out


def _exchange_steps_direct(holders: list[dict[int, int]],
                           dest: dict[int, int], unit: float) -> list[Step]:
    """One-shot CPS/ACPS across children: every copy goes straight to the
    destination server; one fused reduce of fan-in = #children there."""
    st = Step()
    recv_count: dict[tuple[int, int], int] = {}
    for hmap in holders:
        for b, h in hmap.items():
            d = dest[b]
            if h != d:
                st.transfers.append(Transfer(h, d, unit, blocks=(b,)))
            recv_count[(d, b)] = recv_count.get((d, b), 0) + 1
    for (d, b), c in recv_count.items():
        if c > 1:
            st.reduces.append(ReduceOp(d, c, unit, blocks=(b,)))
    return [st]


def _exchange_steps_hcps(holders: list[dict[int, int]],
                         dest: dict[int, int], unit: float,
                         factors: list[int]) -> list[Step]:
    """Staged combining of the c copies with fan-in factors[i] per stage."""
    cur = [dict(h) for h in holders]
    steps: list[Step] = []
    radix = 1
    for si, f in enumerate(factors):
        last = si == len(factors) - 1
        st = Step()
        nxt: list[dict[int, int]] = []
        for gstart in range(0, len(cur), f):
            group = cur[gstart:gstart + f]
            merged: dict[int, int] = {}
            for b in group[0]:
                cands = [g[b] for g in group]
                if last:
                    recv = dest[b]
                elif dest[b] in cands:
                    # keep the copy on the destination's side when possible
                    recv = dest[b]
                else:
                    # balanced, orthogonal receiver choice: pick the group
                    # member by the block's mixed-radix digit for this stage
                    recv = cands[(b // radix) % f]
                fan = 0
                for g in group:
                    h = g[b]
                    if h != recv:
                        st.transfers.append(Transfer(h, recv, unit,
                                                     blocks=(b,)))
                    fan += 1
                if fan > 1:
                    st.reduces.append(ReduceOp(recv, fan, unit, blocks=(b,)))
                merged[b] = recv
            nxt.append(merged)
        cur = nxt
        radix *= f
        steps.append(st)
    return steps


def _exchange_steps_chain(holders: list[dict[int, int]],
                          dest: dict[int, int], unit: float) -> list[Step]:
    """Ring-like pairwise chain across the c copies: c-1 steps, fan-in 2.

    Per block the chain visits every child's copy, ordered so a copy
    already sitting on the destination server is folded LAST — the chain
    then ends at dest with no extra hop. Blocks whose destination holds no
    copy need one trailing movement step. (The pre-block-IR version folded
    the accumulator "at dest" on the last step even when the last child's
    copy never moved there — unexecutable and underpriced.)"""
    c = len(holders)
    steps = [Step() for _ in range(c - 1)]
    move = Step()
    for b in holders[0]:
        hs = [h[b] for h in holders]
        order = list(range(c))
        for j, h in enumerate(hs):
            if h == dest[b]:
                order = order[:j] + order[j + 1:] + [j]
                break
        acc = hs[order[0]]
        for k, j in enumerate(order[1:]):
            nxt = hs[j]
            if acc != nxt:
                steps[k].transfers.append(Transfer(acc, nxt, unit,
                                                   blocks=(b,)))
            steps[k].reduces.append(ReduceOp(nxt, 2, unit, blocks=(b,)))
            acc = nxt
        if acc != dest[b]:
            move.transfers.append(Transfer(acc, dest[b], unit, blocks=(b,)))
    if move.transfers:
        steps.append(move)
    return steps


def _exchange_steps_rhd(holders: list[dict[int, int]],
                        dest: dict[int, int], unit: float) -> list[Step]:
    """Pairwise-tree combining (RHD reduce side) across c copies, c po2."""
    cur = [dict(h) for h in holders]
    steps: list[Step] = []
    while len(cur) > 1:
        last = len(cur) == 2
        st = Step()
        nxt = []
        for i in range(0, len(cur), 2):
            a, b_ = cur[i], cur[i + 1]
            merged = {}
            for blk in a:
                recv = dest[blk] if last else (
                    dest[blk] if dest[blk] in (a[blk], b_[blk]) else a[blk])
                for side in (a[blk], b_[blk]):
                    if side != recv:
                        st.transfers.append(Transfer(side, recv, unit,
                                                     blocks=(blk,)))
                st.reduces.append(ReduceOp(recv, 2, unit, blocks=(blk,)))
                merged[blk] = recv
            nxt.append(merged)
        cur = nxt
        steps.append(st)
    return steps


def _rearrange_step(child_place: dict[int, list[int]], subset: list[int],
                    unit: float) -> tuple[Step, dict[int, list[int]]]:
    """Aggregate a child's scattered blocks onto the `subset` servers
    (paper's data-rearrangement optimization). Pure data movement."""
    st = Step()
    new_place: dict[int, list[int]] = {s: [] for s in subset}
    i = 0
    for srv in sorted(child_place):
        for b in child_place[srv]:
            tgt = subset[i % len(subset)]
            i += 1
            if tgt != srv:
                st.transfers.append(Transfer(srv, tgt, unit, blocks=(b,)))
            new_place[tgt].append(b)
    return st, new_place


# ---------------------------------------------------------------------------
# Lowered (array-form) candidate builders — the batched search path.
#
# A candidate step is (src, dst, blk, red_srv, red_blk, fan): integer arrays
# of transfer endpoints + the block id each transfer carries, plus the
# reduce servers and the block each reduce folds; every transfer/reduce is
# sized `unit`. Each builder mirrors its `_exchange_steps_*` IR twin
# transfer-for-transfer (same multiset per step), so compiled costs match
# the reference engine; the block arrays ride along for free and are only
# touched when the winner is materialized back into (executable) Plan IR.
# ---------------------------------------------------------------------------
def _holder_row(child_place: dict[int, list[int]], n_total: int) -> np.ndarray:
    """block → holding server, as a dense array (the array `_index_holders`)."""
    row = np.empty(n_total, dtype=np.int64)
    for srv, blocks in child_place.items():
        row[blocks] = srv
    return row


def _lowered_direct(H: np.ndarray, D: np.ndarray) -> list[tuple]:
    c, B = H.shape
    mask = H != D
    src = H[mask]
    dst = np.broadcast_to(D, H.shape)[mask]
    blk = np.broadcast_to(np.arange(B), H.shape)[mask]
    rsrv = D if c > 1 else D[:0]
    rblk = np.arange(B) if c > 1 else np.arange(0)
    return [(src, dst, blk, rsrv, rblk, c)]


def _lowered_hcps(H: np.ndarray, D: np.ndarray,
                  factors: list[int]) -> list[tuple]:
    B = H.shape[1]
    blocks = np.arange(B)
    cur = H
    steps = []
    radix = 1
    for si, f in enumerate(factors):
        last = si == len(factors) - 1
        G = cur.reshape(-1, f, B)
        ng = G.shape[0]
        if last:
            recv = np.broadcast_to(D, (ng, B))
        else:
            has_dest = (G == D).any(axis=1)
            dig = (blocks // radix) % f
            pick = np.take_along_axis(
                G, np.broadcast_to(dig, (ng, 1, B)), axis=1)[:, 0, :]
            recv = np.where(has_dest, D, pick)
        mask = G != recv[:, None, :]
        src = G[mask]
        dst = np.broadcast_to(recv[:, None, :], G.shape)[mask]
        blk = np.broadcast_to(blocks, G.shape)[mask]
        steps.append((src, dst, blk, recv.ravel(),
                      np.broadcast_to(blocks, (ng, B)).ravel(), f))
        cur = recv
        radix *= f
    return steps


def _lowered_chain(H: np.ndarray, D: np.ndarray) -> list[tuple]:
    c, B = H.shape
    blocks = np.arange(B)
    # Per block, fold the copy already sitting on the destination LAST
    # (mirrors _exchange_steps_chain): stable argsort on a key that pushes
    # the first dest-holding child to the end of the visit order.
    eq = H == D
    has_dest = eq.any(axis=0)
    first_dest = np.argmax(eq, axis=0)
    child = np.arange(c)[:, None]
    key = np.where(has_dest & (child == first_dest), c, child)
    order = np.argsort(np.broadcast_to(key, H.shape), axis=0, kind="stable")
    Hord = np.take_along_axis(H, order, axis=0)
    acc = Hord[0]
    steps = []
    for i in range(1, c):
        nxt = Hord[i]
        mask = acc != nxt
        steps.append((acc[mask], nxt[mask], blocks[mask], nxt, blocks, 2))
        acc = nxt
    mask = acc != D
    if mask.any():
        steps.append((acc[mask], D[mask], blocks[mask],
                      D[:0], blocks[:0], 2))
    return steps


def _lowered_rhd(H: np.ndarray, D: np.ndarray) -> list[tuple]:
    B = H.shape[1]
    blocks = np.arange(B)
    cur = H
    steps = []
    while cur.shape[0] > 1:
        last = cur.shape[0] == 2
        a, b = cur[0::2], cur[1::2]
        if last:
            recv = np.broadcast_to(D, a.shape)
        else:
            recv = np.where((a == D) | (b == D), D, a)
        ma, mb = a != recv, b != recv
        src = np.concatenate([a[ma], b[mb]])
        dst = np.concatenate([np.broadcast_to(recv, a.shape)[ma],
                              np.broadcast_to(recv, b.shape)[mb]])
        bb = np.broadcast_to(blocks, a.shape)
        blk = np.concatenate([bb[ma], bb[mb]])
        steps.append((src, dst, blk, recv.ravel(),
                      np.broadcast_to(blocks, recv.shape).ravel(), 2))
        cur = recv
    return steps


def _compile_lowered(eng, steps: list[tuple], unit: float) -> list:
    out = []
    for src, dst, _blk, rsrv, _rblk, fan in steps:
        out.append(eng.compile_arrays(
            src, dst, unit, rsrv,
            (fan - 1) * unit, (fan + 1) * unit))
    return out


def _materialize(steps: list[tuple], unit: float) -> list[Step]:
    """Winning lowered candidate → Plan IR (only the winner pays this)."""
    out = []
    for src, dst, blk, rsrv, rblk, fan in steps:
        st = Step()
        st.transfers = [Transfer(s, d, unit, blocks=(b,))
                        for s, d, b in zip(src.tolist(), dst.tolist(),
                                           blk.tolist())]
        st.reduces = [ReduceOp(r, fan, unit, blocks=(b,))
                      for r, b in zip(rsrv.tolist(), rblk.tolist())]
        out.append(st)
    return out


# ---------------------------------------------------------------------------
# Algorithm 2 + assembly
# ---------------------------------------------------------------------------
def _merge_concurrent(step_lists: list[list[Step]]) -> list[Step]:
    """Zip-merge step lists of sibling switches (disjoint servers)."""
    out: list[Step] = []
    depth = max((len(sl) for sl in step_lists), default=0)
    for i in range(depth):
        st = Step()
        for sl in step_lists:
            if i < len(sl):
                st.transfers.extend(sl[i].transfers)
                st.reduces.extend(sl[i].reduces)
        out.append(st)
    return out


def _mirror(steps: list[Step]) -> list[Step]:
    """AllGather = reversed ReduceScatter with src/dst swapped, no reduces.
    Block annotations carry over: the mirrored transfer redistributes the
    finished value of the same blocks back along the reduce path."""
    out = []
    for st in reversed(steps):
        m = Step()
        m.transfers = [Transfer(t.dst, t.src, t.size, blocks=t.blocks)
                       for t in st.transfers]
        out.append(m)
    return out


def _switch_search_fast(eng, sw: TopoNode, place, eff_place, unit: float,
                        n_total: int, candidates, enable_rearrangement,
                        max_hcps_steps) -> tuple[list[Step], SwitchDecision]:
    """Batched, incremental Algorithm-2 search for one switch: lowered
    candidates, one `totals` call, pre_steps compiled once, winner-only
    IR materialization. Decision-equivalent to the reference branch."""
    D = np.empty(n_total, dtype=np.int64)
    for srv, blocks in place[sw.name].items():
        D[blocks] = srv
    c = len(sw.children)
    dec = SwitchDecision(algo="?")
    pre_ir: list[Step] = []
    pre_cost = 0.0

    # ---- rearrangement decision per child (Algorithm 2, lines 8-16).
    # The child's holder row doubles as the probe input, so each probe
    # compiles two one-step plans instead of re-simulating from IR.
    rows = []
    for ci, ch in enumerate(sw.children):
        cp = eff_place[ch.name]
        row = _holder_row(cp, n_total)
        if enable_rearrangement and not ch.is_server and len(cp) > 1:
            gc_bw = max(ch.children[0].uplink_bw, 1.0)
            k = max(1, min(len(ch.children),
                           -(-int(ch.uplink_bw) // int(gc_bw))))
            subset = [s for cc in ch.children[:k]
                      for s in cc.server_ids() if s in cp]
            if not subset:
                subset = sorted(cp)[:1]
            if len(subset) < len(cp):
                rstep, rplace = _rearrange_step(cp, subset, unit)
                row_r = _holder_row(rplace, n_total)
                rstep_cost = eng.step_cost(eng.compile_step(rstep))[0]
                probe_o = eng.total(_compile_lowered(
                    eng, _lowered_direct(row[None, :], D), unit))
                probe_r = rstep_cost + eng.total(_compile_lowered(
                    eng, _lowered_direct(row_r[None, :], D), unit))
                if probe_r < probe_o:
                    pre_ir.append(rstep)
                    pre_cost += rstep_cost
                    row = row_r
                    dec.rearrange[ci] = len(subset)
        rows.append(row)
    H = np.stack(rows)
    balanced = len({ch.num_servers() for ch in sw.children}) == 1

    # ---- plan type selection (Algorithm 2, lines 17-29), batched
    cands: list[tuple[str, list[int] | None, list[tuple]]] = []
    if balanced and c > 1:
        if "cps" in candidates:
            cands.append(("cps", None, _lowered_direct(H, D)))
        if "hcps" in candidates:
            for fac in factorizations(c, max_steps=max_hcps_steps):
                cands.append(("hcps", fac, _lowered_hcps(H, D, fac)))
        if "ring" in candidates and c > 2:
            cands.append(("ring", None, _lowered_chain(H, D)))
        if "rhd" in candidates and c > 1 and (c & (c - 1)) == 0:
            cands.append(("rhd", None, _lowered_rhd(H, D)))
    if not cands:
        cands.append(("acps", None, _lowered_direct(H, D)))

    costs = eng.totals([_compile_lowered(eng, steps, unit)
                        for _, _, steps in cands])
    bi = min(range(len(cands)),
             key=lambda i: (pre_cost + costs[i], cands[i][0],
                            tuple(cands[i][1] or ())))
    dec.algo, dec.factors = cands[bi][0], cands[bi][1]
    dec.cost = pre_cost + costs[bi]
    return pre_ir + _materialize(cands[bi][2], unit), dec


def _switch_search_reference(sim: Simulator, sw: TopoNode, place, eff_place,
                             unit: float, n_total: int, size: float,
                             candidates, enable_rearrangement,
                             max_hcps_steps) -> tuple[list[Step],
                                                      SwitchDecision]:
    """The pre-PR search: per-candidate IR construction + full simulation
    (including re-simulating the shared pre_steps prefix per candidate).
    Kept verbatim as the oracle the fast path is tested against."""
    def _eval(steps: list[Step]) -> float:
        return sim.simulate(Plan("tmp", n_total, size, steps=steps)).total

    dest = {}
    for srv, blocks in place[sw.name].items():
        for b in blocks:
            dest[b] = srv
    c = len(sw.children)
    dec = SwitchDecision(algo="?")
    pre_steps: list[Step] = []

    # ---- rearrangement decision per child (Algorithm 2, lines 8-16)
    # Subset = the servers under the first k of the child's own
    # children, k sized by the convergence ratio (paper §4.2): the
    # child's uplink bandwidth over one grandchild sub-tree's
    # uplink — enough senders to saturate the bottleneck, no more.
    child_places = []
    for ci, ch in enumerate(sw.children):
        cp = eff_place[ch.name]
        if (enable_rearrangement and not ch.is_server
                and len(cp) > 1):
            gc_bw = max(ch.children[0].uplink_bw, 1.0)
            k = max(1, min(len(ch.children),
                           -(-int(ch.uplink_bw) // int(gc_bw))))
            subset = [s for cc in ch.children[:k]
                      for s in cc.server_ids() if s in cp]
            if not subset:
                subset = sorted(cp)[:1]
            if len(subset) < len(cp):
                rstep, rplace = _rearrange_step(cp, subset, unit)
                # cost with vs without rearrangement for this child's
                # outbound traffic (priced on the direct exchange)
                probe_o = _exchange_steps_direct(
                    _index_holders([cp], n_total), dest, unit)
                probe_r = [rstep] + _exchange_steps_direct(
                    _index_holders([rplace], n_total), dest, unit)
                if _eval(probe_r) < _eval(probe_o):
                    pre_steps.append(rstep)
                    cp = rplace
                    dec.rearrange[ci] = len(subset)
        child_places.append(cp)

    holders = _index_holders(child_places, n_total)
    balanced = len({ch.num_servers() for ch in sw.children}) == 1

    # ---- plan type selection (Algorithm 2, lines 17-29)
    cands: list[tuple[str, list[int] | None, list[Step]]] = []
    if balanced and c > 1:
        if "cps" in candidates:
            cands.append(("cps", None,
                          _exchange_steps_direct(holders, dest, unit)))
        if "hcps" in candidates:
            for fac in factorizations(c, max_steps=max_hcps_steps):
                cands.append(("hcps", fac, _exchange_steps_hcps(
                    holders, dest, unit, fac)))
        if "ring" in candidates and c > 2:
            cands.append(("ring", None,
                          _exchange_steps_chain(holders, dest, unit)))
        if "rhd" in candidates and c > 1 and (c & (c - 1)) == 0:
            cands.append(("rhd", None,
                          _exchange_steps_rhd(holders, dest, unit)))
    if not cands:
        cands.append(("acps", None,
                      _exchange_steps_direct(holders, dest, unit)))

    best = min(cands, key=lambda x: (_eval(pre_steps + x[2]),
                                     x[0], tuple(x[1] or ())))
    dec.algo, dec.factors = best[0], best[1]
    dec.cost = _eval(pre_steps + best[2])
    return pre_steps + best[2], dec


def gentree(topo: TopoNode, size: float,
            params: dict[str, GenModelParams] | None = None,
            candidates: tuple[str, ...] = ("cps", "hcps", "ring", "rhd"),
            enable_rearrangement: bool = True,
            max_hcps_steps: int = 3,
            concurrent: bool = True,
            engine: str | None = None) -> GenTreeResult:
    """concurrent=True zip-merges sibling switch-local sub-plans (they
    touch disjoint servers and links, so real hardware runs them in
    parallel) — a beyond-paper scheduling improvement. concurrent=False
    reproduces the paper's stream-emulator behaviour (sub-plans issued
    sequentially), for apples-to-apples Table-7 comparisons.

    engine selects the candidate-pricing path: "fast" (default via
    Simulator / $REPRO_SIM_ENGINE) runs the batched compiled search,
    "reference" the pre-PR pure-Python one; both pick identical plans."""
    params = params or PAPER_TABLE5
    topo.finalize()
    n_total = topo.num_servers()
    unit = size / n_total
    sim = Simulator(topo, params, engine=engine)
    fast = sim.engine == "fast"
    eng = sim.fast_engine() if fast else None

    place: dict[str, dict[int, list[int]]] = {}
    generate_basic_plan(topo, n_total, place)

    decisions: dict[str, SwitchDecision] = {}
    # switches bottom-up, grouped by depth for concurrent merging
    depth_of: dict[str, int] = {}

    def _depth(node: TopoNode) -> int:
        if node.is_server:
            return 0
        d = 1 + max(_depth(c) for c in node.children)
        depth_of[node.name] = d
        return d

    _depth(topo)
    max_depth = depth_of.get(topo.name, 1)
    switches = topo.switches()

    rs_levels: list[list[Step]] = []
    # effective placement per child after its own subtree finished (+rearr)
    eff_place: dict[str, dict[int, list[int]]] = dict(place)

    for depth in range(1, max_depth + 1):
        level_steps: list[list[Step]] = []
        for sw in [s for s in switches if depth_of[s.name] == depth]:
            if fast:
                steps, dec = _switch_search_fast(
                    eng, sw, place, eff_place, unit, n_total,
                    candidates, enable_rearrangement, max_hcps_steps)
            else:
                steps, dec = _switch_search_reference(
                    sim, sw, place, eff_place, unit, n_total, size,
                    candidates, enable_rearrangement, max_hcps_steps)
            decisions[sw.name] = dec
            level_steps.append(steps)
            eff_place[sw.name] = place[sw.name]
        if concurrent:
            rs_levels.append(_merge_concurrent(level_steps))
        else:
            rs_levels.append([st for sl in level_steps for st in sl])

    rs_steps = [st for lvl in rs_levels for st in lvl]
    ag_steps = _mirror(rs_steps)
    full = Plan("gentree", n_total, size, steps=rs_steps + ag_steps,
                num_blocks=n_total)
    return GenTreeResult(plan=full, decisions=decisions,
                         predicted_time=sim.simulate(full).total)


# ---------------------------------------------------------------------------
# Baseline global plans routed over a tree (for Table 7 comparisons)
# ---------------------------------------------------------------------------
def baseline_plan(kind: str, topo: TopoNode, size: float) -> Plan:
    topo.finalize()
    ids = topo.server_ids()
    n = len(ids)
    if kind == "ring":
        return ring_plan(n, size, servers=ids)
    if kind == "rhd":
        return rhd_plan(n, size, servers=ids)
    if kind == "cps":
        return cps_plan(n, size, servers=ids)
    if kind.startswith("hcps:"):
        fac = [int(x) for x in kind.split(":", 1)[1].split("x")]
        return hcps_plan(fac, size, servers=ids)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Standalone per-family plans over a tree (DESIGN.md §14): the folding
# families are the Kolmakov–Zhang halves of the co-planned GenTree AllReduce —
# executing RS or AG alone runs exactly the half the AllReduce would —
# while the pure-movement families are flat single-step exchanges over
# the tree's server ids.
# ---------------------------------------------------------------------------
def family_plan(family: str, topo: TopoNode, size: float,
                params: dict[str, GenModelParams] | None = None,
                engine: str | None = None, **gentree_kwargs) -> Plan:
    from .plans import alltoall_plan, family_halves, p2p_plan
    topo.finalize()
    if family == "allreduce":
        return gentree(topo, size, params, engine=engine,
                       **gentree_kwargs).plan
    if family in ("reduce_scatter", "allgather"):
        res = gentree(topo, size, params, engine=engine, **gentree_kwargs)
        rs_half, ag_half = family_halves(res.plan)
        return rs_half if family == "reduce_scatter" else ag_half
    ids = topo.server_ids()
    if family == "all_to_all":
        return alltoall_plan(len(ids), size, servers=ids)
    if family == "p2p":
        return p2p_plan(len(ids), size, servers=ids)
    raise ValueError(f"unknown collective family {family!r}")
