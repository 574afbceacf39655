"""Compiled plan-evaluation engine (DESIGN.md §7).

The reference `core.simulator.Simulator` prices a Plan by walking
`topo.path_links()` per transfer in pure Python — correct, but the
dominant cost of cold GenTree generation at the Table-7 scales (hundreds
of candidate plans × thousands of transfers each). This module lowers a
`Plan` once into per-step numpy arrays and evaluates the full GenModel
step cost with vectorized reductions:

    t_step = α_eff + max_link(bytes/bw + incast) + max_server(compute)

Lowering uses the topology's `RoutingIndex` (built at `finalize()`): a
level-`l` ancestor of `src` lies strictly below the src↔dst LCA — and so
its uplink is on the path — exactly when it differs from `dst`'s level-`l`
ancestor, which turns per-transfer routing into `max_depth` vectorized
comparisons. Per-link byte totals and distinct-sender counts come from
`np.bincount` / `np.unique`; per-server reduce adds/mem_ops likewise.

The engine must agree with the reference simulator within 1e-9 on every
quantity (total, per_step, comm/compute/latency/incast_extra) — enforced
by `tests/test_simfast.py`. `Simulator.simulate` delegates here unless
constructed with `engine="reference"` (or `$REPRO_SIM_ENGINE=reference`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .cost_model import GenModelParams, PAPER_TABLE5
from .plans import Plan, Step
from .topology import TopoNode


@dataclass
class CompiledStep:
    """One Step lowered onto a RoutingIndex: everything the GenModel step
    cost needs, as dense arrays over touched links / servers only."""
    # links touched by at least one transfer (dense link ids, see
    # RoutingIndex: 2*node = up through node's uplink, 2*node+1 = down)
    lids: np.ndarray          # int64 (L,)
    lunits: np.ndarray        # float  (L,)  data units through the link
    lnsend: np.ndarray        # int64 (L,)  distinct senders on the link
    # receiving endpoints
    rdst: np.ndarray          # int64 (R,)  server ids with >=1 inbound flow
    runits: np.ndarray        # float  (R,)  units received
    rfan: np.ndarray          # int64 (R,)  distinct senders into the server
    # compute
    csrv: np.ndarray          # int64 (C,)  servers running reduces
    cadds: np.ndarray         # float  (C,)  γ-term ops
    cmem: np.ndarray          # float  (C,)  δ-term ops
    has_transfers: bool = False
    has_reduces: bool = False


@dataclass
class ParamTable:
    """GenModelParams spread onto the routing index's dense ids."""
    node_tpb: np.ndarray      # seconds per data unit through node's uplink
    node_lat: np.ndarray
    node_alpha: np.ndarray
    node_eps: np.ndarray
    node_wt: np.ndarray
    srv_tpb: np.ndarray       # per server-id NIC time per unit
    srv_eps: np.ndarray       # parent-level ε / w_t at the endpoint
    srv_wt: np.ndarray
    alpha_srv: float
    gamma: float
    delta: float


_EMPTY_I = np.empty(0, dtype=np.int64)
_EMPTY_F = np.empty(0)


class FastEngine:
    """Vectorized GenModel evaluator over a finalized topology."""

    def __init__(self, topo: TopoNode,
                 params: dict[str, GenModelParams] | None = None,
                 unit_bytes: int = 4, precision=None):
        self.topo = topo
        self.rx = topo.routing()
        self.params = params or PAPER_TABLE5
        self.unit = unit_bytes
        self.scale = unit_bytes / 4.0
        # Wire-format compression: transfers shrink by bytes_per_elem/4,
        # reduces pick up the quant/dequant memory passes (γ/δ). Applied at
        # compile_step so `compile_arrays` (the batched GenTree search path)
        # stays precision-agnostic. Same accounting as
        # `cost_model.evaluate_plan(precision=...)`.
        if precision is not None:
            from .cost_model import resolve_precision
            precision = resolve_precision(precision)
            if precision.name == "f32":
                precision = None
        self.precision = precision
        self.pt = self._build_param_table()

    def _p(self, level: str) -> GenModelParams:
        return self.params.get(level, self.params["server"])

    def _build_param_table(self) -> ParamTable:
        rx = self.rx
        lvl = [self._p(name) for name in rx.levels]
        lvl_alpha = np.array([p.alpha for p in lvl])
        lvl_eps = np.array([p.epsilon for p in lvl])
        lvl_wt = np.array([float(p.w_t) for p in lvl])
        bw = rx.link_bw
        # matches the reference: 0 time when bw == 0, else bytes/bw
        node_tpb = np.where(bw != 0.0,
                            self.unit / np.maximum(bw, 1e-30), 0.0)
        sbw = rx.srv_bw
        srv_tpb = np.where(sbw != 0.0,
                           self.unit / np.maximum(sbw, 1e-30), 0.0)
        psrv = self._p("server")
        return ParamTable(
            node_tpb=node_tpb, node_lat=rx.link_latency,
            node_alpha=lvl_alpha[rx.link_level],
            node_eps=lvl_eps[rx.link_level],
            node_wt=lvl_wt[rx.link_level],
            srv_tpb=srv_tpb,
            srv_eps=lvl_eps[rx.srv_level], srv_wt=lvl_wt[rx.srv_level],
            alpha_srv=psrv.alpha, gamma=psrv.gamma, delta=psrv.delta)

    # ---- lowering ----------------------------------------------------------
    def compile_arrays(self, src: np.ndarray, dst: np.ndarray,
                       size, red_srv: np.ndarray, red_adds,
                       red_mem) -> CompiledStep:
        """Lower a step already given as arrays (the batched GenTree search
        builds candidates in this form directly, no Transfer objects).
        `size` may be scalar (uniform transfers); red_adds/red_mem are the
        per-reduce γ/δ op counts, scalar or arrays aligned with red_srv."""
        rx = self.rx
        n_srv = rx.sid_cap    # server arrays are indexed by (sparse) _sid
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        size_arr = np.ascontiguousarray(
            np.broadcast_to(np.asarray(size, dtype=float), src.shape))

        has_t = src.size > 0
        if has_t:
            A = rx.anc[src]                     # (T, D+1)
            B = rx.anc[dst]
            lid_parts, tid_parts = [], []
            tindex = np.arange(src.size)
            for l in range(1, rx.max_depth + 1):
                a, b = A[:, l], B[:, l]
                neq = a != b
                mu = neq & (a != -1)
                md = neq & (b != -1)
                if mu.any():
                    lid_parts.append(2 * a[mu])
                    tid_parts.append(tindex[mu])
                if md.any():
                    lid_parts.append(2 * b[md] + 1)
                    tid_parts.append(tindex[md])
            if lid_parts:
                lid = np.concatenate(lid_parts)
                tid = np.concatenate(tid_parts)
            else:
                lid, tid = _EMPTY_I, _EMPTY_I
            nlinks = rx.n_links
            counts = np.bincount(lid, minlength=nlinks)
            units = np.bincount(lid, weights=size_arr[tid], minlength=nlinks)
            # distinct senders per link: unique (link, src) pairs
            ukey = np.unique(lid * n_srv + src[tid])
            nsend = np.bincount(ukey // n_srv, minlength=nlinks)
            lids = np.nonzero(counts)[0]
            lunits, lnsend = units[lids], nsend[lids]
            # endpoint aggregates
            rcount = np.bincount(dst, minlength=n_srv)
            rdst = np.nonzero(rcount)[0]
            runits = np.bincount(dst, weights=size_arr,
                                 minlength=n_srv)[rdst]
            pkey = np.unique(src * n_srv + dst)
            rfan = np.bincount(pkey % n_srv, minlength=n_srv)[rdst]
        else:
            lids, lunits, lnsend = _EMPTY_I, _EMPTY_F, _EMPTY_I
            rdst, runits, rfan = _EMPTY_I, _EMPTY_F, _EMPTY_I

        red_srv = np.asarray(red_srv, dtype=np.int64)
        has_r = red_srv.size > 0
        if has_r:
            adds = np.ascontiguousarray(np.broadcast_to(
                np.asarray(red_adds, dtype=float), red_srv.shape))
            mem = np.ascontiguousarray(np.broadcast_to(
                np.asarray(red_mem, dtype=float), red_srv.shape))
            ccount = np.bincount(red_srv, minlength=n_srv)
            csrv = np.nonzero(ccount)[0]
            cadds = np.bincount(red_srv, weights=adds, minlength=n_srv)[csrv]
            cmem = np.bincount(red_srv, weights=mem, minlength=n_srv)[csrv]
        else:
            csrv, cadds, cmem = _EMPTY_I, _EMPTY_F, _EMPTY_F

        return CompiledStep(lids=lids, lunits=lunits, lnsend=lnsend,
                            rdst=rdst, runits=runits, rfan=rfan,
                            csrv=csrv, cadds=cadds, cmem=cmem,
                            has_transfers=has_t, has_reduces=has_r)

    def compile_step(self, step: Step) -> CompiledStep:
        src = np.fromiter((t.src for t in step.transfers), dtype=np.int64,
                          count=len(step.transfers))
        dst = np.fromiter((t.dst for t in step.transfers), dtype=np.int64,
                          count=len(step.transfers))
        size = np.fromiter((t.size for t in step.transfers), dtype=float,
                           count=len(step.transfers))
        rsrv = np.fromiter((r.server for r in step.reduces), dtype=np.int64,
                           count=len(step.reduces))
        adds = np.fromiter((r.adds for r in step.reduces), dtype=float,
                           count=len(step.reduces))
        mem = np.fromiter((r.mem_ops for r in step.reduces), dtype=float,
                          count=len(step.reduces))
        p = self.precision
        if p is not None:
            size = size * p.comm_scale()
            rsize = np.fromiter((r.size for r in step.reduces), dtype=float,
                                count=len(step.reduces))
            adds = adds + p.extra_adds(rsize)
            mem = mem + p.extra_mem_ops(rsize)
        return self.compile_arrays(src, dst, size, rsrv, adds, mem)

    def compile_plan(self, plan: Plan) -> list[CompiledStep]:
        return [self.compile_step(st) for st in plan.steps]

    # ---- evaluation --------------------------------------------------------
    def step_cost(self, cs: CompiledStep
                  ) -> tuple[float, float, float, float, float]:
        """(t_step, comm, comp, alpha_eff, incast_extra) — identical
        accounting to the reference simulator's per-step loop."""
        pt = self.pt
        comm = 0.0
        incast = 0.0
        alpha_eff = pt.alpha_srv if cs.has_transfers else 0.0
        if cs.lids.size:
            nid = cs.lids >> 1
            extra = (np.maximum(cs.lnsend - pt.node_wt[nid], 0.0)
                     * cs.lunits * self.scale * pt.node_eps[nid])
            t_link = cs.lunits * pt.node_tpb[nid] + extra + pt.node_lat[nid]
            incast += float(extra.sum())
            comm = float(t_link.max())
            alpha_eff = max(alpha_eff, float(pt.node_alpha[nid].max()))
        if cs.rdst.size:
            w = cs.rfan + 1.0
            extra = (np.maximum(w - pt.srv_wt[cs.rdst], 0.0)
                     * cs.runits * self.scale * pt.srv_eps[cs.rdst])
            t_nic = cs.runits * pt.srv_tpb[cs.rdst] + extra
            incast += float(extra.sum())
            comm = max(comm, float(t_nic.max()))
        comp = 0.0
        if cs.csrv.size:
            comp = float(((cs.cadds * pt.gamma + cs.cmem * pt.delta)
                          * self.scale).max())
        if cs.has_reduces and not cs.has_transfers:
            alpha_eff = max(alpha_eff, pt.alpha_srv)
        return alpha_eff + comm + comp, comm, comp, alpha_eff, incast

    def total(self, compiled: Sequence[CompiledStep]) -> float:
        t = 0.0
        for cs in compiled:
            t += self.step_cost(cs)[0]
        return t

    # ---- link-contention pricing (DESIGN.md §15) ---------------------------
    def merge_steps(self, parts: Sequence[CompiledStep]) -> CompiledStep:
        """Occupancy merge of concurrent rounds: shared links serialize
        (units add) and their distinct-sender counts — hence incast
        fan-ins — SUM; disjoint links keep their own time and overlap
        through `step_cost`'s per-link max. Vectorized twin of
        `cost_model.LinkOccupancy.merge` (must agree ≤ 1e-9)."""
        parts = [cs for cs in parts if cs is not None]
        if len(parts) == 1:
            return parts[0]
        nlinks, nsrv = self.rx.n_links, self.rx.sid_cap
        lu = np.zeros(nlinks)
        ln = np.zeros(nlinks, dtype=np.int64)
        ltouch = np.zeros(nlinks, dtype=bool)
        ru = np.zeros(nsrv)
        rf = np.zeros(nsrv, dtype=np.int64)
        rtouch = np.zeros(nsrv, dtype=bool)
        ca = np.zeros(nsrv)
        cm = np.zeros(nsrv)
        ctouch = np.zeros(nsrv, dtype=bool)
        has_t = has_r = False
        for cs in parts:
            if cs.lids.size:
                np.add.at(lu, cs.lids, cs.lunits)
                np.add.at(ln, cs.lids, cs.lnsend)
                ltouch[cs.lids] = True
            if cs.rdst.size:
                np.add.at(ru, cs.rdst, cs.runits)
                np.add.at(rf, cs.rdst, cs.rfan)
                rtouch[cs.rdst] = True
            if cs.csrv.size:
                np.add.at(ca, cs.csrv, cs.cadds)
                np.add.at(cm, cs.csrv, cs.cmem)
                ctouch[cs.csrv] = True
            has_t |= cs.has_transfers
            has_r |= cs.has_reduces
        lids = np.nonzero(ltouch)[0]
        rdst = np.nonzero(rtouch)[0]
        csrv = np.nonzero(ctouch)[0]
        return CompiledStep(lids=lids, lunits=lu[lids], lnsend=ln[lids],
                            rdst=rdst, runits=ru[rdst], rfan=rf[rdst],
                            csrv=csrv, cadds=ca[csrv], cmem=cm[csrv],
                            has_transfers=has_t, has_reduces=has_r)

    def concurrent_cost(self, parts: Sequence[CompiledStep]
                        ) -> tuple[float, float, float, float, float]:
        """Contended cost of ≥1 rounds running concurrently — one merged
        fan-in SUMS the incast: two below-threshold rounds can together
        cross w_t, so this may exceed the two sequential costs. That is
        the signal the planner's argmin{sequential, merged} keys on."""
        return self.step_cost(self.merge_steps(parts))

    def contended_pair_total(self, ca: Sequence[CompiledStep],
                             cb: Sequence[CompiledStep]) -> float:
        """Two compiled step lists run concurrently, paired round-by-round
        (leftover rounds of the longer list price alone). Mirrors
        `cost_model.contended_pair_time` at ≤ 1e-9."""
        t = 0.0
        for i in range(max(len(ca), len(cb))):
            parts = []
            if i < len(ca):
                parts.append(ca[i])
            if i < len(cb):
                parts.append(cb[i])
            t += self.step_cost(self.merge_steps(parts))[0]
        return t

    def contended_halves_total(self, plan_a: Plan, plan_b: Plan) -> float:
        """Contended concurrent price of two whole plans (e.g. the RS half
        of bucket k against the AG half of bucket k-1)."""
        return self.contended_pair_total(self.compile_plan(plan_a),
                                         self.compile_plan(plan_b))

    def contended_halves(self, plan: Plan) -> float:
        """Steady-state joint time of an allreduce plan's own halves run
        concurrently (the bucket pipeline's inner term). Non-allreduce
        plans have a single half — their contended time is just the total."""
        from .plans import family_halves
        if plan.family != "allreduce":
            return self.total(self.compile_plan(plan))
        rs, ag = family_halves(plan)
        return self.contended_halves_total(rs, ag)

    def totals(self, batch: Sequence[Sequence[CompiledStep]]) -> list[float]:
        """Batched candidate evaluation: one call prices every candidate's
        compiled step list (the GenTree per-switch search path)."""
        return [self.total(compiled) for compiled in batch]

    def halves_totals(self, plan: Plan) -> tuple[float, float]:
        """(t_rs, t_ag): the plan priced as its two pipeline stages.

        An allreduce plan splits at its Kolmakov–Zhang cut (the last
        fold step — `plans.family_halves`), the stages `bucketing.
        pipelined_time` and `get_step_plan` overlap. A standalone
        family plan prices entirely on its own side; pure-movement
        families (allgather/all_to_all/p2p) count as AG-stage work."""
        from .plans import family_halves
        if plan.family == "allreduce":
            rs, ag = family_halves(plan)
            return (self.total(self.compile_plan(rs)),
                    self.total(self.compile_plan(ag)))
        t = self.total(self.compile_plan(plan))
        if plan.family == "reduce_scatter":
            return t, 0.0
        return 0.0, t

    def simulate(self, plan: Plan):
        """Full SimResult, field-for-field compatible with the reference."""
        from .simulator import SimResult
        res = SimResult(total=0.0)
        for st in plan.steps:
            t, comm, comp, alpha, incast = self.step_cost(
                self.compile_step(st))
            res.per_step.append(t)
            res.total += t
            res.comm += comm
            res.compute += comp
            res.latency += alpha
            res.incast_extra += incast
        return res
