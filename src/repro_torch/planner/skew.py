"""Arrival-skew pricing: expected AllReduce cost under imbalanced arrivals.

GenModel (and the synchronized simulator) assume every server enters the
collective at t=0. Real training steps don't: stragglers, imbalanced
process-arrival patterns (Proficz; Faraj/Patarasuk/Yuan) and multi-job
interference stagger the start times, and the *ranking* of plan types
changes — heavily pipelined or high-fan-in plans lose their edge when the
cost after the last arrival is what matters.

Model: an arrival-gated per-server dataflow over the Plan IR. Each server
carries a clock that starts at its arrival offset; a step's transfers
leave when the sender's clock allows, and a receiver's reduce completes
only when the slowest input has arrived. Two effects fall out naturally:

  * work not depending on a late server overlaps the wait, so few-round
    plans (CPS) recover faster than long pipelines once skew dominates;
  * incast is charged only on flows that arrive *simultaneously* (within
    one launch latency α of the last one) — staggered arrivals drain
    buffers instead of overflowing them, so the ε penalty that made CPS
    lose under synchronized starts fades as skew grows.

Pricing is NIC-granularity (per-server uplinks, γ/δ compute, per-level α
and ε) and intentionally ignores shared upper-link contention: it is a
*comparative* model, not a replacement for core.simulator. Plan selection
therefore anchors on the simulator: each candidate is priced as its
synchronized simulator cost plus the *arrival-gated delta* (expected gated
time under the skew draws minus gated time at zero offsets), so at zero
skew the ranking is exactly the synchronized simulator's, and only the
skew-induced difference comes from this model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import GenModelParams, PAPER_TABLE5
from repro_torch.core.plans import Plan
from repro_torch.core.topology import TopoNode


SKEW_DISTS = ("exponential", "uniform", "none", "empirical")


@dataclass(frozen=True)
class SkewModel:
    """Distribution of per-server arrival offsets (seconds).

    dist: "exponential" | "uniform" | "none" | "empirical"; `frac` is
    the fraction of servers that are skewed at all (the rest arrive at
    t=0); `draws` Monte-Carlo draws from a fixed seed keep pricing
    deterministic.

    The *empirical* mode prices measured arrival patterns instead of
    synthetic draws: `offsets` holds per-device arrival offsets observed
    by the runtime telemetry (`runtime.telemetry.ArrivalEstimator`), and
    each draw bootstrap-resamples that pool onto the topology's servers
    — build one with `SkewModel.from_offsets(...)` or let
    `PlannerService.adopt_empirical_skew()` do it from live telemetry.

    The distribution is validated eagerly at construction — an unknown
    `dist` (or an empirical model without offsets) fails here, not deep
    inside the pricing draw loop.
    """
    dist: str = "exponential"
    scale: float = 0.0
    frac: float = 1.0
    draws: int = 8
    seed: int = 0
    offsets: tuple[float, ...] | None = None    # empirical mode only

    def __post_init__(self):
        if self.dist not in SKEW_DISTS:
            raise ValueError(f"unknown skew dist {self.dist!r}; "
                             f"expected one of {SKEW_DISTS}")
        if self.dist == "empirical" and not self.offsets:
            raise ValueError("empirical skew needs measured offsets; "
                             "use SkewModel.from_offsets(...)")

    @classmethod
    def from_offsets(cls, offsets, draws: int = 8, seed: int = 0,
                     frac: float = 1.0) -> "SkewModel":
        """Empirical model from measured per-device arrival offsets
        (seconds; normalized so the earliest arrival is 0). `scale` is
        set to the worst observed offset so zero-skew fast paths (`scale
        > 0` gates in the service) behave correctly."""
        offs = tuple(sorted(max(float(o), 0.0) for o in offsets))
        if not offs:
            raise ValueError("empirical skew needs at least one offset")
        base = min(offs)
        offs = tuple(o - base for o in offs)
        return cls(dist="empirical", scale=max(offs), frac=frac,
                   draws=draws, seed=seed, offsets=offs)

    def key(self) -> tuple:
        return (self.dist, "%.9g" % self.scale, "%.9g" % self.frac,
                self.draws, self.seed,
                None if self.offsets is None
                else tuple("%.9g" % o for o in self.offsets))


def draw_offsets(model: SkewModel, n: int) -> np.ndarray:
    """(draws, n) matrix of non-negative arrival offsets."""
    if model.dist == "none" or model.scale <= 0.0:
        return np.zeros((1, n))
    rng = np.random.default_rng(model.seed)
    out = np.zeros((model.draws, n))
    k = max(1, int(round(model.frac * n)))
    pool = None if model.offsets is None else np.asarray(model.offsets)
    for d in range(model.draws):
        idx = rng.permutation(n)[:k]
        if model.dist == "exponential":
            out[d, idx] = rng.exponential(model.scale, size=k)
        elif model.dist == "uniform":
            out[d, idx] = rng.uniform(0.0, model.scale, size=k)
        elif model.dist == "empirical":
            # bootstrap-resample the measured pool onto the skewed
            # servers: topology sizes need not match the measured device
            # count, and resampling keeps pricing a *distribution* (with
            # the fixed seed keeping it deterministic)
            out[d, idx] = pool[rng.integers(0, len(pool), size=k)]
        else:                       # unreachable: validated eagerly
            raise ValueError(f"unknown skew dist {model.dist!r}")
    return out


def arrival_gated_time(plan: Plan, topo: TopoNode,
                       params: Mapping[str, GenModelParams] | None = None,
                       offsets: Sequence[float] | None = None,
                       unit_bytes: int = 4) -> float:
    """Completion time of `plan` on `topo` with per-server arrival offsets
    (indexed by server id; missing/None = all zero)."""
    params = params or PAPER_TABLE5
    psrv = params.get("server", GenModelParams())

    def _p(level: str) -> GenModelParams:
        return params.get(level, psrv)

    srv = {s._sid: s for s in topo.servers()}
    scale = unit_bytes / 4.0
    clock = {sid: 0.0 for sid in srv}
    if offsets is not None:
        for i, sid in enumerate(sorted(srv)):
            if i < len(offsets):
                clock[sid] = float(offsets[i])

    for st in plan.steps:
        send_units: dict[int, float] = {}
        senders_to: dict[int, list[int]] = {}
        for t in st.transfers:
            send_units[t.src] = send_units.get(t.src, 0.0) + t.size
            senders_to.setdefault(t.dst, []).append(t.src)
        recv_units = st.recv_bytes_by_dst()
        comp: dict[int, float] = {}
        for r in st.reduces:
            comp[r.server] = comp.get(r.server, 0.0) + (
                r.adds * psrv.gamma + r.mem_ops * psrv.delta) * scale

        participants = set(send_units) | set(recv_units) | set(comp)
        if not participants:
            continue

        start: dict[int, float] = {}
        send_done: dict[int, float] = {}
        for s in participants:
            node = srv[s]
            lvl = node.parent.level if node.parent is not None else "server"
            start[s] = clock[s] + max(_p(lvl).alpha, psrv.alpha)
        for s, units in send_units.items():
            node = srv[s]
            bw = node.uplink_bw
            t_send = units * unit_bytes / bw if bw else 0.0
            send_done[s] = start[s] + t_send + node.uplink_latency

        new_clock = dict(clock)
        for s in participants:
            t = start[s]
            if s in send_done:
                t = max(t, send_done[s])
            if s in recv_units:
                node = srv[s]
                plvl = _p(node.parent.level if node.parent else "root_sw")
                arrivals = [send_done[src] for src in senders_to[s]]
                last = max(arrivals)
                # incast: only flows landing within one round latency of
                # the last one overflow buffers together (+1 for self)
                w = sum(1 for a in arrivals if a >= last - plvl.alpha) + 1
                extra = max(w - plvl.w_t, 0) * recv_units[s] * scale \
                    * plvl.epsilon
                bw = node.uplink_bw
                t_recv = recv_units[s] * unit_bytes / bw if bw else 0.0
                t = max(t, last + t_recv + extra)
            t += comp.get(s, 0.0)
            new_clock[s] = t
        clock = new_clock
    return max(clock.values()) if clock else 0.0


# ---------------------------------------------------------------------------
# Batched arrival-gated pricing (DESIGN.md §7): the same dataflow as
# `arrival_gated_time`, but the per-step quantities are precompiled into
# arrays once per plan and every Monte-Carlo draw advances in lockstep as a
# row of a (draws, servers) clock matrix. `arrival_gated_time` above stays
# the reference oracle (tests/test_torch_planner_skew.py holds both against
# the JAX package's).
# ---------------------------------------------------------------------------
class _GatedPlan:
    """Per-step static arrays for the arrival-gated dataflow."""

    def __init__(self, plan: Plan, topo: TopoNode,
                 params: Mapping[str, GenModelParams] | None,
                 unit_bytes: int):
        params = params or PAPER_TABLE5
        psrv = params.get("server", GenModelParams())

        def _p(level: str) -> GenModelParams:
            return params.get(level, psrv)

        srv = {s._sid: s for s in topo.servers()}
        # arrays are indexed by _sid; for a subtree of a larger finalized
        # tree the ids are a sparse subset, so size by the largest id
        self.sids = np.array(sorted(srv), dtype=np.int64)
        self.n = int(self.sids[-1]) + 1 if len(srv) else 0
        n = self.n
        scale = unit_bytes / 4.0
        # static per-server tables
        alpha_start = np.zeros(n)
        bw = np.zeros(n)
        lat = np.zeros(n)
        r_eps = np.zeros(n)
        r_wt = np.zeros(n)
        r_alpha = np.zeros(n)
        for sid, node in srv.items():
            lvl = node.parent.level if node.parent is not None else "server"
            alpha_start[sid] = max(_p(lvl).alpha, psrv.alpha)
            bw[sid] = node.uplink_bw
            lat[sid] = node.uplink_latency
            plvl = _p(node.parent.level if node.parent else "root_sw")
            r_eps[sid], r_wt[sid] = plvl.epsilon, float(plvl.w_t)
            r_alpha[sid] = plvl.alpha
        self.alpha_start, self.lat = alpha_start, lat
        self.r_eps, self.r_wt, self.r_alpha = r_eps, r_wt, r_alpha

        self.steps = []
        for st in plan.steps:
            src = np.fromiter((t.src for t in st.transfers), np.int64,
                              len(st.transfers))
            dst = np.fromiter((t.dst for t in st.transfers), np.int64,
                              len(st.transfers))
            size = np.fromiter((t.size for t in st.transfers), float,
                               len(st.transfers))
            rsrv = np.fromiter((r.server for r in st.reduces), np.int64,
                               len(st.reduces))
            cval = np.fromiter(
                ((r.adds * psrv.gamma + r.mem_ops * psrv.delta) * scale
                 for r in st.reduces), float, len(st.reduces))
            send_units = np.bincount(src, weights=size, minlength=n)
            recv_units = np.bincount(dst, weights=size, minlength=n)
            senders = np.nonzero(np.bincount(src, minlength=n))[0]
            rdst = np.nonzero(np.bincount(dst, minlength=n))[0]
            comp = np.bincount(rsrv, weights=cval, minlength=n)
            csrv = np.nonzero(np.bincount(rsrv, minlength=n))[0]
            part = np.union1d(np.union1d(senders, rdst), csrv)
            if part.size == 0:
                continue
            sbw = np.where(bw[senders] != 0.0, bw[senders], 1.0)
            t_send = np.where(bw[senders] != 0.0,
                              send_units[senders] * unit_bytes / sbw, 0.0)
            rbw = np.where(bw[rdst] != 0.0, bw[rdst], 1.0)
            t_recv = np.where(bw[rdst] != 0.0,
                              recv_units[rdst] * unit_bytes / rbw, 0.0)
            self.steps.append({
                "part": part, "senders": senders, "t_send": t_send,
                "pairs_src": src, "pairs_dst": dst,
                "rdst": rdst, "t_recv": t_recv,
                "recv_units": recv_units[rdst] * scale,
                "csrv": csrv, "comp": comp[csrv]})

    def times(self, offsets: np.ndarray) -> np.ndarray:
        """Completion time per draw; offsets rows map positionally onto
        the sorted server ids (extra columns ignored, missing ones
        zero-filled), as in the reference."""
        offsets = np.asarray(offsets, dtype=float)
        if offsets.ndim == 1:
            offsets = offsets[None, :]
        nd, n = offsets.shape[0], self.n
        clock = np.zeros((nd, n))
        k = min(len(self.sids), offsets.shape[1])
        clock[:, self.sids[:k]] = offsets[:, :k]
        rows = np.arange(nd)[:, None]
        neg = np.finfo(float).min
        for sp in self.steps:
            part, senders, rdst = sp["part"], sp["senders"], sp["rdst"]
            start = clock + self.alpha_start[None, :]
            send_done = np.full((nd, n), neg)
            send_done[:, senders] = (start[:, senders] + sp["t_send"]
                                     + self.lat[senders])
            t = start.copy()
            t[:, senders] = np.maximum(t[:, senders], send_done[:, senders])
            if rdst.size:
                psrc, pdst = sp["pairs_src"], sp["pairs_dst"]
                last = np.full((nd, n), neg)
                np.maximum.at(last, (rows, pdst[None, :]),
                              send_done[:, psrc])
                cnt = np.zeros((nd, n))
                np.add.at(cnt, (rows, pdst[None, :]),
                          (send_done[:, psrc]
                           >= last[:, pdst] - self.r_alpha[pdst]))
                w = cnt[:, rdst] + 1.0
                extra = (np.maximum(w - self.r_wt[rdst], 0.0)
                         * sp["recv_units"] * self.r_eps[rdst])
                t[:, rdst] = np.maximum(
                    t[:, rdst], last[:, rdst] + sp["t_recv"] + extra)
            if sp["csrv"].size:
                t[:, sp["csrv"]] += sp["comp"]
            clock[:, part] = t[:, part]
        if not len(self.sids):
            return np.zeros(nd)
        return clock[:, self.sids].max(axis=1)


def gated_times(plan: Plan, topo: TopoNode,
                params: Mapping[str, GenModelParams] | None = None,
                offsets: np.ndarray | None = None,
                unit_bytes: int = 4) -> np.ndarray:
    """Batched `arrival_gated_time`: one row of `offsets` per draw."""
    gp = _GatedPlan(plan, topo, params, unit_bytes)
    if offsets is None:
        offsets = np.zeros((1, gp.n))
    return gp.times(offsets)


def expected_time(plan: Plan, topo: TopoNode, model: SkewModel,
                  params: Mapping[str, GenModelParams] | None = None,
                  unit_bytes: int = 4) -> float:
    """Mean arrival-gated completion time over the model's draws."""
    offs = draw_offsets(model, topo.num_servers())
    return float(np.mean(gated_times(plan, topo, params, offs, unit_bytes)))


def pick_plan_under_skew(candidates: Sequence[tuple[str, Plan]],
                         topo: TopoNode, model: SkewModel,
                         params: Mapping[str, GenModelParams] | None = None,
                         unit_bytes: int = 4, engine: str | None = None
                         ) -> tuple[str, Plan, float]:
    """argmin of simulator cost + arrival-gated skew delta (see module
    docstring); deterministic tie-break on name. The gated model only
    contributes the *difference* skew makes, so at zero skew this reduces
    to the synchronized simulator ranking. Each candidate is compiled once
    (`_GatedPlan`) and priced over all draws plus the zero-offset baseline
    in a single batched pass; `engine` selects the synchronized-cost
    evaluator (fast compiled engine by default)."""
    from repro_torch.core.simulator import Simulator

    if not candidates:
        raise ValueError("no candidate plans")
    sim = Simulator(topo, dict(params) if params else None,
                    unit_bytes=unit_bytes, engine=engine)
    n = topo.num_servers()
    offs = draw_offsets(model, n)
    priced = []
    for name, p in candidates:
        sync = sim.simulate(p).total
        gp = _GatedPlan(p, topo, params, unit_bytes)
        # draws + one zero-offset row, one batched evaluation per plan
        ts = gp.times(np.vstack([offs, np.zeros((1, n))]))
        delta = float(np.mean(ts[:-1])) - float(ts[-1])
        priced.append((sync + max(delta, 0.0), name, p))
    priced.sort(key=lambda x: (x[0], x[1]))
    cost, name, plan = priced[0]
    return name, plan, cost
