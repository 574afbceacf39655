"""Flow-level, incast-aware AllReduce simulator (paper §5.3).

Simulates a Plan IR over a tree topology. Per synchronized step:

    t_step = α_eff + max_link(bytes/bw + incast) + max_server(compute)

* every transfer is routed src→dst over tree links (full duplex: 'up' and
  'down' directions of an uplink are independent capacities);
* incast applies wherever distinct flows funnel into one link or endpoint
  beyond that level's threshold w_t:  extra = max(flows − w_t, 0)·bytes·ε;
* compute cost on each server uses the γ (adds) and δ (memory ops) terms;
* α_eff is the max per-round launch latency across the levels touched
  (cross-DC rounds pay the WAN α, paper Table 5).

Deterministic, no wall-clock dependence.

This module is the *reference oracle*: `simulate()` delegates to the
compiled engine (`core.simfast.FastEngine`, DESIGN.md §7) unless the
simulator is constructed with `engine="reference"` or
`$REPRO_SIM_ENGINE=reference` is set; `simulate_reference()` always runs
the pure-Python path. The two must agree within 1e-9 on every SimResult
field (tests/test_simfast.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from .cost_model import GenModelParams, PAPER_TABLE5
from .plans import Plan
from .topology import TopoNode


@dataclass
class SimResult:
    total: float
    per_step: list[float] = field(default_factory=list)
    comm: float = 0.0
    compute: float = 0.0
    latency: float = 0.0
    incast_extra: float = 0.0


class Simulator:
    def __init__(self, topo: TopoNode,
                 params: dict[str, GenModelParams] | None = None,
                 unit_bytes: int = 4, engine: str | None = None):
        self.topo = topo
        self.params = params or PAPER_TABLE5
        self.unit = unit_bytes
        self._srv = {s._sid: s for s in topo.servers()}
        self.engine = (engine or os.environ.get("REPRO_SIM_ENGINE")
                       or "fast")
        if self.engine not in ("fast", "reference"):
            raise ValueError(f"unknown sim engine {self.engine!r}")
        self._fast = None

    def _p(self, level: str) -> GenModelParams:
        return self.params.get(level, self.params["server"])

    def fast_engine(self):
        """The shared compiled engine for this (topo, params, unit)."""
        if self._fast is None:
            from .simfast import FastEngine
            self._fast = FastEngine(self.topo, self.params, self.unit)
        return self._fast

    def simulate(self, plan: Plan) -> SimResult:
        if self.engine == "fast":
            return self.fast_engine().simulate(plan)
        return self.simulate_reference(plan)

    def simulate_reference(self, plan: Plan) -> SimResult:
        res = SimResult(total=0.0)
        for st in plan.steps:
            # ---- route flows onto links ----------------------------------
            link_bytes: dict[tuple[int, str], float] = {}
            link_flows: dict[tuple[int, str], set] = {}
            link_node: dict[tuple[int, str], TopoNode] = {}
            # All sizes below stay in data units (floats); GenModel params
            # are per-float; link bandwidths are bytes/s.
            scale = self.unit / 4.0  # rescale per-float params if unit != 4B
            for t in st.transfers:
                src, dst = self._srv[t.src], self._srv[t.dst]
                for node, dirn in self.topo.path_links(src, dst):
                    key = (id(node), dirn)
                    link_bytes[key] = link_bytes.get(key, 0.0) + t.size
                    link_flows.setdefault(key, set()).add((t.src, t.dst))
                    link_node[key] = node

            comm = 0.0
            incast_extra = 0.0
            alpha_eff = self._p("server").alpha if st.transfers else 0.0
            for key, units in link_bytes.items():
                node = link_node[key]
                lvl = node.parent.level if node.parent is not None else node.level
                p = self._p(lvl)
                base = units * self.unit / max(node.uplink_bw, 1e-30) \
                    if node.uplink_bw else 0.0
                # incast at this link: distinct SENDERS converging on it
                # (many-to-one is what triggers PFC pause storms; fan-out
                # from one sender does not). The paper's data rearrangement
                # wins exactly by shrinking this count on the WAN link.
                nflow = len({f[0] for f in link_flows[key]})
                extra = max(nflow - p.w_t, 0) * units * scale * p.epsilon
                incast_extra += extra
                comm = max(comm, base + extra + node.uplink_latency)
                alpha_eff = max(alpha_eff, p.alpha)
            # endpoint incast at receiving server NICs — priced with the
            # parent switch's ε (paper attributes incast to the fabric level)
            psrv = self._p("server")
            fi = st.fan_in_by_dst()
            for dst, units in st.recv_bytes_by_dst().items():
                srv = self._srv[dst]
                plvl = self._p(srv.parent.level if srv.parent else "root_sw")
                w = fi.get(dst, 0) + 1  # paper counts the receiver's own block
                extra = max(w - plvl.w_t, 0) * units * scale * plvl.epsilon
                incast_extra += extra
                nic = srv.uplink_bw
                t_nic = units * self.unit / max(nic, 1e-30) if nic else 0.0
                comm = max(comm, t_nic + extra)

            # ---- compute --------------------------------------------------
            comp = 0.0
            by_srv: dict[int, tuple[float, float]] = {}
            for r in st.reduces:
                a, d = by_srv.get(r.server, (0.0, 0.0))
                by_srv[r.server] = (a + r.adds, d + r.mem_ops)
            for a, d in by_srv.values():
                comp = max(comp, (a * psrv.gamma + d * psrv.delta) * scale)
            if st.reduces and not st.transfers:
                alpha_eff = max(alpha_eff, psrv.alpha)

            t_step = alpha_eff + comm + comp
            res.per_step.append(t_step)
            res.total += t_step
            res.comm += comm
            res.compute += comp
            res.latency += alpha_eff
            res.incast_extra += incast_extra
        return res
