"""GenModel — the paper's AllReduce time-cost model (§3).

    T = A·α + B·β + C·γ + D·δ + max(w − w_t, 0)·B·ε      (Eq. 11)

Closed forms for the classic plan types (Table 2) plus a generic evaluator
that walks a Plan IR step by step. The generic evaluator agrees with the
closed forms on single-switch networks (property-tested).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from .plans import Plan, factorizations


# ---------------------------------------------------------------------------
# Wire precision — compression priced honestly (DESIGN.md §13).
#
# The paper's own argument makes compression a first-class lever: β·S and
# the incast term scale with the bytes actually on the wire, while the
# quantize/dequantize passes are extra γ/δ work (§3.1's memory-access
# accounting). A Precision describes one wire format; the evaluators below
# accept it and reprice every term, so the planner can argmin over
# {f32, bf16, fp8, int8} with the same model it uses for plan shape.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Precision:
    """One wire format for collective payloads.

    `bits` is the payload width per element; `scale_block` elements share
    one f32 scale (0 = scale-free cast, e.g. bf16); `quant_passes` counts
    the extra quantize/dequantize memory passes per hop that γ/δ must pick
    up; `error_budget` is the relative error a sync through this format
    may introduce (0.0 = lossless — bit-identical to the f32 path)."""
    name: str
    wire_dtype: str            # jnp dtype name of the payload
    bits: int                  # wire bits per element
    scale_block: int = 0       # elements per f32 scale (0: none)
    quant_passes: int = 0      # extra quant/dequant memory passes per hop
    error_budget: float = 0.0  # max relative error per sync (0: lossless)

    @property
    def lossless(self) -> bool:
        return self.error_budget == 0.0

    @property
    def bytes_per_elem(self) -> float:
        """Payload bytes per element, scales included."""
        return self.bits / 8.0 + (4.0 / self.scale_block
                                  if self.scale_block else 0.0)

    def comm_scale(self) -> float:
        """Multiplier on wire volume in f32 data units: β·S and the incast
        receive both shrink (or hold) by this factor."""
        return self.bytes_per_elem / 4.0

    def wire_bytes(self, n_elems: int) -> int:
        """Exact wire bytes for an n-element payload: packed values plus
        one f32 scale per (partial) scale block."""
        n_elems = int(n_elems)
        payload = (n_elems * self.bits + 7) // 8
        scales = (4 * ((n_elems + self.scale_block - 1) // self.scale_block)
                  if self.scale_block and n_elems else 0)
        return payload + scales

    def extra_adds(self, size: float) -> float:
        """γ ops of the quant passes (abs-max scan + scale multiply —
        one pass-equivalent of adds per element per pass)."""
        return self.quant_passes * size

    def extra_mem_ops(self, size: float) -> float:
        """δ ops of the quant passes: each pass reads the f32 copy and
        writes the compressed one (or vice versa), so a pass touches
        (1 + bits/32) f32-unit-equivalents per element."""
        return self.quant_passes * size * (1.0 + self.bits / 32.0)


# The four wire formats the planner sweeps. Budgets are per-sync relative
# error bounds (validated by tests/test_quant.py and the 8-device
# differential fuzz): quantization error per hop is ≲ half an ulp of the
# per-tile amax, accumulated over the RS fold and the AG requant hop.
PRECISIONS = {
    "f32":  Precision("f32", "float32", 32),
    "bf16": Precision("bf16", "bfloat16", 16, scale_block=0,
                      quant_passes=1, error_budget=0.02),
    "fp8":  Precision("fp8", "float8_e4m3fn", 8, scale_block=128,
                      quant_passes=2, error_budget=0.25),
    "int8": Precision("int8", "int8", 8, scale_block=128,
                      quant_passes=2, error_budget=0.08),
}


def resolve_precision(precision: "Precision | str | None",
                      tolerance: float | None = None) -> Precision:
    """The error-budget guard (DESIGN.md §13): map a requested precision +
    caller tolerance onto the wire format actually allowed to run.

    `tolerance=None` means "trust the explicit request": a caller pinning
    fp8 by name has opted into fp8's budget. A float tolerance is a hard
    bound — a pinned precision whose budget exceeds it CLAMPS to full
    precision (lossy sync disallowed), never errors. `precision=None`
    returns f32."""
    if precision is None:
        return PRECISIONS["f32"]
    prec = PRECISIONS[precision] if isinstance(precision, str) else precision
    if tolerance is not None and prec.error_budget > float(tolerance):
        return PRECISIONS["f32"]
    return prec


def allowed_precisions(tolerance: float | None) -> list[Precision]:
    """Sweep candidates under a caller tolerance: every registered format
    whose error budget fits. None (no lossy consent) → lossless only."""
    tol = 0.0 if tolerance is None else float(tolerance)
    return [p for p in PRECISIONS.values() if p.error_budget <= tol]


@dataclass(frozen=True)
class GenModelParams:
    """Defaults = the paper's CPU testbed (15 servers on a 10 Gbps ToR):
    α/γ/δ from the server row of Table 5, β/ε from the middle-switch row
    (the ToR is a middle-layer switch in the paper's level classes)."""
    alpha: float = 6.58e-3      # s per communication round
    beta: float = 6.4e-9        # s per data unit through a link
    gamma: float = 6.0e-10      # s per add
    delta: float = 1.87e-10     # s per memory read/write
    epsilon: float = 1.22e-10   # s per data unit of incast excess
    w_t: int = 9                # incast fan-in threshold

    def legacy(self) -> "GenModelParams":
        """The (α, β, γ) model: δ = ε = 0 (for accuracy comparisons)."""
        return replace(self, delta=0.0, epsilon=0.0)


# Paper Table 5 per-level parameters (units: seconds, floats).
PAPER_TABLE5 = {
    "cross_dc":  GenModelParams(alpha=3.00e-2, beta=6.40e-9,
                                epsilon=6.00e-11, w_t=9),
    "root_sw":   GenModelParams(alpha=6.58e-3, beta=6.40e-10,
                                epsilon=6.00e-12, w_t=9),
    "middle_sw": GenModelParams(alpha=6.58e-3, beta=6.40e-9,
                                epsilon=1.22e-10, w_t=9),
    "server":    GenModelParams(alpha=6.58e-3, gamma=6.00e-10,
                                delta=1.87e-10, w_t=7),
}

# The paper's GPU testbed (Table 4: DGX-class machines, NVLink inside a
# machine, 4×200 Gbps RoCE NICs between machines), as the repository's
# Table-4 benchmark parameterizes it (benchmarks/table4_gpu_testbed.py,
# GPU_PARAMS). These are the paper's testbed parameters, NOT measured on
# this card: they are the service's default pricing basis until the GPU
# calibration path is ported. Units: seconds per round / per data unit.
GPU_TESTBED = {
    "root_sw": GenModelParams(alpha=2e-5, beta=6.4e-12, gamma=0.0,
                              delta=0.0, epsilon=6.0e-13, w_t=9),
    "middle_sw": GenModelParams(alpha=1e-5, beta=3.2e-12, gamma=0.0,
                                delta=0.0, epsilon=0.0, w_t=64),
    "server": GenModelParams(alpha=5e-6, beta=0.0, gamma=5e-13,
                             delta=2e-13, epsilon=0.0, w_t=64),
    "cross_dc": GenModelParams(alpha=2e-5, beta=6.4e-12, gamma=0.0,
                               delta=0.0, epsilon=6.0e-13, w_t=9),
}


def chi(n: int) -> int:
    """χ(N) = 0 if N is a power of two, else 1 (Table 1/2)."""
    return 0 if (n & (n - 1)) == 0 else 1


def _incast(fan_in: int, recv: float, p: GenModelParams) -> float:
    return max(fan_in - p.w_t, 0) * recv * p.epsilon


# ---------------------------------------------------------------------------
# Closed forms (paper Table 2), single-switch, N servers, S data units.
# ---------------------------------------------------------------------------
def cost_reduce_broadcast(n: int, s: float, p: GenModelParams) -> float:
    return (2 * p.alpha + 2 * (n - 1) * s * p.beta + (n - 1) * s * p.gamma
            + (n + 1) * s * p.delta
            + max(n - p.w_t, 0) * (n - 1) * s * p.epsilon)


def cost_ring(n: int, s: float, p: GenModelParams) -> float:
    return (2 * (n - 1) * p.alpha + 2 * (n - 1) * s / n * p.beta
            + (n - 1) * s / n * p.gamma + 3 * (n - 1) * s / n * p.delta)


def cost_rhd(n: int, s: float, p: GenModelParams) -> float:
    base = (2 * math.ceil(math.log2(n)) * p.alpha
            + 2 * (n - 1) * s / n * p.beta + (n - 1) * s / n * p.gamma
            + 3 * (n - 1) * s / n * p.delta)
    return base + chi(n) * (2 * s * p.beta + s * p.gamma + 3 * s * p.delta)


def cost_cps(n: int, s: float, p: GenModelParams) -> float:
    return (2 * p.alpha + 2 * (n - 1) * s / n * p.beta
            + (n - 1) * s / n * p.gamma + (n + 1) * s / n * p.delta
            + 2 * (n - 1) * s / n * max(n - p.w_t, 0) * p.epsilon)


def cost_hcps(factors: list[int], s: float, p: GenModelParams) -> float:
    """m-step hierarchical CPS (Table 2 row 5).

    Memory term: step i reduces f_i blocks of size s/(prod_{j<=i} f_j) on
    each server → D_i = (f_i + 1) * s / prod_{j<=i} f_j; total matches the
    paper's (2*sum(prod f) + N + 1)/N form.
    Incast term: per-step fan-in f_i over the data received that step.
    """
    n = 1
    for f in factors:
        n *= f
    m = len(factors)
    t = 2 * m * p.alpha
    t += 2 * (n - 1) * s / n * p.beta
    t += (n - 1) * s / n * p.gamma
    shard = s
    for f in factors:
        blk = shard / f
        t += (f + 1) * blk * p.delta                      # δ of this stage
        t += _incast(f, (f - 1) * blk, p)                 # ε of this stage
        shard = blk
    return t


CLOSED_FORMS = {
    "reduce_broadcast": cost_reduce_broadcast,
    "ring": cost_ring,
    "rhd": cost_rhd,
    "cps": cost_cps,
}


# ---------------------------------------------------------------------------
# Generic IR evaluator (single-switch assumption: every transfer shares the
# per-server NIC; per-step time = α + max-per-server comm + max compute).
# ---------------------------------------------------------------------------
def compressed_plan(plan: Plan, precision: Precision | None) -> Plan:
    """The same plan repriced for a compressed wire: every transfer shrinks
    to its wire volume (comm_scale × f32 units) and every reduce picks up
    the quant/dequant passes as extra γ adds and δ mem_ops. Any pricer
    (reference Simulator, FastEngine, the evaluators here) then charges
    compression with zero changes to its own walk — the transform IS the
    pricing model of DESIGN.md §13."""
    if precision is None or precision.name == "f32":
        return plan
    from .plans import QuantReduceOp, Step
    cs = precision.comm_scale()
    steps = []
    for st in plan.steps:
        s = Step()
        s.transfers = [replace(t, size=t.size * cs) for t in st.transfers]
        s.reduces = [QuantReduceOp(
            server=r.server, fan_in=r.fan_in, size=r.size, blocks=r.blocks,
            extra_adds=precision.extra_adds(r.size),
            extra_mem_ops=precision.extra_mem_ops(r.size))
            for r in st.reduces]
        steps.append(s)
    return Plan(plan.name, plan.n, plan.size, steps=steps,
                servers=plan.servers, num_blocks=plan.num_blocks,
                family=plan.family)


# Per-device wire volume of each collective family, as a multiple of the
# payload M (DESIGN.md §14). THE wire-byte convention: the planner's
# per-family plans move exactly these bytes, and `launch.hlo_analysis`
# books the same so an HLO-extracted mix is not systematically
# overpriced vs the plans quoted for it. Payload M per family:
#   all-reduce / reduce-scatter / all-to-all — the per-device operand;
#   all-gather                              — the full result;
#   collective-permute (p2p)                — the buffer moved per edge.
def family_wire_bytes(family: str, n: int, payload: float) -> float:
    """Wire units each device moves for `payload` units of family
    `family` over an n-member group (n ≤ 1 ⇒ nothing moves)."""
    if n <= 1:
        return 0.0
    if family in ("all-reduce", "allreduce"):
        return 2.0 * (n - 1) / n * payload      # RS + AG halves
    if family in ("reduce-scatter", "reduce_scatter",
                  "all-gather", "allgather",
                  "all-to-all", "all_to_all", "alltoall"):
        return (n - 1) / n * payload
    if family in ("collective-permute", "p2p"):
        return float(payload)
    raise ValueError(f"unknown collective family {family!r}")


def evaluate_plan(plan: Plan, p: GenModelParams,
                  precision: Precision | None = None) -> float:
    cs = precision.comm_scale() if precision is not None else 1.0
    total = 0.0
    for st in plan.steps:
        send: dict[int, float] = {}
        for t in st.transfers:
            send[t.src] = send.get(t.src, 0.0) + t.size * cs
        recv = st.recv_bytes_by_dst()
        fi = st.fan_in_by_dst()
        comm = 0.0
        for srv in set(send) | set(recv):
            b = max(send.get(srv, 0.0), recv.get(srv, 0.0) * cs)
            w = fi.get(srv, 0) + 1 if srv in fi else 0  # w counts self
            c = b * p.beta + _incast(w, recv.get(srv, 0.0) * cs, p)
            comm = max(comm, c)
        comp = 0.0
        by_srv: dict[int, tuple[float, float]] = {}
        for r in st.reduces:
            a, d = by_srv.get(r.server, (0.0, 0.0))
            qa = precision.extra_adds(r.size) if precision else 0.0
            qd = precision.extra_mem_ops(r.size) if precision else 0.0
            by_srv[r.server] = (a + r.adds + qa, d + r.mem_ops + qd)
        for a, d in by_srv.values():
            comp = max(comp, a * p.gamma + d * p.delta)
        total += p.alpha + comm + comp
    return total


# ---------------------------------------------------------------------------
# Link-contention pricing of concurrent rounds (DESIGN.md §15).
#
# The bucket pipeline overlaps RS-of-bucket-k with AG-of-bucket-(k-1); the
# naive steady-state model `max(t_rs, t_ag)` assumes the two rounds never
# share a link. On multi-level meshes they do — and GenModel says exactly
# how that hurts: transfers sharing a link serialize their β volume, and
# their incast fan-ins SUM at the shared endpoint (ε is superadditive past
# w_t). A `LinkOccupancy` is one round's footprint on the routing index's
# dense link ids; merging two occupancies and repricing with the same
# per-step walk gives the *contended* concurrent time:
#
#   max(t_a, t_b)  ≤  t_contended   (disjoint links ⇒ equality)
#   t_contended may EXCEED t_a + t_b when summed fan-in crosses w_t —
#   which is precisely when the planner must not merge.
#
# This is the pure-Python reference path; `FastEngine.merge_steps` is the
# vectorized twin and must agree ≤ 1e-9 (tests/test_overlap.py).
# ---------------------------------------------------------------------------
@dataclass
class LinkOccupancy:
    """One Step's footprint on a topology: per-link data units and distinct
    sender counts (keyed by dense RoutingIndex link id), per-endpoint
    receive units and fan-in, per-server reduce work."""
    link_units: dict
    link_nsend: dict
    recv_units: dict
    recv_fan: dict
    adds: dict
    mem: dict
    has_transfers: bool
    has_reduces: bool

    def merge(self, other: "LinkOccupancy") -> "LinkOccupancy":
        """Two rounds run concurrently: shared links serialize (units add),
        incast fan-ins sum, reduce work on a shared server queues."""
        def _sum(a, b):
            out = dict(a)
            for k, v in b.items():
                out[k] = out.get(k, 0) + v
            return out
        return LinkOccupancy(
            link_units=_sum(self.link_units, other.link_units),
            link_nsend=_sum(self.link_nsend, other.link_nsend),
            recv_units=_sum(self.recv_units, other.recv_units),
            recv_fan=_sum(self.recv_fan, other.recv_fan),
            adds=_sum(self.adds, other.adds),
            mem=_sum(self.mem, other.mem),
            has_transfers=self.has_transfers or other.has_transfers,
            has_reduces=self.has_reduces or other.has_reduces)


def link_occupancy(topo, step, unit_bytes: int = 4) -> LinkOccupancy:
    """Walk one Step's transfers over `topo.routing().path_link_ids` and
    accumulate the occupancy vector (pure Python — the reference path)."""
    rx = topo.routing()
    link_units: dict = {}
    link_senders: dict = {}
    recv_units: dict = {}
    recv_senders: dict = {}
    for t in step.transfers:
        for lid in rx.path_link_ids(t.src, t.dst):
            link_units[lid] = link_units.get(lid, 0.0) + t.size
            link_senders.setdefault(lid, set()).add(t.src)
        recv_units[t.dst] = recv_units.get(t.dst, 0.0) + t.size
        recv_senders.setdefault(t.dst, set()).add(t.src)
    adds: dict = {}
    mem: dict = {}
    for r in step.reduces:
        adds[r.server] = adds.get(r.server, 0.0) + r.adds
        mem[r.server] = mem.get(r.server, 0.0) + r.mem_ops
    return LinkOccupancy(
        link_units=link_units,
        link_nsend={k: len(v) for k, v in link_senders.items()},
        recv_units=recv_units,
        recv_fan={k: len(v) for k, v in recv_senders.items()},
        adds=adds, mem=mem,
        has_transfers=bool(step.transfers),
        has_reduces=bool(step.reduces))


def occupancy_time(topo, occ: LinkOccupancy,
                   params: "dict[str, GenModelParams] | None" = None,
                   unit_bytes: int = 4) -> float:
    """GenModel step time of one (possibly merged) occupancy vector —
    the same accounting as `FastEngine.step_cost`, dict-walked."""
    rx = topo.routing()
    tbl = params or PAPER_TABLE5
    psrv = tbl.get("server", GenModelParams())
    scale = unit_bytes / 4.0
    comm = 0.0
    alpha_eff = psrv.alpha if occ.has_transfers else 0.0
    for lid, units in occ.link_units.items():
        nid = lid >> 1            # both directed links share the node's bw
        p = tbl.get(rx.levels[rx.link_level[nid]], psrv)
        bw = rx.link_bw[nid]
        tpb = unit_bytes / bw if bw != 0.0 else 0.0
        extra = (max(occ.link_nsend.get(lid, 0) - p.w_t, 0)
                 * units * scale * p.epsilon)
        comm = max(comm, units * tpb + extra + rx.link_latency[nid])
        alpha_eff = max(alpha_eff, p.alpha)
    for dst, units in occ.recv_units.items():
        p = tbl.get(rx.levels[rx.srv_level[dst]], psrv)
        bw = rx.srv_bw[dst]
        tpb = unit_bytes / bw if bw != 0.0 else 0.0
        w = occ.recv_fan.get(dst, 0) + 1
        extra = max(w - p.w_t, 0) * units * scale * p.epsilon
        comm = max(comm, units * tpb + extra)
    comp = 0.0
    for srv in occ.adds.keys() | occ.mem.keys():
        comp = max(comp, (occ.adds.get(srv, 0.0) * psrv.gamma
                          + occ.mem.get(srv, 0.0) * psrv.delta) * scale)
    if occ.has_reduces and not occ.has_transfers:
        alpha_eff = max(alpha_eff, psrv.alpha)
    return alpha_eff + comm + comp


def concurrent_step_time(topo, steps,
                         params: "dict[str, GenModelParams] | None" = None,
                         unit_bytes: int = 4) -> float:
    """Contended time of ≥1 Steps running concurrently: merge their
    occupancy vectors and reprice. One step degenerates to its plain
    GenModel step cost."""
    occs = [link_occupancy(topo, st, unit_bytes) for st in steps if st]
    if not occs:
        return 0.0
    occ = occs[0]
    for other in occs[1:]:
        occ = occ.merge(other)
    return occupancy_time(topo, occ, params, unit_bytes)


def contended_pair_time(topo, plan_a: Plan, plan_b: Plan,
                        params: "dict[str, GenModelParams] | None" = None,
                        unit_bytes: int = 4,
                        precision: "Precision | None" = None) -> float:
    """Price plan A's rounds run concurrently with plan B's, round by
    round: round i of A merges with round i of B (shared links serialize,
    fan-ins sum); leftover rounds of the longer plan price alone. This is
    the reference contended estimate for the bucket pipeline's steady
    state (RS-of-bucket-k over AG-of-bucket-(k-1)) and for cross-family
    merges; `FastEngine.contended_pair_total` must agree ≤ 1e-9."""
    if precision is not None and precision.name != "f32":
        plan_a = compressed_plan(plan_a, precision)
        plan_b = compressed_plan(plan_b, precision)
    total = 0.0
    for i in range(max(len(plan_a.steps), len(plan_b.steps))):
        parts = []
        if i < len(plan_a.steps):
            parts.append(plan_a.steps[i])
        if i < len(plan_b.steps):
            parts.append(plan_b.steps[i])
        total += concurrent_step_time(topo, parts, params, unit_bytes)
    return total


# ---------------------------------------------------------------------------
# Per-term decomposition — the cost ledger's pricing side (DESIGN.md §11).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CostBreakdown:
    """Predicted time split into the five GenModel terms (Eq. 11):
    A·α + B·β + C·γ + D·δ + incast·ε.  ``total`` reproduces
    ``evaluate_plan`` exactly (same walk, same maxes — the winning
    server's split is attributed, not an average)."""
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0
    delta: float = 0.0
    incast: float = 0.0

    TERMS = ("alpha", "beta", "gamma", "delta", "incast")

    @property
    def total(self) -> float:
        return self.alpha + self.beta + self.gamma + self.delta + self.incast

    def as_dict(self) -> dict[str, float]:
        return {t: getattr(self, t) for t in self.TERMS}

    def shares(self) -> dict[str, float]:
        """Fractions of total per term (all-zero breakdown → zeros)."""
        tot = self.total
        if tot <= 0.0:
            return {t: 0.0 for t in self.TERMS}
        return {t: getattr(self, t) / tot for t in self.TERMS}

    def scaled_to(self, target_total: float) -> "CostBreakdown":
        """Rescale proportionally so ``total == target_total`` (used when a
        quoted prediction came from a different pricer — e.g. the
        Simulator's halves split — but term *proportions* come from the
        model walk).  A zero breakdown books everything under α."""
        tot = self.total
        if tot <= 0.0:
            return CostBreakdown(alpha=target_total)
        k = target_total / tot
        return CostBreakdown(self.alpha * k, self.beta * k, self.gamma * k,
                             self.delta * k, self.incast * k)


def evaluate_plan_terms(plan: Plan, p: GenModelParams,
                        precision: Precision | None = None) -> CostBreakdown:
    """``evaluate_plan`` with the ledger kept open: identical step walk and
    identical per-server maxes, but each step's winning comm/compute server
    contributes its β/ε (resp. γ/δ) split instead of a fused scalar. With a
    `precision`, the quant passes land in the γ/δ entries and the shrunk
    wire in β/ε — so the per-term drift attribution (DESIGN.md §11) keeps
    working on compressed syncs."""
    cs = precision.comm_scale() if precision is not None else 1.0
    al = be = ga = de = inc = 0.0
    for st in plan.steps:
        send: dict[int, float] = {}
        for t in st.transfers:
            send[t.src] = send.get(t.src, 0.0) + t.size * cs
        recv = st.recv_bytes_by_dst()
        fi = st.fan_in_by_dst()
        comm = comm_b = comm_i = 0.0
        for srv in set(send) | set(recv):
            b = max(send.get(srv, 0.0), recv.get(srv, 0.0) * cs)
            w = fi.get(srv, 0) + 1 if srv in fi else 0  # w counts self
            b_term = b * p.beta
            i_term = _incast(w, recv.get(srv, 0.0) * cs, p)
            if b_term + i_term > comm:
                comm, comm_b, comm_i = b_term + i_term, b_term, i_term
        comp = comp_g = comp_d = 0.0
        by_srv: dict[int, tuple[float, float]] = {}
        for r in st.reduces:
            a, d = by_srv.get(r.server, (0.0, 0.0))
            qa = precision.extra_adds(r.size) if precision else 0.0
            qd = precision.extra_mem_ops(r.size) if precision else 0.0
            by_srv[r.server] = (a + r.adds + qa, d + r.mem_ops + qd)
        for a, d in by_srv.values():
            g_term, d_term = a * p.gamma, d * p.delta
            if g_term + d_term > comp:
                comp, comp_g, comp_d = g_term + d_term, g_term, d_term
        al += p.alpha
        be += comm_b
        inc += comm_i
        ga += comp_g
        de += comp_d
    return CostBreakdown(al, be, ga, de, inc)


# ---------------------------------------------------------------------------
# Model-driven plan-type choice for a flat group (used by GenTree §4.2).
# ---------------------------------------------------------------------------
def best_flat_plan(n: int, s: float, p: GenModelParams,
                   allow: tuple[str, ...] = ("cps", "hcps", "ring", "rhd"),
                   max_steps: int = 3) -> tuple[str, list[int] | None, float]:
    """Returns (name, hcps_factors_or_None, predicted_cost)."""
    cands: list[tuple[str, list[int] | None, float]] = []
    if "cps" in allow:
        cands.append(("cps", None, cost_cps(n, s, p)))
    if "ring" in allow and n >= 2:
        cands.append(("ring", None, cost_ring(n, s, p)))
    if "rhd" in allow and n >= 2:
        cands.append(("rhd", None, cost_rhd(n, s, p)))
    if "hcps" in allow:
        for fac in factorizations(n, max_steps=max_steps):
            cands.append(("hcps", fac, cost_hcps(fac, s, p)))
    # Deterministic tie-break: equal-cost candidates order by name, then
    # factors, so plan choice is stable across runs and platforms.
    cands.sort(key=lambda x: (x[2], x[0], tuple(x[1] or ())))
    return cands[0]
