"""Cross-family overlap scheduling: merged schedules (DESIGN.md §15).

The bucket pipeline (§9) overlaps a ReduceScatter with an AllGather:
RS of bucket k behind AG of bucket k−1. This module turns that overlap
into one **merged schedule**: the two constituents' rounds interleave
round by round over their own independent buffers, so the overlap the
planner priced with the contended model
(`cost_model.contended_pair_time` / `FastEngine.contended_pair_total`)
is the overlap that is issued.

The merge analysis is the reference package's, copied: the two
constituents operate on disjoint buffers, so any interleaving that keeps
each schedule's own round and fold order computes the sequential result;
a round pair is **coalesced** (modeled as fully overlapped) exactly when
its link sets are disjoint, which on a single-switch axis means no
device sends in both and no device receives in both.

`MergedSchedule` is written anew for the local mesh of `core.lower`:
its rounds are gathers of block rows into staging rows and its folds
`fused_reduce_into` launches (`quant_reduce_into` / `dequantize_into`
on a compressed wire), as `CompiledSchedule.run_local_*` runs them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.launch import analysis
from repro_torch.runtime.metrics import default_metrics
from repro_torch.runtime.trace import default_tracer

from .lower import (ExecStep, LoweringError, PermRound, _fold_table,
                    _round_tables)
from .transport import exchange


# ---------------------------------------------------------------------------
# Merge analysis
# ---------------------------------------------------------------------------
def _round_endpoints(rd: PermRound) -> tuple[set, set]:
    senders = {s for s, _ in rd.perm}
    receivers = {d for _, d in rd.perm}
    return senders, receivers


def rounds_link_disjoint(ra: PermRound, rb: PermRound) -> bool:
    """True when the two rounds occupy disjoint link sets on a
    single-switch axis: a device's up-link carries its send, its
    down-link its receive, so disjointness is 'no common sender and no
    common receiver'. Disjoint pairs coalesce (fully overlap, priced at
    max); shared pairs serialize their β/ε in the contended model."""
    sa, ra_ = _round_endpoints(ra)
    sb, rb_ = _round_endpoints(rb)
    return not (sa & sb) and not (ra_ & rb_)


def _unwrap(sched):
    """The raw CompiledSchedule under a (possibly) guarded schedule."""
    return getattr(sched, "inner", sched)


def _rs_steps(sched) -> list[ExecStep]:
    """The step stream the RS constituent contributes: its RS half plus
    the canonical reorder round."""
    return list(sched.rs) + ([sched.reorder]
                             if sched.reorder is not None else [])


def _ag_steps(sched) -> list[ExecStep]:
    """The step stream the AG constituent contributes: the unorder round
    plus its AG half."""
    return ([sched.unorder] if sched.unorder is not None else []) \
        + list(sched.ag)


@dataclass(frozen=True)
class MergeInfo:
    """Static analysis of one merge: how many round pairs interleave and
    how many coalesce (disjoint link sets). `coalesced_fraction` is what
    the trace span and the occupancy gauge report — a low fraction means
    the contended price sits near serial and the planner should usually
    reject the merge."""
    n: int
    steps_rs: int
    steps_ag: int
    round_pairs: int
    coalesced: int

    @property
    def serialized(self) -> int:
        return self.round_pairs - self.coalesced

    @property
    def coalesced_fraction(self) -> float:
        return self.coalesced / self.round_pairs if self.round_pairs else 1.0


def plan_merge(rs_sched, ag_sched) -> MergeInfo:
    """Validate that `rs_sched`'s RS half can merge with `ag_sched`'s AG
    half and analyze the interleaving. Raises LoweringError on any
    contract violation (the dataflow contract of core.lower carries
    over: both constituents were validated by `lower_plan`; the merge
    only adds cross-schedule requirements)."""
    a, b = _unwrap(rs_sched), _unwrap(ag_sched)
    if a.n != b.n:
        raise LoweringError(
            f"cannot merge schedules over different axis sizes: "
            f"{a.plan_name!r} has n={a.n}, {b.plan_name!r} n={b.n}")
    if a.family not in ("allreduce", "reduce_scatter"):
        raise LoweringError(
            f"merge RS side must be allreduce/reduce_scatter family; "
            f"{a.plan_name!r} is {a.family!r}")
    if b.family not in ("allreduce", "allgather"):
        raise LoweringError(
            f"merge AG side must be allreduce/allgather family; "
            f"{b.plan_name!r} is {b.family!r}")
    for s, what in ((a, "RS"), (b, "AG")):
        if s.blocks_per_shard is None:
            raise LoweringError(
                f"merge {what} side {s.plan_name!r} has no canonical "
                f"shard layout (num_blocks % n != 0)")
    sa, sb = _rs_steps(a), _ag_steps(b)
    pairs = coalesced = 0
    for i in range(min(len(sa), len(sb))):
        ra, rb = sa[i].rounds, sb[i].rounds
        for j in range(min(len(ra), len(rb))):
            pairs += 1
            if rounds_link_disjoint(ra[j], rb[j]):
                coalesced += 1
    return MergeInfo(n=a.n, steps_rs=len(sa), steps_ag=len(sb),
                     round_pairs=pairs, coalesced=coalesced)


# ---------------------------------------------------------------------------
# Merged schedule (local mesh)
# ---------------------------------------------------------------------------
class MergedSchedule:
    """One RS half and one AG half interleaved into a single issuance on
    the local mesh.

    `rs_ag(X, S)` takes X, the (n, size) reduce-scatter operand, and S,
    the (n, shard) all-gather shards, and returns `(rs_shards (n, k·chunk),
    ag_full (n, num_blocks·chunk))`: the values of
    `rs_sched.run_local_reduce_scatter(X)` followed by
    `ag_sched.run_local_all_gather(S)`. With both constituents at full
    precision the rounds interleave step by step and round by round over
    two private buffers, as the reference's merged launch does; with a
    wire-bound constituent they interleave step by step, each step
    through the constituent's own `_run_steps_local` (so quantized
    payloads and scales are untouched).

    Guard: every launch is counted (`stats`,
    `overlap_merged_launches_total`); a failed launch is recorded
    (`stats["failures"]`, `overlap_merged_failures_total`, an
    `overlap/failure` trace instant, a telemetry re-measure window) and
    re-raised. The deliberate difference from the reference: its merged
    launch demotes itself and runs the constituents in sequence after a
    failure. This one never demotes and never runs the sequential path in
    a failure's place — like `core.lower.GuardedSchedule`, whose
    `demotions` is always 0 — since the sequential path would answer
    correctly while a kernel that failed to build or launch went unseen.
    """

    demotions = 0

    def __init__(self, rs_sched, ag_sched, *, telemetry=None):
        self.info = plan_merge(rs_sched, ag_sched)
        self.rs_inner = _unwrap(rs_sched)
        self.ag_inner = _unwrap(ag_sched)
        self.telemetry = telemetry
        self.plan_name = (f"merge({self.rs_inner.plan_name}"
                          f"+{self.ag_inner.plan_name})")
        self.n = self.rs_inner.n
        self.stats = {"launches": 0, "failures": 0}

    def describe(self) -> str:
        i = self.info
        return (f"{self.plan_name}: n={self.n} steps={i.steps_rs}"
                f"|{i.steps_ag} round_pairs={i.round_pairs} "
                f"coalesced={i.coalesced} "
                f"({i.coalesced_fraction:.0%} disjoint)")

    def _note_failure(self, err: BaseException) -> None:
        from repro_torch.runtime.telemetry import peek_default_telemetry

        self.stats["failures"] += 1
        default_metrics().counter(
            "overlap_merged_failures_total",
            "merged RS+AG launches that raised").inc()
        info = {"plan": self.plan_name, "error": repr(err)}
        default_tracer().instant("overlap/failure", **info)
        tele = self.telemetry
        if tele is None:
            tele = peek_default_telemetry()
        if tele is not None:
            tele.remeasure("overlap_failure", info)

    def _merged(self, X: torch.Tensor, S: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels import ops as kops

        a, b = self.rs_inner, self.ag_inner
        n = a.n
        a._check_rows("rs_ag", X)
        b._check_rows("rs_ag", S)
        # RS-side buffer (as run_local_reduce_scatter prepares it)
        buf_a = a._padded_buffer(X)
        # AG-side buffer (as run_local_all_gather prepares it)
        kb = b.blocks_per_shard
        if S.shape[1] % kb:
            raise LoweringError(f"a shard of {S.shape[1]} elements does "
                                f"not split into {kb} blocks")
        chunk_b = S.shape[1] // kb
        buf_b = torch.zeros((n * b.num_blocks, chunk_b), dtype=S.dtype,
                            device=S.device)
        buf_b.view(n, n, kb, chunk_b).diagonal(dim1=0, dim2=1).copy_(
            S.reshape(n, kb, chunk_b).permute(1, 2, 0))

        def live(st):
            return st if st is not None and (st.rounds or st.folds) \
                else None

        steps_a, steps_b = _rs_steps(a), _ag_steps(b)
        info = self.info
        tracer = default_tracer()
        with tracer.span("overlap/rs_ag", plan=self.plan_name, n=self.n,
                         round_pairs=info.round_pairs,
                         coalesced=info.coalesced,
                         serialized=info.serialized):
            if a.wire is None and b.wire is None:
                sides = ((a, buf_a), (b, buf_b))
                for i in range(max(len(steps_a), len(steps_b))):
                    sts = [live(steps_a[i] if i < len(steps_a) else None),
                           live(steps_b[i] if i < len(steps_b) else None)]
                    with tracer.span(
                            "overlap/step", step=i,
                            rs_rounds=len(sts[0].rounds) if sts[0] else 0,
                            ag_rounds=len(sts[1].rounds) if sts[1] else 0):
                        stages = [
                            torch.empty((n * max(st.n_slots, 1),
                                         buf.shape[1]), dtype=buf.dtype,
                                        device=buf.device)
                            if st is not None else None
                            for st, (_, buf) in zip(sts, sides)]
                        rounds = max((len(st.rounds) for st in sts
                                      if st is not None), default=0)
                        for j in range(rounds):
                            for st, stage, (s, buf) in zip(sts, stages,
                                                           sides):
                                if st is None or j >= len(st.rounds):
                                    continue
                                rd = st.rounds[j]
                                if rd.perm:
                                    src, dst = _round_tables(
                                        rd, s.num_blocks,
                                        max(st.n_slots, 1), buf.device)
                                    stage[dst] = buf[src]
                        for st, stage, (s, buf) in zip(sts, stages, sides):
                            if st is None:
                                continue
                            for fd in st.folds:
                                kops.fused_reduce_into(
                                    stage, _fold_table(
                                        fd, s.num_blocks,
                                        max(st.n_slots, 1), buf.device),
                                    buf)
            else:
                # a wire-bound constituent: interleave step by step, each
                # step through the constituent's own machinery
                for i in range(max(len(steps_a), len(steps_b))):
                    if i < len(steps_a):
                        a._run_steps_local([steps_a[i]], buf_a, phase="rs")
                    if i < len(steps_b):
                        b._run_steps_local([steps_b[i]], buf_b, phase="ag")
        ka = a.blocks_per_shard
        shards = (buf_a.view(n, n, ka, -1).diagonal(dim1=0, dim2=1)
                  .permute(2, 0, 1).reshape(n, -1))
        return shards, buf_b.reshape(n, -1)

    @analysis.collective(None, lambda a, out: [
        ("reduce-scatter", analysis.rank_bytes(out[0], 1), out[0].shape[0]),
        ("all-gather", analysis.rank_bytes(out[1], out[1].shape[0]),
         out[1].shape[0])])
    def rs_ag(self, X: torch.Tensor, S: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Merged launch: RS of `X` interleaved with AG of `S`. Returns
        `(rs_shards, ag_full)`, the values of running the constituents in
        sequence. Counted; a failure is recorded and re-raised."""
        self.stats["launches"] += 1
        default_metrics().counter(
            "overlap_merged_launches_total",
            "merged RS+AG launches through the overlap scheduler").inc()
        try:
            return self._merged(X, S)
        except Exception as e:
            self._note_failure(e)
            raise


    def _merged_mesh(self, x: torch.Tensor, s: torch.Tensor,
                     axis_name: str, mesh) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
        """`_merged` as one rank of a process mesh: at full precision
        each step's rounds of both constituents are posted as one
        exchange, then both sides' folds run; with a wire-bound
        constituent the steps interleave through each constituent's own
        `_run_steps_dist`."""
        a, b = self.rs_inner, self.ag_inner
        m = a._check_axis(axis_name, mesh)
        b._check_axis(axis_name, mesh)
        buf_a = a._rank_buffer("rs_ag", x)
        kb = b.blocks_per_shard
        if s.numel() % kb:
            raise LoweringError(f"a shard of {s.numel()} elements does not "
                                f"split into {kb} blocks")
        buf_b = torch.zeros((b.num_blocks, s.numel() // kb), dtype=s.dtype,
                            device=s.device)
        buf_b[m * kb:(m + 1) * kb] = s.reshape(kb, -1)
        steps_a, steps_b = _rs_steps(a), _ag_steps(b)
        line = mesh.line(axis_name)
        tracer = default_tracer()
        with tracer.span("overlap/rs_ag", plan=self.plan_name, n=self.n,
                         round_pairs=self.info.round_pairs,
                         coalesced=self.info.coalesced, rank=m):
            for i in range(max(len(steps_a), len(steps_b))):
                sides = [(a, buf_a, steps_a[i] if i < len(steps_a)
                          else None, "rs"),
                         (b, buf_b, steps_b[i] if i < len(steps_b)
                          else None, "ag")]
                sides = [sd for sd in sides if sd[2] is not None
                         and (sd[2].rounds or sd[2].folds)]
                if a.wire is not None or b.wire is not None:
                    for sched, buf, st, phase in sides:
                        sched._run_steps_dist([st], buf, m, mesh,
                                              axis_name, phase)
                    continue
                with tracer.span("overlap/step", step=i):
                    sends, recvs, stages = [], [], []
                    for sched, buf, st, _ in sides:
                        se, re, sg = sched._dist_rounds(st, buf, m)
                        sends += se
                        recvs += re
                        stages.append(sg)
                    exchange(mesh, line, sends, recvs)
                    for (sched, buf, st, _), sg in zip(sides, stages):
                        sched._dist_folds(st, sg, buf, m)
        ka = a.blocks_per_shard
        return buf_a[m * ka:(m + 1) * ka].reshape(-1), buf_b.reshape(-1)

    @analysis.collective(None, lambda a, out: [
        ("reduce-scatter", analysis.rank_bytes(out[0], 1), a["self"].n),
        ("all-gather", analysis.rank_bytes(out[1], 1), a["self"].n)])
    def rs_ag_mesh(self, x: torch.Tensor, s: torch.Tensor, axis_name: str,
                   mesh) -> tuple[torch.Tensor, torch.Tensor]:
        """The merged launch as one rank of a process mesh: this rank's
        flat reduce-scatter operand `x` and all-gather shard `s` →
        (its shard of the RS, its flat gathered vector), the values of
        the constituents' `reduce_scatter` and `all_gather` in
        sequence. Counted and guarded as `rs_ag`."""
        self.stats["launches"] += 1
        default_metrics().counter(
            "overlap_merged_launches_total",
            "merged RS+AG launches through the overlap scheduler").inc()
        try:
            return self._merged_mesh(x, s, axis_name, mesh)
        except Exception as e:
            self._note_failure(e)
            raise


def merge_schedules(rs_sched, ag_sched, *, telemetry=None
                    ) -> MergedSchedule:
    """Build (and validate) a MergedSchedule. Memoized per (rs, ag)
    schedule-object pair on the RS schedule, as `guard_schedule` memoizes
    its wrapper, so launch counts survive re-resolves of the same cached
    schedules."""
    inner = _unwrap(rs_sched)
    memo = getattr(inner, "_merge_wrappers", None)
    if memo is None:
        memo = {}
        try:
            inner._merge_wrappers = memo
        except (AttributeError, TypeError):
            return MergedSchedule(rs_sched, ag_sched, telemetry=telemetry)
    key = id(_unwrap(ag_sched))
    ms = memo.get(key)
    if ms is None:
        ms = MergedSchedule(rs_sched, ag_sched, telemetry=telemetry)
        memo[key] = ms
    return ms


# ---------------------------------------------------------------------------
# Occupancy summary (satellite of DESIGN.md §15: the gauge + span
# attributes that make Chrome traces show which links serialized)
# ---------------------------------------------------------------------------
def occupancy_summary(topo, step_a, step_b, unit_bytes: int = 4) -> dict:
    """Merged per-link occupancy of two concurrent Steps: how many links
    each side touches, how many they share, and the busiest link's
    combined units — the quantities the planner emits as the
    `overlap_*` gauges and `overlap/priced` span attributes."""
    from .cost_model import link_occupancy
    oa = link_occupancy(topo, step_a, unit_bytes)
    ob = link_occupancy(topo, step_b, unit_bytes)
    shared = set(oa.link_units) & set(ob.link_units)
    merged = oa.merge(ob)
    busiest, units = -1, 0.0
    for lid, u in merged.link_units.items():
        if u > units:
            busiest, units = int(lid), float(u)
    return {"links_rs": len(oa.link_units), "links_ag": len(ob.link_units),
            "links_shared": len(shared), "busiest_link": busiest,
            "busiest_link_units": units}
