"""PlannerService — the one cached, calibrated entry point for plan lookup.

The serving slice of the reference `planner/service.py` (DESIGN.md §5):

  * `get_plan(topo, nbytes, dtype)` — full GenTree plan for a physical
    topology, cache-bucketed by size, optionally re-ranked against the
    global baselines under an arrival-skew model (`planner.skew`);
  * `get_executable(topo, nbytes, dtype)` / `get_axis_executable(axis, n,
    size_floats)` — the same plan plus its lowered schedule (core.lower,
    DESIGN.md §8), cached alongside the plan entry;
  * `get_family_executable(family, axis, n, size_floats)` — the lowered
    schedule of one collective family on one mesh axis (DESIGN.md §14):
    reduce-scatter and all-gather as the halves of the axis's GenTree
    AllReduce plan, all-to-all and p2p from their flat builders;
  * `get_axis_plans(axes, size_floats)` — per-mesh-axis plan labels;
  * `get_bucket_plan(axes, total_floats)` — the GenModel-argmin gradient
    bucket size, wire precision and issuance (sequential or merged) for
    the bucketed sync, with the axis's lowered schedule (DESIGN.md §9);
  * `get_step_plan(axes, mix)` — a training step's whole collective mix
    priced jointly, with one leaf-axis schedule per family (DESIGN.md
    §14);
  * `calibrate(source, cfg)` — refit GenModelParams from measured curves
    (`planner.calibrate`; `backend="torch"` times the port's own folds and
    CPS AllReduce on one device) and make them the pricing basis;
  * `observe(...)` — the online loop: residuals, drift, and the refit
    that hot-swaps the pricing basis (DESIGN.md §10);
  * `observe_arrivals` / `adopt_empirical_skew` — measured arrival
    offsets as the skew model;
  * `mark_degraded` / `clear_degraded` — degraded-link repricing
    (DESIGN.md §12): a level at bandwidth factor f pays β/f on every
    pricing and execution path.

A step plan takes an explicit mix or a collective census
(`launch.analysis.ModuleStats`, from `analysis.census()` of a torch
step). Uncalibrated mesh-axis pricing defaults to the paper's GPU
testbed with its NVLink row for the leaf class
(`cost_model.GPU_AXIS_BASIS`).

Plan generation (GenTree + candidate simulation) costs hundreds of
milliseconds at cluster scale; a warm lookup is a fingerprint hash plus an
LRU probe. With a cache path configured (or $REPRO_PLAN_CACHE), warm plans
persist across restarts.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from repro_torch.core import gentree as gentree_mod
from repro_torch.core.cost_model import (GPU_AXIS_BASIS, GenModelParams,
                                        PAPER_TABLE5)
from repro_torch.core.plans import Plan
from repro_torch.core.simulator import Simulator
from repro_torch.core.sync import AxisPlan, plan_axes_gentree
from repro_torch.core.topology import TopoNode

from repro_torch.runtime.metrics import default_metrics
from repro_torch.runtime.telemetry import (LedgerEntry, LevelSample,
                                           Telemetry, TelemetryEvent)
from repro_torch.runtime.trace import default_tracer

from .cache import PlanCache, plan_from_json, plan_to_json
from .calibrate import (CalibrationConfig, CalibrationResult,
                        TelemetryProvider, calibrate_levels)
from .fingerprint import axis_key, plan_key
from .skew import SkewModel, pick_plan_under_skew

DTYPE_BYTES = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
               "bf16": 2, "float16": 2, "int8": 1,
               "float8_e4m3fn": 1, "fp8": 1}


@dataclass
class PlanResponse:
    plan: Plan
    algo: str                        # "gentree" or a baseline name
    predicted_time: float            # synchronized simulator pricing
    decisions: dict = field(default_factory=dict)   # gentree plans only
    # simulator price + arrival-gated skew delta (skew.pick_plan_under_skew)
    expected_skewed_time: float | None = None
    source: str = "cold"             # cold | memory | disk
    key: str = ""
    nbytes_bucket: int = 0
    size_floats: float = 0.0
    # get_executable only: the lowered schedule (core.lower), cached
    # alongside the plan entry under "_exec" (derived artifact — never
    # persisted; recompiled once per placement after a disk-warm restart)
    schedule: object | None = None


@dataclass(eq=False)
class BucketPlan:
    """get_bucket_plan's answer: the GenModel-argmin gradient bucket size
    for a mesh-axis list, plus one lowered schedule per axis (DESIGN.md
    §9). `sweep` records every candidate's modeled pipelined/serial time
    so benchmarks (and the perf gate) can verify the argmin.

    The pipeline is priced twice (DESIGN.md §15): `predicted_pipelined`
    keeps the optimistic `max(t_rs, t_ag)` steady state (the lower
    bound), `predicted_contended` charges the overlapped RS/AG rounds
    through the per-link occupancy merge — shared links serialize, a
    summed fan-in can cross w_t — and is what the argmin ranks on.
    `overlap` records the argmin over {sequential, merged} issuance for
    one bucket pair; when "merged" wins on a single-axis plan,
    `merged_schedule` carries the lowered `core.overlap.MergedSchedule`
    (derived artifact — rebuilt, never persisted)."""
    axes: tuple[tuple[str, int], ...]     # live axes (n > 1), leaf first
    bucket_floats: int                    # chosen bucket size, in elements
    bucket_bytes: int                     # same, in bytes of the priced dtype
    num_buckets: int                      # for the quoted total size
    axis_plans: list = field(default_factory=list)   # AxisPlan("plan", …)
    predicted_pipelined: float = 0.0      # optimistic double-buffered total
    predicted_serial: float = 0.0         # same buckets, no overlap
    predicted_contended: float = 0.0      # contention-priced pipeline (§15)
    predicted_per_leaf: float | None = None   # per-leaf baseline (if sized)
    pipeline: bool = True
    sweep: dict = field(default_factory=dict)  # bucket_floats -> model row
    overlap: dict = field(default_factory=dict)  # {mode, t_joint, …}
    merged_schedule: object | None = None  # only when overlap mode=="merged"
    precision: str = "f32"                # chosen wire format (DESIGN.md §13)
    source: str = "cold"
    key: str = ""


# Family spellings accepted by `get_family_executable` and
# `get_step_plan`: HLO op names and plan-IR names (core.plans.FAMILIES)
# both map onto the IR spelling.
FAMILY_ALIASES = {
    "all-reduce": "allreduce", "all_reduce": "allreduce",
    "reduce-scatter": "reduce_scatter",
    "all-gather": "allgather", "all_gather": "allgather",
    "all-to-all": "all_to_all", "alltoall": "all_to_all",
    "collective-permute": "p2p",
}


@dataclass(eq=False)
class StepPlan:
    """get_step_plan's answer: every collective family of a training step
    priced JOINTLY under one GenModel basis (DESIGN.md §14).

    `quotes[family]` records, per family in the mix: the per-call
    GenModel breakdown at the call size, the coalesced quote (ONE launch
    of count·size — α amortized, every linear term unchanged), the
    pipelined alternative (count launches with call k's AllGather
    overlapping call k+1's ReduceScatter — the same
    `core.bucketing.pipelined_time` model `get_bucket_plan` uses), and
    which of the two the argmin chose. `total_joint` = Σ family coalesced
    quotes and equals the sum of the stored per-family term breakdowns
    exactly (the pricing-consistency invariant the tests pin at 1e-9);
    `ratio` = best joint total / naïve per-call total ≤ 1.
    `schedules[family]` is the family's leaf-axis `CompiledSchedule`
    (`get_family_executable`), bound to the chosen wire."""
    axes: tuple[tuple[str, int], ...]    # live axes (n > 1), leaf first
    quotes: dict = field(default_factory=dict)   # family -> quote row
    total_per_call: float = 0.0          # Σ count · per-call quote
    total_joint: float = 0.0             # Σ coalesced quotes
    total_best: float = 0.0              # Σ min(coalesced, pipelined)
    ratio: float = 1.0                   # total_best / total_per_call
    schedules: dict = field(default_factory=dict)  # family -> leaf schedule
    precision: str = "f32"               # chosen wire format (all families)
    source: str = "cold"
    key: str = ""


@dataclass(frozen=True)
class RefitPolicy:
    """When does observed drift trigger an online refit? (DESIGN.md §10)

    A level class refits when its residual tracker holds at least
    `min_samples` post-(re)fit observations AND the drift statistic
    (median |measured − predicted| / predicted) exceeds
    `drift_threshold`. After a refit, `cooldown` fresh observations must
    accumulate before the same level may refit again — the loop must
    converge on measurements of the *new* params, not chase its own
    transient. `enabled=False` keeps observation/telemetry recording but
    never refits (monitor-only deployments).

    `term_attribution=True` makes each refit event carry a per-term
    diagnosis: the cost-ledger window for the level is solved for the
    per-term drift multipliers (`core.fitting.attribute_term_drift`), so
    the event says *which* GenModel term drifted ("δ drifted 3×, α
    stable") instead of only the blind median drift (DESIGN.md §11)."""
    drift_threshold: float = 0.2
    min_samples: int = 8
    cooldown: int = 32
    enabled: bool = True
    term_attribution: bool = True
    # Refit guardrails (DESIGN.md §12): reject NaN/negative/implausible
    # fitted params (`calibrate.validate_params`), clamp per-refit
    # movement of each term to the guard's max_step_ratio
    # (`calibrate.clamp_params`), and quarantine outlier telemetry
    # samples before fitting (`calibrate.quarantine_outliers`, k =
    # `quarantine_k`; None/0 disables). `guardrails=False` restores the
    # pre-§12 trust-the-fit behaviour.
    guardrails: bool = True
    quarantine_k: float = 4.0


def _decisions_to_json(decisions) -> dict:
    return {sw: {"algo": d.algo, "factors": d.factors,
                 "rearrange": {str(k): v for k, v in d.rearrange.items()},
                 "cost": d.cost}
            for sw, d in decisions.items()}


class PlannerService:
    """Thread-safe facade over fingerprint + cache + calibrate + skew."""

    def __init__(self, params: Mapping[str, GenModelParams] | None = None,
                 cache: PlanCache | None = None, *,
                 cache_path: str | None = None, capacity: int = 128,
                 autosave: bool = False,
                 skew: SkewModel | None = None,
                 baseline_kinds: tuple[str, ...] = ("cps", "ring", "rhd"),
                 gentree_kwargs: dict | None = None,
                 engine: str | None = None,
                 telemetry: Telemetry | None = None,
                 refit_policy: RefitPolicy | None = None):
        self.params = dict(params) if params else None
        # `cache or ...` would discard a caller-supplied EMPTY cache
        # (PlanCache defines __len__, so a cold cache is falsy)
        self.cache = cache if cache is not None \
            else PlanCache(capacity=capacity, path=cache_path,
                           autosave=autosave)
        self.skew = skew
        self.baseline_kinds = baseline_kinds
        self.gentree_kwargs = dict(gentree_kwargs or {})
        # plan-evaluation engine for cold generation / re-ranking:
        # "fast" (compiled, default) or "reference" (pure-Python oracle)
        self.engine = engine
        self.calibration: CalibrationResult | None = None
        # closed-loop controller state (DESIGN.md §10): the shared
        # runtime telemetry hub observations land in, the policy that
        # decides when drift triggers a refit, and the refit audit log
        self.telemetry = telemetry or Telemetry()
        self.refit_policy = refit_policy or RefitPolicy()
        # bounded audit log (stats() serializes it; a drifty multi-year
        # deployment must not accumulate an unbounded history)
        self.refits: deque = deque(maxlen=256)
        self._since_refit: dict[str, int] = {}
        # observe hot-path caches (gated < 1% of a simulated step):
        # merged (γ/δ-from-server) level params, exact-size default
        # predictions, and per-level telemetry handles. Entries are
        # tagged with _params_version — a params swap (calibrate/refit)
        # bumps the version, so a concurrent observer that computed
        # against the old basis can never repopulate the cache with
        # stale params after the swap.
        self._params_version = 0
        self._merged_cache: dict[str, tuple[int, GenModelParams]] = {}
        self._pred_cache: dict[tuple, tuple[int, float]] = {}
        # per-shape GenModel term breakdowns (cost_model.CostBreakdown)
        # feeding the cost ledger — same versioning contract as above
        self._shares_cache: dict[tuple, tuple[int, object]] = {}
        self._obs_handles: dict[str, tuple] = {}
        # degraded-level health map (DESIGN.md §12): level class →
        # bandwidth multiplier in (0, 1). Applied to every pricing basis
        # via _apply_health, so a degraded link reprices (β/factor) and
        # refingerprints (the synthesized switch topology's uplink_bw
        # realizes β) without touching the stored params.
        self._degraded: dict[str, float] = {}
        # all_to_all / p2p schedules, memoized per (family, n)
        self._family_scheds: dict[tuple[str, int], object] = {}
        self._lock = threading.RLock()

    # ---- calibration -------------------------------------------------------
    def calibrate(self, source: Mapping[str, GenModelParams] | None = None,
                  cfg: CalibrationConfig | None = None) -> CalibrationResult:
        """Refit GenModelParams from measurements and make the fitted set
        the service's pricing basis (every axis path included: once
        calibrated, `GPU_AXIS_BASIS` prices nothing). Invalidates nothing
        explicitly — the params fingerprint is part of every cache key, so
        plans priced under the old params simply stop being hit.
        `cfg.backend="torch"` measures on the card (`calibrate.
        TorchProvider`) and raises without one."""
        result = calibrate_levels(source or self.params or PAPER_TABLE5,
                                  cfg)
        with self._lock:
            self.params = dict(result.params)
            self.calibration = result
            self._params_version += 1
            self._merged_cache.clear()
            self._pred_cache.clear()
            self._shares_cache.clear()
        return result

    # ---- degraded-mode health (DESIGN.md §12) ------------------------------
    def _apply_health(self, eff: Mapping[str, GenModelParams]
                      ) -> dict[str, GenModelParams]:
        """The pricing basis with degraded levels repriced: a level at
        bandwidth multiplier f pays β/f per unit. Every axis pricing and
        execution path flows through this, and β determines the
        synthesized switch topology's uplink bandwidth — so a degrade
        changes both the params fingerprint and the topo fingerprint,
        making every plan priced for the healthy link unreachable."""
        if not self._degraded:
            return dict(eff)
        out = dict(eff)
        for lvl, f in self._degraded.items():
            p = out.get(lvl)
            if p is not None and 0.0 < f < 1.0:
                out[lvl] = dataclasses.replace(p, beta=p.beta / f)
        return out

    def mark_degraded(self, level: str, factor: float) -> int:
        """Declare `level`'s links degraded to `factor` × nominal
        bandwidth (0 < factor < 1; ≥ 1 clears). Bumps the params version,
        clears the pricing caches, drops every derived executable and
        opens a telemetry re-measure window — the planner replans around
        the degraded link on the next lookup, under a new fingerprint.
        Returns the number of derived artifacts dropped.

        Unlike the reference service, a restore re-arms no guards: the
        port's schedule guard never demotes (`core.lower.GuardedSchedule`),
        so no guard is pinned to a fallback a restore could release."""
        factor = float(factor)
        if factor <= 0.0:
            raise ValueError(f"degrade factor must be > 0: {factor}")
        with self._lock:
            if factor >= 1.0:
                self._degraded.pop(level, None)
            else:
                self._degraded[level] = factor
            self._params_version += 1
            self._merged_cache.clear()
            self._pred_cache.clear()
            self._shares_cache.clear()
        dropped = self.invalidate_executables()
        m = default_metrics()
        m.counter("planner_degrade_events_total",
                  "level health transitions (degrade/restore)").inc()
        m.gauge("planner_degraded_levels",
                "level classes currently marked degraded"
                ).set(float(len(self._degraded)))
        default_tracer().instant("planner/degrade", level=level,
                                 factor=factor, dropped=dropped)
        # measurements of the healthy link must not steer a refit of the
        # degraded one (and vice versa on restore)
        self.telemetry.remeasure("degrade", {"level": level,
                                             "factor": factor,
                                             "dropped": dropped})
        return dropped

    def clear_degraded(self, level: str | None = None) -> None:
        """Restore `level` (or every level) to nominal health; reprices
        and invalidates exactly like `mark_degraded`."""
        with self._lock:
            levels = [level] if level is not None \
                else list(self._degraded)
        for lvl in levels:
            self.mark_degraded(lvl, 1.0)

    def degraded(self) -> dict[str, float]:
        with self._lock:
            return dict(self._degraded)

    # ---- the online loop: observe -> drift -> refit -> invalidate ----------
    def _effective_axis_params(self) -> dict[str, GenModelParams]:
        """Pricing basis for mesh-axis requests: the axis paths
        (`get_axis_executable`, `get_family_executable`,
        `get_axis_plans`) default to GPU_AXIS_BASIS (the GPU testbed,
        its NVLink row for the leaf class) when the service is
        uncalibrated, and observation/refit must price against the same
        basis those paths quoted. Health-adjusted (`_apply_health`): a
        degraded level prices at its sagged β."""
        return self._apply_health(self.params if self.params is not None
                                  else GPU_AXIS_BASIS)

    def _merged_level_params(self, level: str,
                             eff: Mapping[str, GenModelParams]
                             ) -> GenModelParams:
        """The level's pricing params with the compute terms (γ/δ) taken
        from the chip ("server") class — exactly how `plan_axes_gentree`
        and the simulator charge them, so CPS-equivalence factors and
        refit targets price the same model the planner does."""
        srv = eff.get("server", GenModelParams())
        p = eff.get(level, srv)
        return dataclasses.replace(p, gamma=srv.gamma, delta=srv.delta)

    def observe(self, level: str, n: int, size_floats: float,
                measured: float, *, predicted: float | None = None,
                key: str | None = None, dtype: str = "float32",
                precision: str | None = None,
                params: Mapping[str, GenModelParams] | None = None,
                source: str = "mesh") -> dict:
        """Feed one measured collective back into the loop (DESIGN.md
        §10): an AllReduce of `size_floats` data units over a mesh axis
        of `n` devices at Table-5 class `level` took `measured` seconds.

        Records the predicted-vs-measured residual (keyed by `level` and,
        when given, by the plan fingerprint `key`), files the sample as a
        CPS-equivalent calibration point, and — when the level's drift
        exceeds the refit policy — refits that level's `GenModelParams`
        from the accumulated telemetry through the same `core.fitting`
        path as offline calibration. The params swap flows through the
        fingerprints (stale plans become unreachable) and every derived
        `CompiledSchedule`/bucket plan is dropped, so the next lookup
        lowers a fresh schedule under the refitted model: a hot swap,
        never a stale execution.

        `predicted` defaults to the service's own price for that axis at
        the exact size; pass `precision` (a PRECISIONS name) when the
        measured sync ran a compressed wire, so the default prediction
        and the per-term ledger shares price the same compressed plan
        the devices executed (quant passes in γ/δ, shrunk β/incast —
        DESIGN.md §13). A `params` override records timing rings but is
        excluded from refit — per-request overrides are not the
        service's pricing basis, so they must not steer it.

        `source="local_mesh"` marks a time taken on a local mesh (all
        ranks on one device): it measures that device's rounds and
        launches, not the level's links, so it is tracked for monitoring
        under `level/<level>@local_mesh` (its drift is that tracker's)
        and never feeds a sample, the ledger or a refit.
        `source="host_staged"` marks a time taken on a process mesh whose
        rounds are staged through the host (gloo with every rank on one
        card): it measures host staging, not links, and is tracked the
        same way under `level/<level>@host_staged`.

        Returns {"level", "rel_residual", "drift", "samples", "refit"}.
        """
        if source not in ("mesh", "local_mesh", "host_staged"):
            raise ValueError(f"unknown observation source {source!r}")
        override = params is not None
        # version read BEFORE the params: a concurrent swap after this
        # point tags our cache writes with the old version, so they are
        # recomputed (never trusted) by post-swap observers
        ver = self._params_version
        eff = dict(params) if override else self._effective_axis_params()
        n = int(n)
        size_floats = max(float(size_floats), 1.0)
        measured = float(measured)
        prec = None
        if precision is not None and precision != "f32":
            from repro_torch.core.cost_model import PRECISIONS
            prec = PRECISIONS[precision]
        pname = prec.name if prec is not None else "f32"
        if predicted is None:
            # exact-size default pricing, memoized per params version:
            # the probe/serve wiring observes the same shapes repeatedly
            # and the full halves pricing (plan lookup + rescale +
            # simulate) must stay off the hot path
            pk = (level, n, round(size_floats, 6), dtype, pname) \
                if not override else None
            cached = None if pk is None else self._pred_cache.get(pk)
            if cached is not None and cached[0] == ver:
                predicted = cached[1]
            else:
                t_rs, t_ag = self._axis_halves_time(n, level, size_floats,
                                                    dtype, eff,
                                                    precision=prec)
                predicted = t_rs + t_ag
                if pk is not None:
                    self._pred_cache[pk] = (ver, predicted)
        # per-level ring + tracker handles resolved once (hot path)
        handles = self._obs_handles.get(level)
        if handles is None:
            handles = (self.telemetry.ring(f"observe/{level}"),
                       self.telemetry.residuals(f"level/{level}"))
            self._obs_handles[level] = handles
        ring, tracker = handles
        ring.add(measured)
        if source in ("local_mesh", "host_staged"):
            local = self.telemetry.residuals(f"level/{level}@{source}")
            rel = local.record(predicted, measured)
            return {"level": level, "predicted": float(predicted),
                    "measured": measured, "rel_residual": rel,
                    "refit": False, "drift": local.drift(),
                    "samples": 0}
        if override:
            # a per-request override is not the service's pricing basis:
            # its residuals are tracked under the plan fingerprint (and
            # the measured ring above) for monitoring, but must not
            # enter the level tracker that steers the refit trigger
            rel = self.telemetry.residuals(
                key and f"plan/{key}" or f"level/{level}@override"
            ).record(predicted, measured)
            return {"level": level, "predicted": float(predicted),
                    "measured": measured, "rel_residual": rel,
                    "refit": False, "drift": tracker.drift(),
                    "samples": 0}
        rel = tracker.record(predicted, measured)
        if key:
            self.telemetry.residuals(f"plan/{key}").record(predicted,
                                                           measured)
        out = {"level": level, "predicted": float(predicted),
               "measured": measured, "rel_residual": rel, "refit": False}

        entry = self._merged_cache.get(level)
        if entry is not None and entry[0] == ver:
            merged = entry[1]
        else:
            merged = self._merged_level_params(level, eff)
            self._merged_cache[level] = (ver, merged)
        from repro_torch.core.fitting import cps_equivalent_time
        self.telemetry.record_sample(level, LevelSample(
            n=n, size_floats=size_floats, measured=measured,
            cps_equivalent=cps_equivalent_time(n, size_floats, measured,
                                               predicted, merged)))
        # cost ledger (DESIGN.md §11): the quoted prediction decomposed
        # into per-term seconds — proportions from the GenModel walk over
        # the executed plan structure, rescaled so they sum to the quoted
        # prediction exactly — filed next to the measured wall time. The
        # breakdown is memoized per shape under the same params-version
        # contract as the prediction itself.
        sk = (level, n, round(size_floats, 6), dtype, pname)
        sentry = self._shares_cache.get(sk)
        if sentry is not None and sentry[0] == ver:
            breakdown = sentry[1]
        else:
            breakdown = self._axis_term_shares(n, level, size_floats,
                                               dtype, eff, merged,
                                               precision=prec)
            self._shares_cache[sk] = (ver, breakdown)
        self.telemetry.ledger.record(LedgerEntry(
            level=level, n=n, size_floats=size_floats,
            predicted=float(predicted), measured=measured,
            shares=breakdown.scaled_to(float(predicted)).as_dict()))
        default_metrics().counter(
            "planner_observations_total",
            "collectives fed back through PlannerService.observe").inc()
        with self._lock:
            self._since_refit[level] = self._since_refit.get(level, 0) + 1
            since = self._since_refit[level]
        out["drift"] = tracker.drift()
        out["samples"] = self.telemetry.sample_count(level)
        pol = self.refit_policy
        refit_now = False
        if pol.enabled and out["drift"] > pol.drift_threshold \
                and tracker.count >= pol.min_samples \
                and self._sample_diversity(level) >= 2 \
                and level not in self._degraded:
            # a degraded level is known, repriced state (DESIGN.md §12):
            # its drift reflects the sag the health map already models,
            # so fitting telemetry from it would bake a transient fault
            # into the calibrated params
            # claim the refit under the lock: concurrent observers must
            # not both fit (the second would find the samples consumed)
            with self._lock:
                refitted_before = any(r["level"] == level
                                      for r in self.refits)
                need = max(pol.cooldown, pol.min_samples) \
                    if refitted_before else pol.min_samples
                if self._since_refit.get(level, 0) >= need:
                    self._since_refit[level] = 0
                    refit_now = True
        if refit_now:
            res = self._refit_level(level, drift=out["drift"],
                                    observations=since)
            out.update(res)
            # a guardrail rejection is not a refit: the pricing basis
            # did not change (DESIGN.md §12)
            out["refit"] = not res.get("rejected")
        return out

    def _sample_diversity(self, level: str) -> int:
        """Distinct (n, size) points among the level's telemetry samples.
        A fit from one repeated point would be rank-deficient (the
        provider refuses it too) — a deployment observing a single shape
        (e.g. serve's fixed decode size) reports drift but never swaps
        in degenerate params."""
        return len({(s.n, round(s.size_floats, 6))
                    for s in self.telemetry.samples(level)})

    def _refit_level(self, level: str, *, drift: float,
                     observations: int) -> dict:
        """Refit one level class from accumulated telemetry and hot-swap:
        new params → new fingerprints (stale plans unreachable) AND every
        derived executable artifact dropped (`invalidate_executables`),
        so no stale `CompiledSchedule` can ever execute after the swap."""
        tracer = default_tracer()
        metrics = default_metrics()
        # diagnose BEFORE the fit consumes the window: solve the level's
        # cost-ledger entries for per-term drift multipliers so the refit
        # event names the drifting term (m_t ≈ 1 → stable; see
        # core.fitting.attribute_term_drift and DESIGN.md §11)
        term_drift = None
        if self.refit_policy.term_attribution:
            entries = self.telemetry.ledger.entries(level)
            if entries:
                from repro_torch.core.fitting import attribute_term_drift
                term_drift = attribute_term_drift(
                    [e.shares for e in entries],
                    [e.measured for e in entries])
        eff = self._effective_axis_params()
        # the fit's Fig.-4 fallback must pin the γ/δ the pricing paths
        # actually charge (the chip class), not the level's own defaults
        source = dict(eff)
        source[level] = self._merged_level_params(level, eff)
        pol = self.refit_policy
        provider = TelemetryProvider(self.telemetry,
                                     min_samples=pol.min_samples,
                                     quarantine_k=(pol.quarantine_k
                                                   if pol.guardrails
                                                   else None))
        with tracer.span("planner/refit", level=level, drift=drift):
            result = calibrate_levels(source,
                                      CalibrationConfig(levels=(level,)),
                                      provider=provider)
            fitted = result.params[level]
            clamped: list[str] = []
            if pol.guardrails:
                # refit guardrails (DESIGN.md §12): a NaN/negative/
                # implausible fit never becomes the fleet's pricing
                # basis, and a plausible one moves each term by at most
                # the guard's step ratio per refit
                from .calibrate import clamp_params, validate_params
                violations = validate_params(fitted)
                if violations:
                    return self._reject_refit(level, drift=drift,
                                              observations=observations,
                                              violations=violations,
                                              term_drift=term_drift)
                # clamp against the merged (γ/δ-from-server) basis the
                # fit targeted and the pricing paths charge — clamping
                # against the raw level row would "correct" the compute
                # terms back toward the level's defaults on every refit
                fitted, clamped = clamp_params(
                    self._merged_level_params(level, eff), fitted)
                if clamped:
                    metrics.counter(
                        "planner_refit_params_clamped_total",
                        "fitted terms clamped to the per-refit movement "
                        "bound").inc(len(clamped))
                result.params[level] = fitted
            with self._lock:
                # the raw basis: a degraded level's sag stays in the
                # health map, never in the stored params
                base = dict(self.params if self.params is not None
                            else GPU_AXIS_BASIS)
                base[level] = fitted
                self.params = base
                self.calibration = result
                self._params_version += 1
                self._merged_cache.clear()
                self._pred_cache.clear()
                self._shares_cache.clear()
            dropped = self.invalidate_executables()
        # post-swap: old residuals, samples and ledger rows were measured
        # against the pre-refit params — drift detection restarts from
        # fresh data
        self.telemetry.clear_samples(level)
        self.telemetry.residuals(f"level/{level}").reset()
        self.telemetry.ledger.clear(level)
        event = {"level": level, "drift": drift,
                 "observations": observations, "dropped": dropped,
                 "term_drift": term_drift, "clamped": clamped,
                 "quarantined": provider.quarantined,
                 "params": dataclasses.asdict(result.params[level])}
        self.refits.append(event)
        self.telemetry.events.append(
            TelemetryEvent("refit", {"level": level, "drift": drift,
                                     "dropped": dropped,
                                     "term_drift": term_drift}))
        metrics.counter("planner_refits_total",
                        "online GenModel refits triggered by drift").inc()
        metrics.gauge("planner_params_version",
                      "pricing-basis version (bumps on calibrate/refit)"
                      ).set(self._params_version)
        return {"dropped": dropped, "term_drift": term_drift}

    def _reject_refit(self, level: str, *, drift: float,
                      observations: int, violations: list,
                      term_drift) -> dict:
        """Guardrail rejection (DESIGN.md §12): the fit produced garbage
        (NaN / negative / implausible terms), so the pricing basis stays
        untouched. The poisoned sample window is discarded — the next
        refit attempt must argue from fresh measurements, and the
        cooldown applies (the rejection is logged in the audit deque the
        trigger consults) so a persistent fault can't hammer the fitter.
        """
        self.telemetry.clear_samples(level)
        self.telemetry.residuals(f"level/{level}").reset()
        self.telemetry.ledger.clear(level)
        event = {"level": level, "drift": drift,
                 "observations": observations, "dropped": 0,
                 "term_drift": term_drift, "rejected": violations}
        self.refits.append(event)
        self.telemetry.events.append(
            TelemetryEvent("refit_rejected",
                           {"level": level, "drift": drift,
                            "violations": violations}))
        default_metrics().counter(
            "planner_refits_rejected_total",
            "refits rejected by the param guardrails").inc()
        default_tracer().instant("planner/refit_rejected", level=level,
                                 violations=len(violations))
        return {"dropped": 0, "term_drift": term_drift,
                "rejected": violations}

    def observe_arrivals(self, arrivals) -> None:
        """Record one collective's per-device arrival times into the
        telemetry arrival estimator (feeds the empirical skew mode)."""
        self.telemetry.record_arrivals(arrivals)

    def adopt_empirical_skew(self, *, draws: int = 8, seed: int = 0,
                             min_collectives: int = 1) -> SkewModel | None:
        """Swap the service's skew model for an *empirical* one built
        from measured per-device arrival offsets (`SkewModel.
        from_offsets`). The skew key is part of every plan fingerprint,
        so plans re-ranked under synthetic (or no) skew stop being hit
        and the next lookup re-prices under the measured arrival
        pattern. Returns the adopted model, or None when telemetry has
        no usable offsets yet."""
        est = self.telemetry.arrivals
        if est.n_devices < 2 or est.count < min_collectives:
            return None
        model = SkewModel.from_offsets(est.offsets(), draws=draws,
                                       seed=seed)
        with self._lock:
            self.skew = model
        return model

    # ---- full-topology plans ----------------------------------------------
    def _effective_params(self) -> dict[str, GenModelParams]:
        return self.params or PAPER_TABLE5

    def get_plan(self, topo: TopoNode, nbytes: int | float,
                 dtype: str = "float32", *,
                 params: Mapping[str, GenModelParams] | None = None
                 ) -> PlanResponse:
        """`params` overrides the service's pricing basis for this request
        only (e.g. a caller's explicit params); the override is part of the cache
        key, so differently-priced requests never share an entry."""
        topo.finalize()
        dsize = DTYPE_BYTES.get(dtype, 4)
        bucket = self.cache.bucket(nbytes)
        size_floats = float(bucket) / dsize
        params = dict(params) if params else self._effective_params()
        extra = (tuple(sorted(self.gentree_kwargs.items())),
                 self.skew.key() if self.skew else None)
        key = plan_key(topo, params, bucket, dtype, extra=extra)

        entry = self.cache.get(key)
        if entry is not None:
            obj = entry.get("_obj")
            source = "memory" if obj is not None else "disk"
            plan = obj if obj is not None else plan_from_json(entry["plan"])
            if obj is None:
                entry["_obj"] = plan
            return PlanResponse(
                plan=plan, algo=entry["algo"],
                predicted_time=entry["predicted_time"],
                decisions=entry.get("decisions", {}),
                expected_skewed_time=entry.get("expected_skewed_time"),
                source=source, key=key, nbytes_bucket=bucket,
                size_floats=size_floats)

        # ---- cold path: generate, (optionally) re-rank under skew --------
        with default_tracer().span("planner/generate_plan",
                                   servers=topo.num_servers(),
                                   bucket=bucket):
            result = gentree_mod.gentree(topo, size_floats, params=params,
                                         engine=self.engine,
                                         **self.gentree_kwargs)
            algo, plan = "gentree", result.plan
            decisions = _decisions_to_json(result.decisions)
            skewed = None
            if self.skew is not None and self.skew.scale > 0.0:
                candidates = [("gentree", result.plan)]
                n = topo.num_servers()
                for kind in self.baseline_kinds:
                    if kind == "rhd" and (n & (n - 1)) != 0:
                        continue
                    if n < 2:
                        continue
                    candidates.append(
                        (kind, gentree_mod.baseline_plan(kind, topo,
                                                         size_floats)))
                algo, plan, skewed = pick_plan_under_skew(
                    candidates, topo, self.skew, params, unit_bytes=dsize,
                    engine=self.engine)
                if algo != "gentree":
                    # per-switch decisions describe the discarded GenTree
                    # plan, not the baseline that won — don't mis-report
                    # them
                    decisions = {}
            sim = Simulator(topo, params, unit_bytes=dsize,
                            engine=self.engine)
            predicted = sim.simulate(plan).total

            entry = {"plan": plan_to_json(plan), "algo": algo,
                     "predicted_time": predicted, "decisions": decisions,
                     "expected_skewed_time": skewed,
                     "nbytes_bucket": bucket, "_obj": plan}
            self.cache.put(key, entry)
        return PlanResponse(plan=plan, algo=algo, predicted_time=predicted,
                            decisions=decisions, expected_skewed_time=skewed,
                            source="cold", key=key, nbytes_bucket=bucket,
                            size_floats=size_floats)

    # ---- executable plans (lowered schedules) ------------------------------
    def _config_extra(self) -> tuple:
        return (tuple(sorted(self.gentree_kwargs.items())), self.engine)

    def get_executable(self, topo: TopoNode, nbytes: int | float,
                       dtype: str = "float32", *, placement=None,
                       params: Mapping[str, GenModelParams] | None = None
                       ) -> PlanResponse:
        """`get_plan` + the plan lowered to an executable
        schedule (core.lower.CompiledSchedule, DESIGN.md §8).

        Cache contract: the schedule is a derived artifact stored on the
        plan's cache entry under `_exec`, keyed by the placement map — it
        shares the entry's lifetime (LRU eviction or recalibration drops
        plan and schedule together) and is never written to disk; a
        disk-warm plan is re-lowered once per placement. Raises
        `core.lower.LoweringError` if the cached plan is structurally
        invalid or predates block annotations.
        """
        from repro_torch.core.lower import lower_plan
        resp = self.get_plan(topo, nbytes, dtype, params=params)
        pkey = ("default" if placement is None
                else tuple(sorted(dict(placement).items()))
                if isinstance(placement, Mapping)
                else tuple(placement))
        with self._lock:
            entry = self.cache.get(resp.key)
            execs = None if entry is None else entry.setdefault("_exec", {})
            sched = None if execs is None else execs.get(pkey)
            if sched is None:
                sched = lower_plan(resp.plan, placement=placement)
                if execs is not None:
                    execs[pkey] = sched
        resp.schedule = sched
        return resp

    def get_axis_executable(self, axis_name: str, n: int,
                            size_floats: float,
                            dtype: str = "float32", *,
                            topo: TopoNode | None = None,
                            level: str = "root_sw",
                            params: Mapping[str, GenModelParams] | None
                            = None) -> PlanResponse:
        """Executable plan for one mesh axis: the axis is modelled as a
        single-switch topology of `n` servers (pass `topo` for the real
        physical tree) and the GenTree plan is lowered with the identity
        placement — mesh position i executes server i's schedule.

        `level` is the axis's Table-5 class (leaf axis → "root_sw", outer
        axes → "cross_dc" — `core.sync.axis_level` maps mesh positions),
        and `params` optionally overrides the service's pricing basis
        (default: `GPU_AXIS_BASIS` until calibrated): the synthesized
        switch's uplink bandwidth realizes that level's β, exactly as
        `plan_axes_gentree` prices the same axis, so the executed plan is
        the one the model actually argues for. A degraded level prices
        (and replans) at its sagged β, per-request overrides included: a
        degraded link is a property of the fleet, not of the request."""
        eff = (self._apply_health(params) if params
               else self._effective_axis_params())
        if topo is None:
            from repro_torch.core.sync import level_switch_topo
            topo = level_switch_topo(int(n), eff, level)
        dsize = DTYPE_BYTES.get(dtype, 4)
        return self.get_executable(topo, max(size_floats, 1.0) * dsize,
                                   dtype, params=eff)

    def get_family_executable(self, family: str, axis_name: str, n: int,
                              size_floats: float, dtype: str = "float32",
                              *, topo: TopoNode | None = None,
                              level: str = "root_sw",
                              params: Mapping[str, GenModelParams] | None
                              = None) -> PlanResponse:
        """Executable schedule for ONE collective family on one mesh axis
        (DESIGN.md §14). The axis is a single switch of `n` servers unless
        `topo` gives the physical tree, as for `get_axis_executable`.

        allreduce delegates to `get_axis_executable`. reduce_scatter /
        allgather lower the matching half of the SAME GenTree AllReduce
        plan the axis would run (`plans.family_halves`) — co-planned with
        allreduce by construction, cached on that plan's entry under a
        family-keyed `_exec` slot (same lifetime/invalidation as every
        derived schedule). all_to_all / p2p schedules are structurally
        size-independent (one full-mesh / one shift round whatever the
        payload), so they memoize per (family, n) on the service and are
        dropped by `invalidate_executables` like any executable."""
        from repro_torch.core import plans as plans_mod
        from repro_torch.core.cost_model import evaluate_plan
        from repro_torch.core.lower import lower_plan
        from repro_torch.core.sync import level_switch_topo

        family = FAMILY_ALIASES.get(family, family)
        if family == "allreduce":
            return self.get_axis_executable(axis_name, int(n), size_floats,
                                            dtype, topo=topo, level=level,
                                            params=params)
        eff = (self._apply_health(params) if params
               else self._effective_axis_params())
        merged = self._merged_level_params(level, eff)
        size_floats = max(float(size_floats), 1.0)
        n = int(n)

        if family in ("reduce_scatter", "allgather"):
            if topo is None:
                topo = level_switch_topo(n, eff, level)
            dsize = DTYPE_BYTES.get(dtype, 4)
            resp = self.get_plan(topo, size_floats * dsize, dtype,
                                 params=eff)
            rs_half, ag_half = plans_mod.family_halves(resp.plan)
            half = rs_half if family == "reduce_scatter" else ag_half
            fkey = ("family", family)
            with self._lock:
                entry = self.cache.get(resp.key)
                execs = (None if entry is None
                         else entry.setdefault("_exec", {}))
                sched = None if execs is None else execs.get(fkey)
                if sched is None:
                    sched = lower_plan(half)
                    if execs is not None:
                        execs[fkey] = sched
            out = dataclasses.replace(
                resp, plan=half, algo=f"{resp.algo}:{family}",
                predicted_time=evaluate_plan(half, merged))
            out.schedule = sched
            return out

        if family in ("all_to_all", "p2p"):
            build = (plans_mod.alltoall_plan if family == "all_to_all"
                     else plans_mod.p2p_plan)
            plan = build(n, size_floats)
            skey = (family, n)
            with self._lock:
                sched = self._family_scheds.get(skey)
                if sched is None:
                    sched = lower_plan(plan)
                    self._family_scheds[skey] = sched
            return PlanResponse(
                plan=plan, algo=family,
                predicted_time=evaluate_plan(plan, merged),
                key=f"family:{family}:{n}", size_floats=size_floats,
                schedule=sched)

        raise ValueError(f"unknown collective family {family!r} "
                         f"(expected one of {plans_mod.FAMILIES})")

    # ---- exact-size pricing (observe's default prediction) -----------------
    @staticmethod
    def _scaled_plan(plan: Plan, f: float) -> Plan:
        """The same plan structure at f× the data size (every transfer
        and reduce scales linearly; block annotations are size-free)."""
        from repro_torch.core.plans import Step
        steps = []
        for st in plan.steps:
            s = Step()
            s.transfers = [dataclasses.replace(t, size=t.size * f)
                           for t in st.transfers]
            s.reduces = [dataclasses.replace(r, size=r.size * f)
                         for r in st.reduces]
            steps.append(s)
        return Plan(plan.name, plan.n, plan.size * f, steps=steps,
                    servers=plan.servers, num_blocks=plan.num_blocks,
                    family=plan.family)

    def _axis_halves_time(self, n: int, level: str, size_floats: float,
                          dtype: str, eff,
                          precision=None) -> tuple[float, float]:
        """(T_RS, T_AG) of the axis's GenTree plan at `size_floats`: the
        per-step simulator costs split at the ReduceScatter boundary (the
        last folding step — the same boundary `core.lower` executes).

        The plan *structure* comes from the size-bucketed cache entry,
        rescaled to the exact requested size before simulation, so the
        price carries no geometric-bucket snapping.

        `precision` (a `cost_model.Precision`) reprices the same plan for
        a compressed wire via `compressed_plan`: β/ε shrink with the wire
        bytes, γ/δ pick up the quant passes (DESIGN.md §13)."""
        from repro_torch.core.sync import level_switch_topo
        topo = level_switch_topo(int(n), eff, level)
        dsize = DTYPE_BYTES.get(dtype, 4)
        size_floats = max(size_floats, 1.0)
        resp = self.get_plan(topo, size_floats * dsize, dtype, params=eff)
        plan = resp.plan
        factor = size_floats / resp.size_floats if resp.size_floats \
            else 1.0
        if abs(factor - 1.0) > 1e-12:
            plan = self._scaled_plan(plan, factor)
        if precision is not None and precision.name != "f32":
            from repro_torch.core.cost_model import compressed_plan
            plan = compressed_plan(plan, precision)
        res = Simulator(topo, eff, unit_bytes=dsize,
                        engine=self.engine).simulate(plan)
        folds = [i for i, st in enumerate(plan.steps) if st.reduces]
        split = folds[-1] if folds else len(plan.steps) - 1
        return (float(sum(res.per_step[:split + 1])),
                float(sum(res.per_step[split + 1:])))

    def _axis_contended_time(self, n: int, level: str,
                             size_floats: float, dtype: str, eff,
                             precision=None) -> float:
        """Joint time of the axis plan's RS half run CONCURRENTLY with
        its AG half, paired round-by-round under the per-link occupancy
        merge (DESIGN.md §15) — the steady-state cost of bucket k's
        ReduceScatter overlapping bucket k−1's AllGather. Shared links
        serialize their β/ε and the summed receive fan-in prices through
        one `_incast` call, so the result sits in
        [max(T_RS, T_AG), T_RS + T_AG] — and an above-threshold summed
        fan-in pushes it toward (or past) the sequential sum, which is
        exactly the signal the {sequential, merged} argmin keys on.

        Same plan fetch / rescale / wire-compression path as
        `_axis_halves_time`; the engine choice mirrors `Simulator`
        (reference walks `cost_model.contended_pair_time`, anything else
        the vectorized `FastEngine.contended_halves_total` — the two
        agree ≤ 1e-9, pinned by tests/test_overlap.py)."""
        from repro_torch.core import plans as plans_mod
        from repro_torch.core.sync import level_switch_topo
        topo = level_switch_topo(int(n), eff, level)
        dsize = DTYPE_BYTES.get(dtype, 4)
        size_floats = max(size_floats, 1.0)
        resp = self.get_plan(topo, size_floats * dsize, dtype, params=eff)
        plan = resp.plan
        factor = size_floats / resp.size_floats if resp.size_floats \
            else 1.0
        if abs(factor - 1.0) > 1e-12:
            plan = self._scaled_plan(plan, factor)
        if precision is not None and precision.name != "f32":
            from repro_torch.core.cost_model import compressed_plan
            plan = compressed_plan(plan, precision)
        if plan.family != "allreduce" or not plan.steps:
            res = Simulator(topo, eff, unit_bytes=dsize,
                            engine=self.engine).simulate(plan)
            return float(sum(res.per_step))
        rs_half, ag_half = plans_mod.family_halves(plan)
        if self.engine == "reference":
            from repro_torch.core.cost_model import contended_pair_time
            t = contended_pair_time(topo, rs_half, ag_half, eff,
                                    unit_bytes=dsize)
        else:
            from repro_torch.core.simfast import FastEngine
            t = FastEngine(topo, eff, unit_bytes=dsize
                           ).contended_halves_total(rs_half, ag_half)
        # which links serialized: surfaced as a gauge + span attributes so
        # a Chrome trace of the sweep shows the contention hot spot
        if rs_half.steps and ag_half.steps:
            from repro_torch.core.overlap import occupancy_summary
            summ = occupancy_summary(topo, rs_half.steps[0],
                                     ag_half.steps[0], unit_bytes=dsize)
            default_metrics().gauge(
                "planner_contended_busiest_link_units",
                "traffic units on the busiest link when RS and AG "
                "rounds of adjacent buckets overlap").set(
                float(summ["busiest_link_units"]))
            with default_tracer().span(
                    "planner/contended_price", n=int(n), level=level,
                    links_shared=int(summ["links_shared"]),
                    busiest_link=int(summ["busiest_link"]),
                    busiest_link_units=float(summ["busiest_link_units"])):
                pass
        return float(t)


    def _axis_term_shares(self, n: int, level: str, size_floats: float,
                          dtype: str, eff, merged: GenModelParams,
                          precision=None):
        """GenModel per-term breakdown (`cost_model.CostBreakdown`) of the
        axis's plan at the exact size — the *proportions* side of the cost
        ledger. Same plan fetch + rescale as `_axis_halves_time`, but
        priced by the single-switch term walk (`evaluate_plan_terms`)
        under the merged (γ/δ-from-server) level params, so each term is
        attributed the way the planner charges it. With a `precision` the
        quant passes land in γ/δ and the shrunk wire in β/ε, keeping the
        per-term drift attribution honest on compressed syncs. The caller
        rescales the breakdown to the quoted prediction (`scaled_to`)."""
        from repro_torch.core.cost_model import evaluate_plan_terms
        from repro_torch.core.sync import level_switch_topo
        topo = level_switch_topo(int(n), eff, level)
        dsize = DTYPE_BYTES.get(dtype, 4)
        size_floats = max(size_floats, 1.0)
        resp = self.get_plan(topo, size_floats * dsize, dtype, params=eff)
        plan = resp.plan
        factor = size_floats / resp.size_floats if resp.size_floats \
            else 1.0
        if abs(factor - 1.0) > 1e-12:
            plan = self._scaled_plan(plan, factor)
        return evaluate_plan_terms(plan, merged, precision=precision)

    def get_bucket_plan(self, axes: Sequence[tuple[str, int]],
                        total_floats: float, dtype: str = "float32", *,
                        params: Mapping[str, GenModelParams] | None = None,
                        config=None,
                        leaf_sizes: Sequence[int] | None = None
                        ) -> BucketPlan:
        """GenModel-argmin gradient bucket size for a DP-axis list, with
        one lowered `CompiledSchedule` per axis (DESIGN.md §9).

        Sweeps powers-of-two bucket sizes (plus the monolithic
        single-bucket candidate) JOINTLY with the wire precision
        (DESIGN.md §13): each (bucket, precision) candidate is priced per
        axis with the configured engine — per-bucket α, the γ/δ
        memory-access terms (including the quant/dequant passes), the
        compressed β and incast all come from GenModel itself — and the
        double-buffered pipeline is modeled
        (`core.bucketing.pipelined_time`: bucket k's AllGather overlaps
        bucket k+1's ReduceScatter). The schedules are resolved via
        `get_axis_executable` for the chosen size only (bound to the
        chosen wire via `CompiledSchedule.with_wire`), so they live on
        that size class's plan entry — lowered once, never re-lowered per
        step. Pass `leaf_sizes` to also model the per-leaf (unbucketed)
        baseline for comparison.

        `config.bucket_bytes` pins the bucket size (the sweep collapses
        to that single candidate, still priced); `config.precision` pins
        the wire format and `config.tolerance` is the error-budget guard
        — with no tolerance the sweep stays lossless, and a pinned
        precision whose budget exceeds the tolerance clamps to f32
        (`cost_model.resolve_precision`). Axes with n == 1 are skipped
        but keep their mesh level, exactly as
        `core.sync.resolve_axis_plans` enumerates.
        """
        import math

        from repro_torch.core.bucketing import (BucketConfig,
                                          contended_pipelined_time,
                                          pipelined_time, serial_time)
        from repro_torch.core.cost_model import (PRECISIONS, allowed_precisions,
                                           resolve_precision)
        from repro_torch.core.sync import AxisPlan, axis_level

        cfg = config or BucketConfig()
        if cfg.precision is not None:
            prec_cands = [resolve_precision(cfg.precision, cfg.tolerance)]
        else:
            prec_cands = allowed_precisions(cfg.tolerance) \
                or [PRECISIONS["f32"]]
        axes = tuple((str(a), int(n)) for a, n in axes)
        live = [(i, a, n) for i, (a, n) in enumerate(axes) if n > 1]
        # uncalibrated, the axis basis is GPU_AXIS_BASIS (the reference
        # prices TPU_V5E): the round's one deliberate pricing difference
        eff = self._apply_health(dict(params) if params
                                 else self.params or GPU_AXIS_BASIS)
        dsize = DTYPE_BYTES.get(dtype, 4)
        total = max(float(total_floats), 1.0)
        leaf_key = (tuple(int(s) for s in leaf_sizes)
                    if leaf_sizes is not None else None)
        key = axis_key(axes, eff, self.cache.bucket(total * dsize),
                       extra=self._config_extra()
                       + ("bucket_plan", cfg.key(), dtype, leaf_key,
                          self.skew.key() if self.skew else None))

        def resolve_axis_plans(bucket_floats: int, prec_name: str = "f32"):
            # hierarchical sizes: the RS chain runs the leaf axis first,
            # so axis k's schedule only ever sees bucket / prod(earlier
            # n) elements — resolve (and price) each axis at the size it
            # actually executes
            wire = PRECISIONS[prec_name] if prec_name != "f32" else None
            out, shard = [], float(bucket_floats)
            for i, a, n in live:
                sched = self.get_axis_executable(
                    a, n, shard, dtype, level=axis_level(i),
                    params=eff).schedule
                if wire is not None:
                    # wire-bound copy lives on the returned BucketPlan (not
                    # the shared size-class entry), so the guard ladder's
                    # per-wire demotion state persists across steps without
                    # leaking into full-precision users of the same plan
                    sched = sched.with_wire(wire)
                out.append(AxisPlan(a, "plan", schedule=sched))
                shard /= n
            return out

        def resolve_merged(plans_list, overlap_info):
            # The merged executable interleaves bucket k's RS rounds with
            # bucket k-1's AG rounds of the SAME axis schedule
            # (core.overlap.merge_schedules memoizes on the schedule, so
            # warm hits share the wrapper). Only built when the contended
            # price beat sequential AND the chain is a single live axis —
            # multi-axis chains keep sequential issuance (the hierarchical
            # handoff already serializes at the axis boundary).
            if overlap_info.get("mode") != "merged" or len(plans_list) != 1:
                return None
            from repro_torch.core.lower import LoweringError
            from repro_torch.core.overlap import merge_schedules
            try:
                sched = plans_list[0].schedule
                return merge_schedules(sched, sched)
            except LoweringError:
                return None

        # one sweep per key: concurrent cold traces against a shared service
        # must not each run the full pricing sweep and race on the schedules
        with self._lock:
            entry = self.cache.get(key)
            if entry is not None:
                obj = entry.get("_obj")
                if obj is not None:
                    return dataclasses.replace(obj, source="memory")
                # disk-warm (or schedule-invalidated) entry: the choice is
                # recorded; only the schedules need re-resolving
                prec_name = str(entry.get("precision", "f32"))
                # pre-§15 snapshots carry no contended quote / overlap
                # verdict: fall back to the optimistic pipeline time and
                # sequential issuance rather than invalidating the entry
                ov = dict(entry.get("overlap") or {})
                plans_list = resolve_axis_plans(
                    int(entry["bucket_floats"]), prec_name)
                obj = BucketPlan(
                    axes=tuple((a, n) for _, a, n in live),
                    bucket_floats=int(entry["bucket_floats"]),
                    bucket_bytes=int(entry["bucket_floats"]) * dsize,
                    num_buckets=int(entry["num_buckets"]),
                    axis_plans=plans_list,
                    predicted_pipelined=entry["pipelined"],
                    predicted_serial=entry["serial"],
                    predicted_contended=float(
                        entry.get("contended", entry["pipelined"])),
                    predicted_per_leaf=entry.get("per_leaf"),
                    pipeline=bool(entry.get("pipeline", True)),
                    sweep={int(b): row for b, row in entry["sweep"].items()},
                    overlap=ov,
                    merged_schedule=resolve_merged(plans_list, ov),
                    precision=prec_name, source="disk", key=key)
                entry["_obj"] = obj
                return obj

            if not live:
                obj = BucketPlan(axes=(), bucket_floats=int(total),
                                 bucket_bytes=int(total) * dsize,
                                 num_buckets=0, pipeline=cfg.pipeline,
                                 source="cold", key=key)
                self.cache.put(key, {"kind": "bucket_plan",
                                     "bucket_floats": int(total),
                                     "num_buckets": 0, "pipelined": 0.0,
                                     "serial": 0.0, "per_leaf": None,
                                     "pipeline": cfg.pipeline, "sweep": {},
                                     "_obj": obj})
                return obj

            # ---- candidate sweep (all pricing through the plan cache) --------
            halves_memo: dict[tuple, tuple[float, float]] = {}
            joint_memo: dict[tuple, float] = {}

            def halves(i: int, n: int, size_floats: float, prec=None):
                lvl = axis_level(i)
                pname = prec.name if prec is not None else "f32"
                mk = (lvl, n, round(max(float(size_floats), 1.0), 6), pname)
                if mk not in halves_memo:
                    halves_memo[mk] = self._axis_halves_time(
                        n, lvl, float(size_floats), dtype, eff,
                        precision=prec)
                return halves_memo[mk]

            def joint(i: int, n: int, size_floats: float, prec=None):
                lvl = axis_level(i)
                pname = prec.name if prec is not None else "f32"
                mk = (lvl, n, round(max(float(size_floats), 1.0), 6), pname)
                if mk not in joint_memo:
                    joint_memo[mk] = self._axis_contended_time(
                        n, lvl, float(size_floats), dtype, eff,
                        precision=prec)
                return joint_memo[mk]

            if cfg.bucket_bytes:
                cands = [max(1, int(cfg.bucket_bytes) // dsize)]
            else:
                cands, nbytes = [], max(cfg.min_bucket_bytes, 4096)
                while nbytes < total * dsize and nbytes <= cfg.max_bucket_bytes:
                    cands.append(max(1, nbytes // dsize))
                    nbytes *= 2
                cands.append(int(math.ceil(total)))    # monolithic: K = 1

            # the honest rank: the contended pipeline estimate (per-link
            # occupancy merge, DESIGN.md §15) replaces the optimistic
            # max(t_rs, t_ag) steady state; the naive "pipelined" row
            # rides along as the lower bound + drift metric
            # (overlap_bench's contended_vs_naive_pipeline_error)
            rank = "contended" if cfg.pipeline else "serial"
            sweep: dict[int, dict] = {}
            with default_tracer().span("planner/bucket_sweep",
                                       candidates=len(cands)
                                       * len(prec_cands)):
                for bf in cands:
                    k = max(1, math.ceil(total / bf))
                    best = None
                    for prec in prec_cands:
                        t_rs = t_ag = t_joint = 0.0
                        shard = float(bf)
                        for i, _a, n in live:
                            rs, ag = halves(i, n, shard, prec)
                            t_rs += rs
                            t_ag += ag
                            if k > 1:
                                t_joint += joint(i, n, shard, prec)
                            shard /= n  # outer axes see inner axes' shard
                        row = {
                            "num_buckets": k, "t_rs": t_rs, "t_ag": t_ag,
                            "t_joint": t_joint,
                            "pipelined": pipelined_time(t_rs, t_ag, k),
                            "contended": contended_pipelined_time(
                                t_rs, t_ag, k,
                                t_joint if k > 1 else None),
                            "serial": serial_time(t_rs, t_ag, k),
                            "precision": prec.name,
                        }
                        # ties break toward fewer bits dropped (f32 first
                        # in allowed_precisions order)
                        if best is None or row[rank] < best[rank]:
                            best = row
                    # t_rs/t_ag/t_joint ride along so consumers
                    # (bucket_bench's CI gate) can recompute the pipeline
                    # model independently instead of tautologically
                    # re-minimizing the stored totals; rows stay keyed by
                    # bucket size, each holding its own argmin over wire
                    # precisions
                    sweep[bf] = best
            chosen = min(sweep, key=lambda b: (sweep[b][rank], b))
            prec_name = str(sweep[chosen].get("precision", "f32"))
            crow = sweep[chosen]
            # per-pair issuance argmin: merge bucket k's RS with bucket
            # k-1's AG only when the contended concurrent price strictly
            # beats running the pair back-to-back — the planner can prove
            # it never selects a losing merge (tests/test_overlap.py)
            t_pair_seq = float(crow["t_rs"] + crow["t_ag"])
            merged_wins = bool(cfg.pipeline
                               and int(crow["num_buckets"]) > 1
                               and crow["t_joint"] > 0.0
                               and crow["t_joint"] < t_pair_seq)
            overlap = {
                "mode": "merged" if merged_wins else "sequential",
                "t_joint": float(crow["t_joint"]),
                "t_pair_sequential": t_pair_seq,
                "t_pair_naive": float(max(crow["t_rs"], crow["t_ag"])),
            }

            per_leaf = None
            if leaf_sizes is not None:
                per_leaf = 0.0
                for s in leaf_sizes:
                    if s <= 0:
                        continue
                    shard = float(s)
                    for i, _a, n in live:
                        rs, ag = halves(i, n, shard)
                        per_leaf += rs + ag
                        shard /= n

            plans_list = resolve_axis_plans(int(chosen), prec_name)
            obj = BucketPlan(
                axes=tuple((a, n) for _, a, n in live),
                bucket_floats=int(chosen), bucket_bytes=int(chosen) * dsize,
                num_buckets=int(crow["num_buckets"]),
                axis_plans=plans_list,
                predicted_pipelined=crow["pipelined"],
                predicted_serial=crow["serial"],
                predicted_contended=crow["contended"],
                predicted_per_leaf=per_leaf, pipeline=cfg.pipeline,
                sweep=sweep, overlap=overlap,
                merged_schedule=resolve_merged(plans_list, overlap),
                precision=prec_name, source="cold", key=key)
            self.cache.put(key, {
                "kind": "bucket_plan", "bucket_floats": int(chosen),
                "num_buckets": int(crow["num_buckets"]),
                "pipelined": crow["pipelined"],
                "contended": crow["contended"],
                "serial": crow["serial"], "per_leaf": per_leaf,
                "pipeline": cfg.pipeline, "precision": prec_name,
                "overlap": overlap,
                "sweep": {str(b): row for b, row in sweep.items()},
                "_obj": obj})
            return obj

    # ---- whole-step co-planning (every collective family) ------------------
    def _family_axis_terms(self, family: str, i: int, n: int,
                           size_floats: float, dtype: str, eff,
                           precision=None):
        """GenModel per-term breakdown of one family call on one axis.
        allreduce / reduce_scatter / allgather price the axis's cached
        GenTree plan (resp. its `family_halves`) rescaled to the exact
        size — the same co-planned structure `get_family_executable`
        lowers; all_to_all / p2p price their flat builders."""
        from repro_torch.core import plans as plans_mod
        from repro_torch.core.cost_model import evaluate_plan_terms
        from repro_torch.core.sync import axis_level, level_switch_topo

        lvl = axis_level(i)
        merged = self._merged_level_params(lvl, eff)
        size_floats = max(float(size_floats), 1.0)
        if family in ("allreduce", "reduce_scatter", "allgather"):
            topo = level_switch_topo(int(n), eff, lvl)
            dsize = DTYPE_BYTES.get(dtype, 4)
            resp = self.get_plan(topo, size_floats * dsize, dtype,
                                 params=eff)
            plan = resp.plan
            factor = size_floats / resp.size_floats if resp.size_floats \
                else 1.0
            if abs(factor - 1.0) > 1e-12:
                plan = self._scaled_plan(plan, factor)
            if family != "allreduce":
                rs_half, ag_half = plans_mod.family_halves(plan)
                plan = rs_half if family == "reduce_scatter" else ag_half
        elif family == "all_to_all":
            plan = plans_mod.alltoall_plan(int(n), size_floats)
        elif family == "p2p":
            plan = plans_mod.p2p_plan(int(n), size_floats)
        else:
            raise ValueError(f"unknown collective family {family!r}")
        return evaluate_plan_terms(plan, merged, precision=precision)

    @staticmethod
    def _normalize_mix(mix) -> dict[str, tuple[int, float]]:
        """Mix spec → {family: (count, per_call_size_floats)}. Accepts a
        `launch.analysis.ModuleStats` (the per-family payload / count
        ledger a `census()` of a torch step fills) or an explicit mapping
        of family → (count, size_floats) / {"count": …, "size_floats":
        …}."""
        if hasattr(mix, "coll_counts") and hasattr(mix, "coll_by_kind"):
            from repro_torch.launch.analysis import mix_from_stats
            mix = mix_from_stats(mix)
        out: dict[str, tuple[int, float]] = {}
        for fam, v in dict(mix).items():
            fam = FAMILY_ALIASES.get(fam, fam)
            if isinstance(v, Mapping):
                cnt = int(v.get("count", 1))
                sz = float(v.get("size_floats", 0.0))
            else:
                cnt, sz = int(v[0]), float(v[1])
            if cnt > 0 and sz > 0:
                prev = out.get(fam)
                if prev:  # merge duplicate spellings: total size preserved
                    tot = prev[0] * prev[1] + cnt * sz
                    cnt += prev[0]
                    sz = tot / cnt
                out[fam] = (cnt, sz)
        return out

    def get_step_plan(self, axes: Sequence[tuple[str, int]], mix,
                      dtype: str = "float32", *,
                      params: Mapping[str, GenModelParams] | None = None,
                      precision: str | None = None,
                      tolerance: float | None = None) -> StepPlan:
        """Price a training step's whole collective mix jointly under
        GenModel (DESIGN.md §14) and hand back one leaf-axis executable
        per family.

        `mix` is an explicit {family: (count, size_floats)} spec or a
        `ModuleStats` census (`launch.analysis.census`, its payloads
        over 4 bytes as the reference's `mix_from_stats`). Per family the
        sweep prices three regimes under each allowed wire precision:

          * per-call — count independent launches at the call size (the
            naïve baseline a per-collective planner would quote);
          * coalesced — ONE launch of count·size: α amortizes across
            calls, every linear term (β/γ/δ/ε) is unchanged, so the
            coalesced quote can never exceed count × per-call;
          * pipelined — count launches with call k's AllGather
            overlapping call k+1's ReduceScatter, the
            `core.bucketing.pipelined_time` model `get_bucket_plan`
            applies to buckets (folding families only).

        The argmin picks regime × precision jointly; AllReduce and its
        RS/AG halves price the axis chain hierarchically (leaf first,
        outer axes see the shard), AllToAll/P2P price the leaf axis they
        execute on (expert-parallel dispatch). Answers are cached under
        an axis_key fingerprint — mix, dtype, precision consent and the
        health-adjusted params all reach the key."""
        from repro_torch.core.bucketing import (contended_pipelined_time,
                                                pipelined_time)
        from repro_torch.core.cost_model import (PRECISIONS,
                                                 allowed_precisions,
                                                 resolve_precision)
        from repro_torch.core.optimality import overlap_certificate
        from repro_torch.core.sync import axis_level

        axes = tuple((str(a), int(n)) for a, n in axes)
        live = [(i, a, n) for i, (a, n) in enumerate(axes) if n > 1]
        norm = self._normalize_mix(mix)
        # uncalibrated, the axis basis is GPU_AXIS_BASIS (the reference
        # prices TPU_V5E): the round's one deliberate pricing difference
        eff = self._apply_health(dict(params) if params
                                 else self.params or GPU_AXIS_BASIS)
        dsize = DTYPE_BYTES.get(dtype, 4)
        if precision is not None:
            prec_cands = [resolve_precision(precision, tolerance)]
        else:
            prec_cands = allowed_precisions(tolerance) \
                or [PRECISIONS["f32"]]
        mix_key = tuple(sorted((f, c, round(s, 6))
                               for f, (c, s) in norm.items()))
        total_floats = sum(c * s for c, s in norm.values()) or 1.0
        key = axis_key(axes, eff, self.cache.bucket(total_floats * dsize),
                       extra=self._config_extra()
                       + ("step_plan", mix_key, dtype, precision,
                          tolerance))

        def resolve_schedules(prec_name: str) -> dict:
            wire = PRECISIONS[prec_name] if prec_name != "f32" else None
            out = {}
            if not live:
                return out
            li, la, ln = live[0]
            for fam, (_c, s) in norm.items():
                sched = self.get_family_executable(
                    fam, la, ln, s, dtype, level=axis_level(li),
                    params=eff).schedule
                if wire is not None:
                    sched = sched.with_wire(wire)
                out[fam] = sched
            return out

        with self._lock:
            entry = self.cache.get(key)
            if entry is not None:
                obj = entry.get("_obj")
                if obj is not None:
                    return dataclasses.replace(obj, source="memory")
                prec_name = str(entry.get("precision", "f32"))
                obj = StepPlan(
                    axes=tuple((a, n) for _, a, n in live),
                    quotes={f: dict(q)
                            for f, q in entry["quotes"].items()},
                    total_per_call=float(entry["per_call"]),
                    total_joint=float(entry["joint"]),
                    total_best=float(entry["best"]),
                    ratio=float(entry["ratio"]),
                    schedules=resolve_schedules(prec_name),
                    precision=prec_name, source="disk", key=key)
                entry["_obj"] = obj
                return obj

            if not live or not norm:
                obj = StepPlan(axes=tuple((a, n) for _, a, n in live),
                               source="cold", key=key)
                self.cache.put(key, {
                    "kind": "step_plan", "quotes": {}, "per_call": 0.0,
                    "joint": 0.0, "best": 0.0, "ratio": 1.0,
                    "precision": "f32", "_obj": obj})
                return obj

            def chain_terms(fam: str, s: float, prec):
                """Breakdown summed over the axes the family traverses:
                the folding families run the hierarchical chain (outer
                axes see the inner shard); a2a/p2p run the leaf only."""
                if fam in ("all_to_all", "p2p"):
                    i, _a, n = live[0]
                    return [self._family_axis_terms(fam, i, n, s, dtype,
                                                    eff, precision=prec)]
                shard, out = float(s), []
                for i, _a, n in live:
                    out.append(self._family_axis_terms(
                        fam, i, n, shard, dtype, eff, precision=prec))
                    shard /= n
                return out

            def halves_time(fam: str, s: float, prec):
                """(T_RS, T_AG) for the pipelined regime — only
                meaningful for families with a fold boundary."""
                t_rs = t_ag = 0.0
                shard = float(s)
                for i, _a, n in live:
                    rs, ag = self._axis_halves_time(
                        n, axis_level(i), shard, dtype, eff,
                        precision=prec)
                    if fam == "reduce_scatter":
                        ag = 0.0
                    elif fam == "allgather":
                        rs = 0.0
                    t_rs += rs
                    t_ag += ag
                    shard /= n
                return t_rs, t_ag

            def joint_time(s: float, prec):
                """Contended steady-state round (call k's RS with call
                k-1's AG through the per-link occupancy merge, §15),
                summed over the hierarchical chain. Only allreduce has
                both halves live — single-half families pipeline with a
                degenerate joint (== the live half), which
                `contended_pipelined_time` recovers from t_joint=None."""
                t = 0.0
                shard = float(s)
                for i, _a, n in live:
                    t += self._axis_contended_time(
                        n, axis_level(i), shard, dtype, eff,
                        precision=prec)
                    shard /= n
                return t

            best_pick = None
            with default_tracer().span("planner/step_sweep",
                                       families=len(norm),
                                       precisions=len(prec_cands)):
                for prec in prec_cands:
                    pw = None if prec.name == "f32" else prec
                    quotes: dict[str, dict] = {}
                    tot_call = tot_joint = tot_best = 0.0
                    for fam, (cnt, s) in sorted(norm.items()):
                        call_bds = chain_terms(fam, s, pw)
                        call_t = sum(b.total for b in call_bds)
                        joint_bds = chain_terms(fam, cnt * s, pw)
                        joint = {
                            t: sum(getattr(b, t) for b in joint_bds)
                            for t in call_bds[0].TERMS}
                        joint_t = sum(joint.values())
                        cert = None
                        if cnt > 1 and fam in ("allreduce",
                                               "reduce_scatter",
                                               "allgather"):
                            t_rs, t_ag = halves_time(fam, s, pw)
                            naive = pipelined_time(t_rs, t_ag, cnt)
                            tj = joint_time(s, pw) \
                                if fam == "allreduce" else None
                            piped = contended_pipelined_time(
                                t_rs, t_ag, cnt, tj)
                            # the certificate proves the contended quote
                            # sits between the overlap-adjusted lower
                            # bound (naive pipeline) and sequential
                            cert = overlap_certificate(t_rs, t_ag, cnt,
                                                       piped)
                        else:
                            piped = naive = cnt * call_t
                        # per-call stays a candidate regime (the pipelined
                        # estimate comes from the simulator and the other
                        # two from the term walk — the argmin must never
                        # pick something worse than the naïve baseline)
                        cands = {"coalesced": joint_t, "pipelined": piped,
                                 "per_call": cnt * call_t}
                        mode = min(cands, key=lambda m: (cands[m], m))
                        best_t = cands[mode]
                        quotes[fam] = {
                            "count": cnt, "size_floats": s,
                            "per_call_total": call_t,
                            "joint": joint, "joint_total": joint_t,
                            "pipelined": naive, "contended": piped,
                            "certificate": cert, "mode": mode,
                            "best_total": best_t,
                            "precision": prec.name,
                        }
                        tot_call += cnt * call_t
                        tot_joint += joint_t
                        tot_best += best_t
                    if best_pick is None or tot_best < best_pick[1]:
                        best_pick = (prec.name, tot_best, tot_joint,
                                     tot_call, quotes)

            prec_name, tot_best, tot_joint, tot_call, quotes = best_pick
            ratio = tot_best / tot_call if tot_call > 0 else 1.0
            obj = StepPlan(
                axes=tuple((a, n) for _, a, n in live), quotes=quotes,
                total_per_call=tot_call, total_joint=tot_joint,
                total_best=tot_best, ratio=ratio,
                schedules=resolve_schedules(prec_name),
                precision=prec_name, source="cold", key=key)
            self.cache.put(key, {
                "kind": "step_plan",
                "quotes": {f: {k: v for k, v in q.items()}
                           for f, q in quotes.items()},
                "per_call": tot_call, "joint": tot_joint,
                "best": tot_best, "ratio": ratio,
                "precision": prec_name, "_obj": obj})
            return obj

    # ---- per-mesh-axis plans -----------------------------------------------
    def get_axis_plans(self, axes: Sequence[tuple[str, int]],
                       size_floats: float,
                       params: Mapping[str, GenModelParams] | None = None
                       ) -> list[AxisPlan]:
        axes = [(str(a), int(n)) for a, n in axes]
        eff = (self._apply_health(params) if params is not None
               else self._effective_axis_params())
        bucket = self.cache.bucket(max(size_floats, 1.0) * 4)
        key = axis_key(axes, eff, bucket, extra=self._config_extra())
        entry = self.cache.get(key)
        if entry is not None:
            obj = entry.get("_obj")
            if obj is None:
                # 4-element rows carry the modeled cost; 3-element rows
                # (pre-telemetry snapshots) load with predicted=None
                obj = [AxisPlan(row[0], row[1],
                                tuple(row[2]) if row[2] else None,
                                predicted=(float(row[3])
                                           if len(row) > 3
                                           and row[3] is not None
                                           else None))
                       for row in entry["axis_plans"]]
                entry["_obj"] = obj
            return list(obj)
        # Cold pricing honours the service's configured engine and
        # gentree kwargs (once silently dropped here, so an
        # engine="reference" or candidate-restricted service got default
        # axis plans).
        plans = plan_axes_gentree(axes, float(bucket) / 4.0, eff,
                                  engine=self.engine,
                                  gentree_kwargs=self.gentree_kwargs)
        entry = {"axis_plans": [[p.axis, p.strategy,
                                 list(p.factors) if p.factors else None,
                                 p.predicted]
                                for p in plans],
                 "_obj": list(plans)}
        self.cache.put(key, entry)
        return list(plans)

    # ---- housekeeping ------------------------------------------------------
    def invalidate_executables(self) -> int:
        """Drop every derived executable artifact — the lowered
        `CompiledSchedule`s on the plan entries (`_exec` maps) and the
        memoized all_to_all / p2p schedules — while keeping the priced
        plans. The next `get_executable` / `get_family_executable`
        re-lowers under the current params. Called by a refit's hot swap
        and by `mark_degraded`."""
        with self._lock:
            dropped = self.cache.drop_derived() + len(self._family_scheds)
            self._family_scheds.clear()
        m = default_metrics()
        m.counter("planner_schedule_invalidations_total",
                  "invalidate_executables calls (remesh/resume/refit)"
                  ).inc()
        m.counter("planner_executables_dropped_total",
                  "derived schedules dropped").inc(dropped)
        return dropped

    def executable_count(self) -> int:
        """Derived executable artifacts currently cached — what
        `invalidate_executables` would drop."""
        with self._lock:
            return self.cache.derived_count() + len(self._family_scheds)

    def stats(self) -> dict:
        out = {"cache": self.cache.stats.as_dict(),
               "entries": len(self.cache),
               "calibrated": self.calibration is not None,
               "refits": list(self.refits),
               "degraded": dict(self._degraded),
               "telemetry": self.telemetry.stats()}
        if self.params:
            out["params"] = {lvl: dataclasses.asdict(p)
                             for lvl, p in self.params.items()}
        return out

    def save(self, path: str | None = None) -> None:
        self.cache.save(path)


# ---------------------------------------------------------------------------
# Process-wide default service (what the hot paths use)
# ---------------------------------------------------------------------------
_default: PlannerService | None = None
_default_lock = threading.Lock()


def default_service() -> PlannerService:
    """Lazily-created singleton. $REPRO_PLAN_CACHE, when set, points at the
    JSON persistence file so warm plans survive restarts."""
    global _default
    with _default_lock:
        if _default is None:
            from repro_torch.runtime.telemetry import default_telemetry
            path = os.environ.get("REPRO_PLAN_CACHE") or None
            # autosave so the promise holds without an explicit save():
            # nothing on the serve path calls save() for us. The
            # process-wide service observes through the process-wide
            # telemetry hub.
            _default = PlannerService(cache_path=path,
                                      autosave=path is not None,
                                      telemetry=default_telemetry())
        return _default


def peek_default_service() -> PlannerService | None:
    """The process-wide service if one exists, WITHOUT creating it."""
    with _default_lock:
        return _default


def set_default_service(svc: PlannerService | None) -> None:
    """Swap the process-wide service (tests, custom calibration)."""
    global _default
    with _default_lock:
        _default = svc
