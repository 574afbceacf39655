"""PlannerService — the one cached, calibrated entry point for plan lookup.

The serving slice of the reference `planner/service.py` (DESIGN.md §5):

  * `get_plan(topo, nbytes, dtype)` — full GenTree plan for a physical
    topology, cache-bucketed by size;
  * `get_executable(topo, nbytes, dtype)` / `get_axis_executable(axis, n,
    size_floats)` — the same plan plus its lowered schedule (core.lower,
    DESIGN.md §8), cached alongside the plan entry;
  * `get_axis_plans(axes, size_floats)` — per-mesh-axis plan labels;
  * `observe(...)` — the online loop: residuals, drift, and the refit
    that hot-swaps the pricing basis (DESIGN.md §10).

Arrival-skew re-ranking, degraded-link repricing, bucket plans and
whole-step plans are not ported yet. Uncalibrated mesh-axis pricing
defaults to the paper's GPU testbed (`cost_model.GPU_TESTBED`).

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
from repro_torch.core.cost_model import (GPU_TESTBED, GenModelParams,
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

DTYPE_BYTES = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
               "bf16": 2, "float16": 2, "int8": 1,
               "float8_e4m3fn": 1, "fp8": 1}


@dataclass
class PlanResponse:
    plan: Plan
    algo: str                        # "gentree" or a baseline name
    predicted_time: float            # synchronized simulator pricing
    decisions: dict = field(default_factory=dict)   # gentree plans only
    source: str = "cold"             # cold | memory | disk
    key: str = ""
    nbytes_bucket: int = 0
    size_floats: float = 0.0
    # get_executable only: the lowered schedule (core.lower), cached
    # alongside the plan entry under "_exec" (derived artifact — never
    # persisted; recompiled once per placement after a disk-warm restart)
    schedule: object | None = None


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
    """Thread-safe facade over fingerprint + cache + calibrate."""

    def __init__(self, params: Mapping[str, GenModelParams] | None = None,
                 cache: PlanCache | None = None, *,
                 cache_path: str | None = None, capacity: int = 128,
                 autosave: bool = False,
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
        self.gentree_kwargs = dict(gentree_kwargs or {})
        # plan-evaluation engine for cold generation:
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
        self._lock = threading.RLock()

    # ---- the online loop: observe -> drift -> refit -> invalidate ----------
    def _effective_axis_params(self) -> dict[str, GenModelParams]:
        """Pricing basis for mesh-axis requests: the axis paths
        (`get_axis_executable`, `get_axis_plans`) default to GPU_TESTBED
        when the service is uncalibrated, and observation/refit must
        price against the same basis those paths quoted."""
        return dict(self.params if self.params is not None
                    else GPU_TESTBED)

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

        Returns {"level", "rel_residual", "drift", "samples", "refit"}.
        """
        if source not in ("mesh", "local_mesh"):
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
        if source == "local_mesh":
            local = self.telemetry.residuals(f"level/{level}@local_mesh")
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
                and self._sample_diversity(level) >= 2:
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
                base = self._effective_axis_params()
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
        # same key layout as the reference service, whose second slot
        # holds the arrival-skew model (not ported yet)
        extra = (tuple(sorted(self.gentree_kwargs.items())), None)
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
                source=source, key=key, nbytes_bucket=bucket,
                size_floats=size_floats)

        # ---- cold path: generate -----------------------------------------
        with default_tracer().span("planner/generate_plan",
                                   servers=topo.num_servers(),
                                   bucket=bucket):
            result = gentree_mod.gentree(topo, size_floats, params=params,
                                         engine=self.engine,
                                         **self.gentree_kwargs)
            algo, plan = "gentree", result.plan
            decisions = _decisions_to_json(result.decisions)
            sim = Simulator(topo, params, unit_bytes=dsize,
                            engine=self.engine)
            predicted = sim.simulate(plan).total

            entry = {"plan": plan_to_json(plan), "algo": algo,
                     "predicted_time": predicted, "decisions": decisions,
                     "nbytes_bucket": bucket, "_obj": plan}
            self.cache.put(key, entry)
        return PlanResponse(plan=plan, algo=algo, predicted_time=predicted,
                            decisions=decisions, source="cold", key=key, nbytes_bucket=bucket,
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
        (default: `GPU_TESTBED` until calibrated): the synthesized switch's uplink
        bandwidth realizes that level's β, exactly as
        `plan_axes_gentree` prices the same axis, so the executed plan is
        the one the model actually argues for."""
        eff = dict(params) if params else self._effective_axis_params()
        if topo is None:
            from repro_torch.core.sync import level_switch_topo
            topo = level_switch_topo(int(n), eff, level)
        dsize = DTYPE_BYTES.get(dtype, 4)
        return self.get_executable(topo, max(size_floats, 1.0) * dsize,
                                   dtype, params=eff)

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

    # ---- per-mesh-axis plans -----------------------------------------------
    def get_axis_plans(self, axes: Sequence[tuple[str, int]],
                       size_floats: float,
                       params: Mapping[str, GenModelParams] | None = None
                       ) -> list[AxisPlan]:
        axes = [(str(a), int(n)) for a, n in axes]
        eff = (dict(params) if params is not None
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
        `CompiledSchedule`s on the plan entries (`_exec` maps) — while
        keeping the priced plans. The next `get_executable` re-lowers
        under the current params. Called by a refit's hot swap."""
        with self._lock:
            dropped = self.cache.drop_derived()
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
            return self.cache.derived_count()

    def stats(self) -> dict:
        out = {"cache": self.cache.stats.as_dict(),
               "entries": len(self.cache),
               "calibrated": self.calibration is not None,
               "refits": list(self.refits),
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
