"""Calibration harness: refit GenModelParams from measured curves (§3.4).

Replaces the frozen PAPER_TABLE5 / GPU_TESTBED presets with *fitted* instances.
Per level class a `MeasurementProvider` produces the paper's two
microbench curves and the resulting (size, time) samples feed core.fitting
— every provider, offline or online, flows through the SAME least-squares
path (`fit_level`); there is no second fitting codepath:

  * the co-located-PS curve over (N, S) — identifies α, 2β+γ, δ, ε, w_t
    (Table-2 CPS design matrix, w_t by residual grid search);
  * the Fig.-4 fan-in microbench — separates δ from γ, which the CPS curve
    alone cannot (only 2β+γ is identifiable there).

Providers (``cfg.backend`` selects one; pass `provider=` for a custom
instance):

  * "simulator"   — drive core.simulator over a single-switch topology of
    the level class (the default; deterministic, runs anywhere);
  * "closed_form" — sample the Table-2 closed forms directly (exact
    round-trip, used by the calibration tests);
  * `TelemetryProvider` — the online loop (DESIGN.md §10): runtime
    telemetry samples (`runtime.telemetry`), recorded by
    `PlannerService.observe` as CPS-equivalent (n, S, time) points,
    replayed as the CPS curve. The Fig.-4 curve falls back to the closed
    form at the *current* params: arrival timings cannot separate δ from
    γ online, so the memory-term split is carried over while the
    measured combination 2β+γ (and α, ε) is refit from live data.

Recorded samples are kept on the result so they can be persisted/inspected
(the service exposes them through its stats).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core import plans as plans_mod
from repro_torch.core.cost_model import GenModelParams, PAPER_TABLE5, cost_cps
from repro_torch.core.fitting import fit_delta_gamma, fit_from_cps_benchmarks
from repro_torch.core.simulator import Simulator
from repro_torch.core.topology import single_switch


@dataclass(frozen=True)
class CalibrationConfig:
    ns: tuple[int, ...] = tuple(range(2, 17))
    sizes: tuple[float, ...] = (1e6, 4e6, 1.6e7)     # data units (floats)
    fig4_xs: tuple[int, ...] = tuple(range(2, 17))   # fan-in degrees
    fig4_size: float = 1e6
    backend: str = "simulator"    # simulator | closed_form
    unit_bytes: int = 4
    levels: tuple[str, ...] = ("cross_dc", "root_sw", "middle_sw", "server")
    # plan-evaluation engine for the simulator backend's sweeps: "fast"
    # (compiled, default) or "reference" (pure-Python oracle); None defers
    # to $REPRO_SIM_ENGINE / the Simulator default.
    engine: str | None = None


@dataclass
class LevelSamples:
    """Raw measurement record for one level class."""
    level: str
    ns: np.ndarray
    sizes: np.ndarray
    times: np.ndarray
    fig4_xs: np.ndarray
    fig4_size: float
    fig4_times: np.ndarray

    def as_dict(self) -> dict:
        return {"level": self.level, "ns": self.ns.tolist(),
                "sizes": self.sizes.tolist(), "times": self.times.tolist(),
                "fig4_xs": self.fig4_xs.tolist(),
                "fig4_size": self.fig4_size,
                "fig4_times": self.fig4_times.tolist()}


@dataclass
class CalibrationResult:
    params: dict[str, GenModelParams]
    samples: dict[str, LevelSamples] = field(default_factory=dict)
    backend: str = "simulator"

    def as_dict(self) -> dict:
        return {"backend": self.backend,
                "params": {lvl: dataclasses.asdict(p)
                           for lvl, p in self.params.items()},
                "samples": {lvl: s.as_dict()
                            for lvl, s in self.samples.items()}}


# ---------------------------------------------------------------------------
# Measurement providers — ONE interface for offline microbenches and the
# online telemetry loop; everything downstream is the same fitting path.
# ---------------------------------------------------------------------------
def _level_topo(level: str, n: int, p: GenModelParams, unit_bytes: int):
    """Single-switch stand-in for a level class: link bandwidth chosen so
    the simulator's bytes/bw pricing equals the level's per-unit β."""
    bw = unit_bytes / p.beta if p.beta > 0 else 1e18
    return single_switch(n, bw=bw, lat=0.0, level=level)


def _closed_form_fig4(source: GenModelParams, cfg: "CalibrationConfig"
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The Fig.-4 fan-in curve sampled from the closed form
    T(x) = (x+1)·S·δ + (x−1)·S·γ — the one synthesis shared by the
    closed-form backend and the online provider's δ/γ carry-over."""
    xs = np.array(cfg.fig4_xs, dtype=float)
    s = cfg.fig4_size
    times = (xs + 1) * s * source.delta + (xs - 1) * s * source.gamma
    return xs, times


# ---------------------------------------------------------------------------
# Refit guardrails (DESIGN.md §12)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ParamGuard:
    """Plausibility envelope for fitted GenModelParams. The caps are
    deliberately loose — ~1000× the largest Table-5 value — because the
    guard exists to stop *garbage* (NaN from a degenerate design matrix,
    negative per-unit costs, a β implying sub-kB/s links), not to
    second-guess a legitimate fit. `max_step_ratio` bounds per-refit
    movement of any single term: one fault-distorted sample window can
    move the fleet's model by at most that factor per refit."""
    max_alpha: float = 10.0       # seconds of launch overhead per round
    max_beta: float = 1e-3        # s per 4-byte unit (≈4 kB/s links)
    max_gamma: float = 1e-3
    max_delta: float = 1e-3
    max_epsilon: float = 1e-3
    min_w_t: int = 1
    max_w_t: int = 1 << 20
    max_step_ratio: float = 8.0


DEFAULT_GUARD = ParamGuard()

_TERM_CAPS = (("alpha", "max_alpha"), ("beta", "max_beta"),
              ("gamma", "max_gamma"), ("delta", "max_delta"),
              ("epsilon", "max_epsilon"))


def validate_params(p: GenModelParams,
                    guard: ParamGuard | None = None) -> list[str]:
    """Violation strings for an implausible fit (empty list = sane).
    Checks every cost term for NaN/inf, negativity and the guard's
    plausibility cap, and w_t for range."""
    guard = guard or DEFAULT_GUARD
    bad = []
    for term, cap in _TERM_CAPS:
        v = float(getattr(p, term))
        if not np.isfinite(v):
            bad.append(f"{term} is not finite ({v})")
        elif v < 0.0:
            bad.append(f"{term} is negative ({v:.3g})")
        elif v > getattr(guard, cap):
            bad.append(f"{term} {v:.3g} exceeds plausibility cap "
                       f"{getattr(guard, cap):.3g}")
    w = int(p.w_t)
    if not guard.min_w_t <= w <= guard.max_w_t:
        bad.append(f"w_t {w} outside [{guard.min_w_t}, {guard.max_w_t}]")
    return bad


def clamp_params(old: GenModelParams, new: GenModelParams,
                 guard: ParamGuard | None = None
                 ) -> tuple[GenModelParams, list[str]]:
    """Clamp each fitted term into [old/r, old·r] of its previous value
    (r = guard.max_step_ratio) so one refit cannot swing the model by
    more than a bounded factor. Terms whose previous value is 0 are
    capped at the guard's plausibility limit instead (no ratio basis).
    Returns (clamped params, names of clamped terms)."""
    guard = guard or DEFAULT_GUARD
    r = float(guard.max_step_ratio)
    updates, clamped = {}, []
    for term, cap in _TERM_CAPS:
        ov, nv = float(getattr(old, term)), float(getattr(new, term))
        if ov > 0.0:
            lo, hi = ov / r, ov * r
        else:
            lo, hi = 0.0, float(getattr(guard, cap))
        cv = min(max(nv, lo), hi)
        if cv != nv:
            clamped.append(term)
            updates[term] = cv
    w = int(new.w_t)
    cw = min(max(w, guard.min_w_t), guard.max_w_t)
    if cw != w:
        clamped.append("w_t")
        updates["w_t"] = cw
    return (replace(new, **updates) if updates else new), clamped


def quarantine_outliers(samples, k: float = 4.0) -> tuple[list, list]:
    """Split telemetry samples into (kept, quarantined). A sample is
    quarantined when its cps_equivalent time sits more than `k`× (or
    below 1/k×) the *median* of its own (n, size) group — a fault-window
    measurement (straggler, degraded link mid-flight, retry storm) that
    would otherwise drag the least squares. Groups smaller than 3 have
    no robust center and are kept whole."""
    groups: dict[tuple, list] = {}
    for s in samples:
        groups.setdefault((int(s.n), round(float(s.size_floats), 6)),
                          []).append(s)
    kept, quarantined = [], []
    for grp in groups.values():
        if len(grp) < 3:
            kept.extend(grp)
            continue
        med = float(np.median([float(s.cps_equivalent) for s in grp]))
        if med <= 0.0:
            kept.extend(grp)
            continue
        for s in grp:
            ratio = float(s.cps_equivalent) / med
            (quarantined if (ratio > k or ratio < 1.0 / k)
             else kept).append(s)
    return kept, quarantined


class MeasurementProvider:
    """A source of the two microbench curves `fit_level` consumes.

    `cps_curve` returns (ns, sizes, times) of co-located-PS AllReduce
    runs; `fig4_curve` returns (xs, times) of the fan-in fold
    microbench. Subclasses measure (simulator / closed form / runtime
    telemetry); the fit never knows which.
    """

    name = "base"

    def cps_curve(self, level: str, source: GenModelParams,
                  cfg: "CalibrationConfig") -> tuple[np.ndarray, ...]:
        raise NotImplementedError

    def fig4_curve(self, level: str, source: GenModelParams,
                   cfg: "CalibrationConfig"
                   ) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def pin_w_t(self, level: str, source: GenModelParams) -> int | None:
        """Incast threshold to pin during the CPS fit, or None to
        grid-search it from the curve (the offline default: dense
        (N, S) sweeps identify w_t robustly)."""
        return None


class SimulatorProvider(MeasurementProvider):
    """Drive core.simulator over a single-switch stand-in topology (the
    default backend; deterministic, runs anywhere)."""

    name = "simulator"

    def cps_curve(self, level, source, cfg):
        ns, sizes, times = [], [], []
        for n in cfg.ns:
            topo = _level_topo(level, n, source, cfg.unit_bytes)
            sim = Simulator(topo, {level: source, "server": source},
                            unit_bytes=cfg.unit_bytes, engine=cfg.engine)
            for s in cfg.sizes:
                ns.append(float(n))
                sizes.append(float(s))
                times.append(sim.simulate(plans_mod.cps(n, s)).total)
        return np.array(ns), np.array(sizes), np.array(times)

    def fig4_curve(self, level, source, cfg):
        """Fan-in microbench: fold x blocks of S units on one server.
        T(x) = (x+1)·S·δ + (x−1)·S·γ — purely local, no communication, so
        the simulator backend subtracts the per-round launch α it
        charges."""
        xs = np.array(cfg.fig4_xs, dtype=float)
        s = cfg.fig4_size
        times = []
        for x in cfg.fig4_xs:
            topo = _level_topo(level, 2, source, cfg.unit_bytes)
            sim = Simulator(topo, {level: source, "server": source},
                            unit_bytes=cfg.unit_bytes, engine=cfg.engine)
            p = plans_mod.Plan("fig4", 2, s)
            st = plans_mod.Step()
            st.reduces.append(plans_mod.ReduceOp(0, int(x), s))
            p.steps.append(st)
            times.append(sim.simulate(p).total - source.alpha)
        return xs, np.array(times)


class ClosedFormProvider(MeasurementProvider):
    """Sample the Table-2 closed forms directly (exact round-trip; the
    calibration tests pin parameter recovery against this)."""

    name = "closed_form"

    def cps_curve(self, level, source, cfg):
        ns, sizes, times = [], [], []
        for n in cfg.ns:
            for s in cfg.sizes:
                ns.append(float(n))
                sizes.append(float(s))
                times.append(cost_cps(n, s, source))
        return np.array(ns), np.array(sizes), np.array(times)

    def fig4_curve(self, level, source, cfg):
        return _closed_form_fig4(source, cfg)


class TelemetryProvider(MeasurementProvider):
    """Replay runtime telemetry as the CPS curve — the online half of the
    measure→fit loop (DESIGN.md §10).

    `PlannerService.observe` normalizes every measured collective into a
    CPS-equivalent sample (`core.fitting.cps_equivalent_time`) and files
    it under the axis's level class in `runtime.telemetry.Telemetry`.
    This provider hands those samples to the exact same Table-2 least
    squares the offline microbenches use. The Fig.-4 memory curve is not
    measurable online (arrival timings cannot separate δ from γ), so it
    is synthesized from the *current* params: the δ/γ split carries
    over, while α, ε, w_t and the measured combination 2β+γ refit from
    live data — the terms that actually drift with contention, failed
    links and thermal throttling.
    """

    name = "telemetry"

    def __init__(self, telemetry, min_samples: int = 4,
                 quarantine_k: float | None = 4.0):
        self.telemetry = telemetry
        self.min_samples = int(min_samples)
        self.quarantine_k = quarantine_k
        self.quarantined = 0          # samples dropped by the last curve

    def cps_curve(self, level, source, cfg):
        samples = self.telemetry.samples(level)
        if self.quarantine_k:
            # robust-filter fault-window outliers BEFORE the diversity /
            # min-sample checks: a poisoned window must not both distort
            # the fit and count toward its sample quorum (DESIGN.md §12)
            kept, dropped = quarantine_outliers(samples,
                                                k=self.quarantine_k)
            self.quarantined = len(dropped)
            if dropped:
                from repro_torch.runtime.metrics import default_metrics
                default_metrics().counter(
                    "planner_quarantined_samples_total",
                    "telemetry samples excluded from refits as outliers"
                ).inc(len(dropped))
                samples = kept
        if len(samples) < self.min_samples:
            raise ValueError(
                f"telemetry has {len(samples)} samples for level "
                f"{level!r}; need >= {self.min_samples}")
        # many copies of ONE (n, S) point make the Table-2 design matrix
        # rank-1: the lstsq minimum-norm solution would be degenerate
        # (α collapses into the size-proportional columns) and the
        # swapped-in params would misprice every OTHER point. Refuse —
        # the refit trigger (`PlannerService.observe`) checks the same
        # diversity before claiming a refit.
        points = {(s.n, round(float(s.size_floats), 6)) for s in samples}
        if len(points) < 2:
            raise ValueError(
                f"telemetry samples for level {level!r} cover a single "
                f"(n, size) point; need >= 2 distinct points to fit")
        ns = np.array([float(s.n) for s in samples])
        sizes = np.array([float(s.size_floats) for s in samples])
        times = np.array([float(s.cps_equivalent) for s in samples])
        return ns, sizes, times

    def fig4_curve(self, level, source, cfg):
        return _closed_form_fig4(source, cfg)

    def pin_w_t(self, level, source):
        """Online samples are sparse (a handful of (n, S) points from
        whatever axes the mesh happens to have), so the w_t grid search
        would let the incast column absorb β drift. The threshold is a
        switch-buffer property, not a contention effect — carry the
        current value over and let α/β/ε refit from live data."""
        return int(source.w_t)


_PROVIDERS = {p.name: p for p in (SimulatorProvider, ClosedFormProvider)}


def provider_for(cfg: CalibrationConfig) -> MeasurementProvider:
    cls = _PROVIDERS.get(cfg.backend)
    if cls is None:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return cls()


def measure_cps_curve(level: str, source: GenModelParams,
                      cfg: CalibrationConfig) -> tuple[np.ndarray, ...]:
    return provider_for(cfg).cps_curve(level, source, cfg)


def measure_fig4_curve(level: str, source: GenModelParams,
                       cfg: CalibrationConfig) -> tuple[np.ndarray, np.ndarray]:
    return provider_for(cfg).fig4_curve(level, source, cfg)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------
def fit_level(samples: LevelSamples,
              w_t: int | None = None) -> GenModelParams:
    """Combine the two microbench fits into one GenModelParams:
    α/ε/w_t and the combined 2β+γ from the CPS curve, δ/γ from Fig. 4,
    then β = (2β+γ)/2 − γ/2 once γ is known. `w_t` pins the incast
    threshold instead of grid-searching it (see
    `MeasurementProvider.pin_w_t`)."""
    cps_fit = fit_from_cps_benchmarks(samples.ns, samples.sizes,
                                      samples.times, w_t=w_t)
    delta, gamma = fit_delta_gamma(samples.fig4_xs, samples.fig4_times,
                                   samples.fig4_size)
    delta, gamma = max(delta, 0.0), max(gamma, 0.0)
    bg = cps_fit.beta + cps_fit.gamma / 2.0      # = β + γ/2 (identifiable)
    beta = max(bg - gamma / 2.0, 0.0)
    return replace(cps_fit, beta=beta, gamma=gamma, delta=delta)


def calibrate_levels(source: dict[str, GenModelParams] | None = None,
                     cfg: CalibrationConfig | None = None, *,
                     provider: MeasurementProvider | None = None
                     ) -> CalibrationResult:
    """Measure + refit every level class. `source` is the measurement
    target: the params dict the synthetic backends treat as ground truth
    (online, `TelemetryProvider` replaces it with measured timings).

    `provider` overrides the backend lookup with a custom
    `MeasurementProvider` instance — notably `TelemetryProvider`, which
    replays online runtime samples through this very path so offline and
    online calibration share one fitting codepath."""
    source = source or PAPER_TABLE5
    cfg = cfg or CalibrationConfig()
    provider = provider or provider_for(cfg)
    params: dict[str, GenModelParams] = {}
    samples: dict[str, LevelSamples] = {}
    for level in cfg.levels:
        src = source.get(level, source.get("server", GenModelParams()))
        ns, sizes, times = provider.cps_curve(level, src, cfg)
        xs, f4times = provider.fig4_curve(level, src, cfg)
        ls = LevelSamples(level=level, ns=ns, sizes=sizes, times=times,
                          fig4_xs=xs, fig4_size=cfg.fig4_size,
                          fig4_times=f4times)
        samples[level] = ls
        params[level] = fit_level(ls, w_t=provider.pin_w_t(level, src))
    return CalibrationResult(params=params, samples=samples,
                             backend=provider.name)
