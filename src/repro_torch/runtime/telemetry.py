"""Runtime telemetry — the shared measurement datapath (DESIGN.md §10).

Every real timing the system produces at runtime used to be thrown away
or trapped in an ad-hoc EWMA (`StragglerWatchdog`). This module is the
one place they all land, so straggler detection, drift detection and
online recalibration consume a single datapath:

  * `TimingRing`   — fixed-capacity ring buffer of samples with streaming
    statistics: count/mean/EWMA are O(1) per `add`, percentiles are
    computed over the retained window on demand. The EWMA uses the same
    half-life decay the old watchdog did, so `StragglerWatchdog` routes
    through a ring without changing its `observe(step, dt) -> bool`
    contract.
  * `ResidualTracker` — predicted-vs-measured relative residuals, keyed
    by plan fingerprint or level class. `drift()` (median |residual|) is
    what `PlannerService`'s refit policy watches; `bias()` keeps the
    sign so a systematically slow cluster is distinguishable from noise.
  * `ArrivalEstimator` — per-device arrival-offset rings. Feed it the
    per-device arrival times of each collective (or step barrier) and it
    maintains median offsets relative to the earliest arrival — the
    measured process-arrival pattern `SkewModel(dist="empirical")`
    prices instead of synthetic draws.
  * `Telemetry`    — the facade: create-on-demand rings and trackers,
    per-level calibration samples for the online refit
    (`planner.calibrate.TelemetryProvider`), and re-measure windows:
    after a straggler / remesh / fault-tolerant resume the pre-event
    residuals and arrival offsets describe hardware that no longer
    exists, so `remeasure()` drops them (raw timing rings survive for
    trend display) and logs the event.

Thread-safe: the training loop, the serving self-check and the planner
service may observe concurrently. The hot path (`Telemetry.record`,
`TimingRing.add`) is a dict probe plus O(1) arithmetic — gated under 1%
of a simulated step by `benchmarks/telemetry_bench.py`.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from dataclasses import dataclass, field


class TimingRing:
    """Fixed-capacity ring of float samples with streaming statistics.

    `add` is O(1): it updates count, running sum (of the retained
    window), and — unless the caller excludes the sample from the
    baseline — the half-life EWMA. Percentiles sort the retained window
    on demand (O(W log W), W = capacity), which is cheap at the default
    capacity and keeps the hot path allocation-free. A per-ring lock
    guards the compound buffer/sum/EWMA update — concurrent observers
    (training loop, serve self-check, watchdog) share these rings.
    """

    __slots__ = ("capacity", "halflife", "_buf", "_next", "_count",
                 "_sum", "_ewma", "_total", "_lock")

    def __init__(self, capacity: int = 256, halflife: int = 20):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.halflife = int(halflife)
        self._buf: list[float] = [0.0] * self.capacity
        self._next = 0          # next write position
        self._count = 0         # retained samples (<= capacity)
        self._sum = 0.0         # sum of retained samples
        self._ewma: float | None = None
        self._total = 0         # lifetime samples (survives wraparound)
        self._lock = threading.Lock()

    def add(self, value: float, *, baseline: bool = True) -> None:
        """Record a sample. `baseline=False` keeps it out of the EWMA
        (a straggler step must not poison the straggler baseline) while
        still retaining it in the window for percentiles/means."""
        value = float(value)
        with self._lock:
            if self._count == self.capacity:
                self._sum -= self._buf[self._next]
            else:
                self._count += 1
            self._buf[self._next] = value
            self._next = (self._next + 1) % self.capacity
            self._sum += value
            self._total += 1
            if baseline:
                if self._ewma is None:
                    self._ewma = value
                else:
                    k = 2.0 ** (-1.0 / self.halflife)
                    self._ewma = k * self._ewma + (1.0 - k) * value

    @property
    def count(self) -> int:
        """Samples currently retained in the window."""
        return self._count

    @property
    def total(self) -> int:
        """Lifetime samples, including ones the ring has since dropped."""
        return self._total

    @property
    def ewma(self) -> float | None:
        return self._ewma

    @property
    def last(self) -> float | None:
        if not self._count:
            return None
        return self._buf[(self._next - 1) % self.capacity]

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def window(self) -> list[float]:
        """Retained samples, oldest first."""
        if self._count < self.capacity:
            return self._buf[: self._count]
        return self._buf[self._next:] + self._buf[: self._next]

    def percentile(self, q: float) -> float | None:
        """q in [0, 100]; linear interpolation over the retained window.
        Empty-window contract: ``None`` (no sample can stand in for a
        percentile — 0.0 would read as "instant")."""
        with self._lock:
            if not self._count:
                return None
            xs = sorted(self._buf[: self._count]
                        if self._count < self.capacity else self._buf)
        pos = (len(xs) - 1) * min(max(q, 0.0), 100.0) / 100.0
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def summary(self) -> dict:
        """Safe on an empty ring: percentile/ewma/last fields are None,
        count/total/mean are zero."""
        return {"count": self._count, "total": self._total,
                "mean": self.mean(), "ewma": self._ewma,
                "p50": self.percentile(50.0), "p95": self.percentile(95.0),
                "last": self.last}

    def reset(self) -> None:
        with self._lock:
            self._next = self._count = 0
            self._sum = 0.0
            self._ewma = None


class ResidualTracker:
    """Predicted-vs-measured tracking for one key (plan fingerprint or
    level class). Residuals are *relative*: (measured − predicted) /
    predicted, so drift thresholds mean the same thing across sizes.

    The window is kept sorted incrementally (bisect insert/remove per
    `record`, under a per-tracker lock — the three parallel structures
    must never desync under concurrent observers), so the streaming
    medians `drift()` and `bias()` are O(1) — they sit on the observe
    hot path, which is gated under 1% of a simulated step by
    `benchmarks/telemetry_bench.py`."""

    __slots__ = ("capacity", "_window", "_sorted_abs", "_sorted_signed",
                 "_total", "_lock")

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._window: deque[float] = deque()     # signed rels, in order
        self._sorted_abs: list[float] = []
        self._sorted_signed: list[float] = []
        self._total = 0
        self._lock = threading.Lock()

    def record(self, predicted: float, measured: float) -> float:
        denom = abs(float(predicted))
        rel = ((float(measured) - float(predicted)) / denom
               if denom > 0.0 else 0.0)
        with self._lock:
            if len(self._window) == self.capacity:
                old = self._window.popleft()
                del self._sorted_abs[bisect.bisect_left(self._sorted_abs,
                                                        abs(old))]
                del self._sorted_signed[
                    bisect.bisect_left(self._sorted_signed, old)]
            self._window.append(rel)
            bisect.insort(self._sorted_abs, abs(rel))
            bisect.insort(self._sorted_signed, rel)
            self._total += 1
        return rel

    @property
    def count(self) -> int:
        return len(self._window)

    @property
    def total(self) -> int:
        return self._total

    @staticmethod
    def _median(xs: list[float]) -> float:
        if not xs:
            return 0.0
        mid = len(xs) // 2
        return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    def drift(self) -> float | None:
        """Median |relative residual| over the window — the refit
        policy's trigger statistic (robust to straggler outliers).
        Empty-window contract: ``None`` (an empty tracker has measured
        nothing; 0.0 would read as "zero drift, model perfect")."""
        with self._lock:
            if not self._window:
                return None
            return self._median(self._sorted_abs)

    def bias(self) -> float | None:
        """Median signed relative residual (positive: model optimistic,
        the cluster is slower than predicted). ``None`` when empty."""
        with self._lock:
            if not self._window:
                return None
            return self._median(self._sorted_signed)

    def reset(self) -> None:
        with self._lock:
            self._window.clear()
            self._sorted_abs.clear()
            self._sorted_signed.clear()


class ArrivalEstimator:
    """Per-device arrival-offset estimation.

    `record(arrivals)` takes one collective's per-device arrival times
    (any common clock; only differences matter) and files each device's
    offset relative to the earliest arrival into that device's ring.
    `offsets()` returns the per-device median offsets — the measured
    process-arrival pattern that `SkewModel(dist="empirical")` prices.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._rings: dict[int, TimingRing] = {}

    def record(self, arrivals) -> None:
        ts = [float(t) for t in arrivals]
        if not ts:
            return
        t0 = min(ts)
        for dev, t in enumerate(ts):
            ring = self._rings.get(dev)
            if ring is None:
                ring = self._rings[dev] = TimingRing(capacity=self.capacity)
            ring.add(t - t0)

    @property
    def n_devices(self) -> int:
        return len(self._rings)

    @property
    def count(self) -> int:
        """Collectives observed (min over devices; 0 when empty)."""
        if not self._rings:
            return 0
        return min(r.total for r in self._rings.values())

    def offsets(self) -> list[float]:
        """Median arrival offset per device, index-ordered."""
        return [self._rings[d].percentile(50.0)
                for d in sorted(self._rings)]

    def reset(self) -> None:
        self._rings.clear()


@dataclass
class LevelSample:
    """One online calibration sample for a level class: an executed
    collective's (n, size) point with its measured wall time and the
    CPS-equivalence factor computed at observe time (see
    `core.fitting.cps_equivalent_time`)."""
    n: int
    size_floats: float
    measured: float
    cps_equivalent: float


@dataclass
class LedgerEntry:
    """One priced collective in the cost ledger (DESIGN.md §11): the
    quoted prediction decomposed into per-term predicted seconds
    (``shares`` sums to ``predicted`` — enforced where it is built, see
    `cost_model.CostBreakdown.scaled_to`) next to the measured wall
    time. A window of these is what `core.fitting.attribute_term_drift`
    solves to name the drifting term."""
    level: str
    n: int
    size_floats: float
    predicted: float
    measured: float
    shares: dict[str, float]


class CostLedger:
    """Bounded per-level store of `LedgerEntry` rows. Pure storage —
    the attribution least-squares lives in `core.fitting` so this module
    stays stdlib-only. Cleared by `Telemetry.remeasure()` along with the
    other suspect state (old hardware, old prices)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: dict[str, deque[LedgerEntry]] = {}
        self._lock = threading.Lock()

    def record(self, entry: LedgerEntry) -> None:
        with self._lock:
            dq = self._entries.get(entry.level)
            if dq is None:
                dq = self._entries[entry.level] = deque(
                    maxlen=self.capacity)
            dq.append(entry)

    def entries(self, level: str) -> list[LedgerEntry]:
        with self._lock:
            return list(self._entries.get(level, ()))

    def count(self, level: str) -> int:
        with self._lock:
            return len(self._entries.get(level, ()))

    def levels(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def totals(self, level: str) -> dict[str, float]:
        """Summed predicted seconds per term over the retained window —
        the 'where does the model think the time goes' view."""
        out: dict[str, float] = {}
        for e in self.entries(level):
            for term, sec in e.shares.items():
                out[term] = out.get(term, 0.0) + sec
        return out

    def clear(self, level: str | None = None) -> None:
        with self._lock:
            if level is None:
                self._entries.clear()
            else:
                self._entries.pop(level, None)


@dataclass
class TelemetryEvent:
    kind: str
    info: dict = field(default_factory=dict)


class Telemetry:
    """Process-level measurement hub shared by the training loop, the
    serving self-check, the straggler watchdog and the planner service.

    Keys are free-form strings; the conventions used by the wiring:

      * ``train/step``            — per-step wall time (watchdog ring)
      * ``sync/<axis>``           — measured sync/probe time per DP axis
      * ``plan/<fingerprint>``    — residuals per plan cache key
      * ``level/<level-class>``   — residuals per Table-5 level class
        (what the refit policy watches)
    """

    def __init__(self, ring_capacity: int = 256, ewma_halflife: int = 20,
                 arrival_capacity: int = 64):
        self.ring_capacity = int(ring_capacity)
        self.ewma_halflife = int(ewma_halflife)
        self.arrivals = ArrivalEstimator(capacity=arrival_capacity)
        # bounded like the rings: a flaky cluster opens a re-measure
        # window per straggler, and a weeks-long deployment must not
        # grow (or serialize, via stats()) an unbounded event log
        self.events: deque[TelemetryEvent] = deque(maxlen=ring_capacity)
        self.ledger = CostLedger(capacity=ring_capacity)
        self._rings: dict[str, TimingRing] = {}
        self._residuals: dict[str, ResidualTracker] = {}
        self._samples: dict[str, list[LevelSample]] = {}
        self._lock = threading.RLock()

    # ---- timing rings ------------------------------------------------------
    def ring(self, key: str, *, halflife: int | None = None) -> TimingRing:
        """Create-on-demand ring. `halflife` overrides the hub default
        at creation time only (an existing ring keeps its decay — the
        first owner of a key defines its EWMA semantics)."""
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = TimingRing(
                    capacity=self.ring_capacity,
                    halflife=self.ewma_halflife if halflife is None
                    else halflife)
            return ring

    def record(self, key: str, value: float, *,
               baseline: bool = True) -> TimingRing:
        ring = self.ring(key)
        ring.add(value, baseline=baseline)
        return ring

    # ---- residuals ---------------------------------------------------------
    def residuals(self, key: str) -> ResidualTracker:
        with self._lock:
            rt = self._residuals.get(key)
            if rt is None:
                rt = self._residuals[key] = ResidualTracker(
                    capacity=self.ring_capacity)
            return rt

    def record_residual(self, key: str, predicted: float,
                        measured: float) -> float:
        return self.residuals(key).record(predicted, measured)

    # ---- online calibration samples ---------------------------------------
    def record_sample(self, level: str, sample: LevelSample) -> None:
        with self._lock:
            self._samples.setdefault(level, []).append(sample)
            # bound memory like the rings do: keep the freshest window
            if len(self._samples[level]) > self.ring_capacity:
                del self._samples[level][: -self.ring_capacity]

    def samples(self, level: str) -> list[LevelSample]:
        with self._lock:
            return list(self._samples.get(level, ()))

    def sample_count(self, level: str) -> int:
        """O(1) — `samples()` copies, and the observe hot path only
        needs the count."""
        with self._lock:
            return len(self._samples.get(level, ()))

    def clear_samples(self, level: str | None = None) -> None:
        with self._lock:
            if level is None:
                self._samples.clear()
            else:
                self._samples.pop(level, None)

    # ---- arrival offsets ---------------------------------------------------
    def record_arrivals(self, arrivals) -> None:
        with self._lock:
            self.arrivals.record(arrivals)

    # ---- re-measure windows ------------------------------------------------
    def remeasure(self, reason: str, info: dict | None = None) -> None:
        """Open a re-measure window after an event that changes what the
        cluster *is* (straggler exclusion, elastic remesh, fault-tolerant
        resume onto a new allocation): drop residual histories, online
        calibration samples and arrival offsets — they describe the old
        hardware — while keeping the raw timing rings for trend display.
        Drift detection restarts from fresh post-event samples."""
        with self._lock:
            self.events.append(TelemetryEvent(reason, dict(info or {})))
            for rt in self._residuals.values():
                rt.reset()
            self._samples.clear()
            self.arrivals.reset()
            self.ledger.clear()

    # ---- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "rings": {k: r.summary() for k, r in self._rings.items()},
                "residuals": {k: {"count": rt.count, "drift": rt.drift(),
                                  "bias": rt.bias()}
                              for k, rt in self._residuals.items()},
                "samples": {lvl: len(s) for lvl, s in self._samples.items()},
                "ledger": {lvl: self.ledger.count(lvl)
                           for lvl in self.ledger.levels()},
                "arrival_devices": self.arrivals.n_devices,
                "events": [(e.kind, e.info) for e in self.events],
            }


# ---------------------------------------------------------------------------
# Process-wide default hub (what the launchers and the default planner
# service share when none is passed explicitly)
# ---------------------------------------------------------------------------
_default: Telemetry | None = None
_default_lock = threading.Lock()


def default_telemetry() -> Telemetry:
    global _default
    with _default_lock:
        if _default is None:
            _default = Telemetry()
        return _default


def peek_default_telemetry() -> Telemetry | None:
    """The process-wide hub if one exists, WITHOUT creating it — event
    paths (remesh/resume) must not instantiate a hub just to clear it."""
    with _default_lock:
        return _default


def set_default_telemetry(tele: Telemetry | None) -> None:
    global _default
    with _default_lock:
        _default = tele
