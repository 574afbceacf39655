"""Metrics registry: counters, gauges, histograms + two exporters.

Zero-dependency companion to `trace.py` (DESIGN.md §11).  Where spans
answer "where did the time go inside *one* operation", metrics answer
"how often / how much across the run": plan-cache hits and misses, refit
events, plan swaps, schedule invalidations, bucket pipeline occupancy.

Exporters:

* ``registry.export(path)`` — JSON snapshot (machine-readable, ridden
  into ``benchmarks/run.py --json`` artifacts), plus, when ``path`` ends
  in ``.prom`` or a second path is given, the Prometheus text exposition
  format (``# TYPE name counter`` lines) so a scrape-style pipeline can
  ingest it without code.

Naming convention: ``component_noun_unit`` with underscores, e.g.
``plan_cache_hits_total``, ``bucket_pipeline_occupancy``.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left


class Counter:
    """Monotonically increasing count (hits, misses, refits, swaps)."""
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (occupancy, cache size, params version)."""
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


# Default buckets span microseconds to tens of seconds — wide enough for
# both per-fold spans and whole train steps.
_DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf bucket == count)."""
    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        # bisect_left: a value equal to a bound lands in that bound's
        # bucket (Prometheus ``le`` is <=, not <)
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count)...] ending with (inf, count)."""
        out, running = [], 0
        with self._lock:
            for bound, c in zip(self.bounds, self._counts):
                running += c
                out.append((bound, running))
            out.append((float("inf"), running + self._counts[-1]))
        return out


class MetricsRegistry:
    """Named metric store; get-or-create accessors keep call sites terse."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-friendly dump of every metric."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Counter):
                out[m.name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[m.name] = {"type": "gauge", "value": m.value}
            else:
                out[m.name] = {
                    "type": "histogram",
                    "count": m.count,
                    "sum": m.sum,
                    "buckets": [[b if b != float("inf") else "+Inf", c]
                                for b, c in m.cumulative()],
                }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {m.name} counter")
                lines.append(f"{m.name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {m.name} gauge")
                lines.append(f"{m.name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {m.name} histogram")
                for bound, c in m.cumulative():
                    le = "+Inf" if bound == float("inf") else _fmt(bound)
                    lines.append(f'{m.name}_bucket{{le="{le}"}} {c}')
                lines.append(f"{m.name}_sum {_fmt(m.sum)}")
                lines.append(f"{m.name}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export(self, path: str, prom_path: str | None = None) -> dict:
        """Write the JSON snapshot to ``path`` (and the Prometheus text to
        ``prom_path`` when given, else to ``path`` with a ``.prom``
        suffix).  Returns the snapshot."""
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        if prom_path is None:
            base = path[:-5] if path.endswith(".json") else path
            prom_path = base + ".prom"
        with open(prom_path, "w") as f:
            f.write(self.to_prometheus())
        return snap


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


# ---------------------------------------------------------------------------
# Process-wide default (same pattern as trace.default_tracer)
# ---------------------------------------------------------------------------
_default: MetricsRegistry | None = None
_default_lock = threading.Lock()


def default_metrics() -> MetricsRegistry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry()
    return _default


def peek_default_metrics() -> MetricsRegistry | None:
    return _default


def set_default_metrics(registry: MetricsRegistry | None
                        ) -> MetricsRegistry | None:
    global _default
    with _default_lock:
        old, _default = _default, registry
    return old
