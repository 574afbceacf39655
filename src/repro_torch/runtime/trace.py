"""Span-level execution tracing for the planner/runtime stack (DESIGN.md §11).

Zero-dependency (stdlib only) so it imports without jax — the hot paths in
`core/lower.py` and `core/bucketing.py` stay importable on machines with no
accelerator stack.  The tracer records *nested spans* with monotonic clocks
into a bounded ring buffer and exports them in the Chrome trace event
format (``chrome://tracing`` / Perfetto "JSON array" flavor).

Design points, mirrored from the paper's measurement discipline:

* **Disabled by default.**  The default tracer starts disabled; every
  instrumentation site pays one attribute load + one boolean check — the
  same budget as the telemetry hub — so the <2 %% smoke-train-step
  overhead gate (``benchmarks/telemetry_bench.py``) holds with the
  instrumentation compiled in.
* **Monotonic clocks.**  ``time.perf_counter_ns`` only; wall time never
  enters a duration.
* **Thread safety.**  The open-span *stack* is thread-local (spans nest
  per thread); the finished-span ring is shared behind a lock and spans
  carry the originating thread id so exported traces keep one Chrome
  ``tid`` lane per thread.
* **Ring-buffered.**  At most ``capacity`` finished spans are retained
  (oldest dropped), so a long training run cannot grow memory unboundedly.
* **Sampling.**  ``sample_every=k`` keeps every k-th *root* span (children
  of a dropped root are dropped with it) — deterministic, not random, so
  traces are reproducible run to run.

Caveat (documented, not hidden): on a CUDA device a span around a kernel
launch closes when the launch is *enqueued*, not when the device finishes
it.  Spans are still exactly what a planner wants for attributing
*structure* (which round, which fold, how many launches) and, on the CPU,
where the plain versions run synchronously, their durations are real.
Device-side wall time stays the telemetry hub's job.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    """One finished span. ``t0``/``t1`` are perf_counter_ns ticks."""
    name: str
    t0: int
    t1: int
    depth: int
    tid: int
    args: dict | None = None

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


class _OpenSpan:
    """Context manager handed out by ``Tracer.span`` while recording."""
    __slots__ = ("_tracer", "name", "t0", "args", "_stack")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._stack = tracer._local_stack()
        self.t0 = 0

    def __enter__(self) -> "_OpenSpan":
        self._stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        stack = self._stack
        # pop self (exceptions can skip inner __exit__ only via interpreter
        # errors; defensively unwind to self)
        while stack and stack.pop() is not self:
            pass
        self._tracer._finish(self, t1, depth=len(stack))
        return None


class _NullSpan:
    """Shared no-op context manager for the disabled / sampled-out path."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Nested-span tracer with a bounded buffer and a Chrome exporter."""

    def __init__(self, capacity: int = 65536, enabled: bool = False,
                 sample_every: int = 1):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if sample_every <= 0:
            raise ValueError("sample_every must be positive")
        self.enabled = enabled
        self.sample_every = sample_every
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._root_seen = 0          # root spans observed (for sampling)
        self._dropped = 0            # spans discarded by sampling

    # -- recording ----------------------------------------------------------
    def _local_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **args):
        """Open a span: ``with tracer.span("plan/lookup", level=lvl): ...``

        Returns a shared null context manager when disabled, or when this
        thread's current *root* span was sampled out.
        """
        if not self.enabled:
            return _NULL_SPAN
        if getattr(self._tls, "skip_depth", 0):
            # inside a sampled-out root: drop the whole subtree
            self._dropped += 1
            return _NULL_SPAN
        stack = self._local_stack()
        if not stack:                 # root span: apply sampling decision
            with self._lock:
                keep = (self._root_seen % self.sample_every) == 0
                self._root_seen += 1
            if not keep:
                self._tls.skip_depth = 1
                self._dropped += 1
                return _SkipSpan(self)
        return _OpenSpan(self, name, args or None)

    def _finish(self, open_span: _OpenSpan, t1: int, depth: int) -> None:
        span = Span(open_span.name, open_span.t0, t1, depth,
                    threading.get_ident(), open_span.args)
        with self._lock:
            self._spans.append(span)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (refit fired, plan swapped...)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        depth = len(self._local_stack())
        span = Span(name, now, now, depth, threading.get_ident(),
                    args or None)
        with self._lock:
            self._spans.append(span)

    # -- inspection ---------------------------------------------------------
    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._root_seen = 0
            self._dropped = 0

    # -- export -------------------------------------------------------------
    def to_chrome(self, process_name: str = "repro") -> list[dict]:
        """Chrome trace event list: complete ("X") events in microseconds,
        one pid for the process, one tid lane per recording thread."""
        spans = self.spans
        if not spans:
            return []
        t_base = min(s.t0 for s in spans)
        tids = {}
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        for s in spans:
            tid = tids.setdefault(s.tid, len(tids))
            ev = {
                "name": s.name,
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": (s.t0 - t_base) / 1e3,
                "dur": (s.t1 - s.t0) / 1e3,
            }
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        for raw, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": f"thread-{tid}"}})
        return events

    def export_chrome(self, path: str, process_name: str = "repro") -> int:
        """Write a chrome://tracing-loadable JSON file; returns #events."""
        events = self.to_chrome(process_name)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


class _SkipSpan:
    """Root-span placeholder while its subtree is sampled out."""
    __slots__ = ("_tracer",)

    def __init__(self, tracer: Tracer):
        self._tracer = tracer

    def __enter__(self) -> "_SkipSpan":
        return self

    def __exit__(self, *exc) -> None:
        tls = self._tracer._tls
        tls.skip_depth = max(0, getattr(tls, "skip_depth", 1) - 1)
        return None


# ---------------------------------------------------------------------------
# Process-wide default (same pattern as telemetry.default_telemetry)
# ---------------------------------------------------------------------------
_default: Tracer | None = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer (created disabled on first use)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Tracer(enabled=False)
    return _default


def peek_default_tracer() -> Tracer | None:
    """The default tracer if one exists, without creating it."""
    return _default


def set_default_tracer(tracer: Tracer | None) -> Tracer | None:
    """Swap the process-wide tracer (tests, scoped capture); returns old."""
    global _default
    with _default_lock:
        old, _default = _default, tracer
    return old
