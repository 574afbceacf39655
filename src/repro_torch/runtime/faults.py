"""Seeded, deterministic fault injection for chaos testing (DESIGN.md §12).

* FaultPlan — an immutable, seed-derived sequence of FaultEvents. The same
  (seed, rates, steps) always generates the same events, so a failing
  chaos run is replayable bit-for-bit: re-run with the plan's `key()` and
  the exact failure sequence recurs.
* FaultInjector — a context manager that arms a FaultPlan. While active,
  - `FaultTolerantLoop` consults `step_events(step)` each step and applies
    step-scoped faults (device loss, link degrade/restore, delayed
    arrival, checkpoint/cache file corruption);
  - `GuardedSchedule` (core.lower) consults `check_launch()` before each
    collective launch and receives payload-corruption faults as raised
    `InjectedFault`s, which it records and raises as a failed launch.
  Every event fires exactly ONCE per injector (tracked by event id), so a
  device-loss at step k does not re-fire after restore-and-replay reaches
  step k again — chaos runs terminate.
* `REPRO_FAULT_PLAN` env var — arms a process-wide injector for CI chaos
  jobs without touching call sites: `seed=7,steps=256,payload_corrupt=0.05`
  (see `FaultPlan.parse`). Explicitly-entered injectors take precedence.

The reference package's `runtime/faults.py`, kept as it is but for its
docstrings' account of the guard: the port's `GuardedSchedule` records
and raises an injected payload corruption as it does a real launch
failure, and the loop answers it by restoring the newest intact
checkpoint and replaying. The same arguments give the same plan, with
the same `key()`, in both packages.

Standard library only (no torch import): the module is safe to import
from metrics/telemetry-level code.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import threading

from .metrics import default_metrics

# step-scoped kinds are applied by FaultTolerantLoop at step boundaries;
# "payload_corrupt" is launch-scoped (its `at` indexes guarded collective
# launches, consumed by GuardedSchedule.check_launch).
STEP_KINDS = ("device_loss", "link_degrade", "link_restore", "delay",
              "file_corrupt")
LAUNCH_KINDS = ("payload_corrupt",)
KINDS = STEP_KINDS + LAUNCH_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault. `at` is a step index for STEP_KINDS and a
    guarded-launch ordinal for LAUNCH_KINDS. `target` names what the
    fault hits (a level class for link faults, "checkpoint"/"cache" for
    file corruption). `magnitude` is kind-specific: the bandwidth
    multiplier for link_degrade (0.5 → half bandwidth) or the sleep
    seconds for delay."""
    kind: str
    at: int
    target: str = ""
    magnitude: float = 0.0

    @property
    def ident(self) -> tuple:
        return (self.kind, self.at, self.target)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule: events are fully determined by the
    generation inputs; `key()` digests them for replay bookkeeping."""
    seed: int = 0
    events: tuple = ()

    @classmethod
    def generate(cls, seed: int, steps: int, *,
                 device_loss: float = 0.0,
                 link_degrade: float = 0.0,
                 delay: float = 0.0,
                 payload_corrupt: float = 0.0,
                 file_corrupt: float = 0.0,
                 levels=("root_sw", "cross_dc"),
                 file_targets=("checkpoint", "cache")) -> "FaultPlan":
        """Draw per-step Bernoulli events at the given rates from a
        `random.Random(seed)` stream — no wall clock, no global RNG, so
        the same arguments always yield the same plan. A link_degrade is
        paired with a link_restore a deterministic number of steps later
        so degradation windows are bounded."""
        rng = random.Random(int(seed))
        events = []
        for step in range(int(steps)):
            if device_loss and rng.random() < device_loss:
                events.append(FaultEvent("device_loss", step))
            if link_degrade and rng.random() < link_degrade:
                lvl = levels[rng.randrange(len(levels))]
                factor = 0.25 + 0.5 * rng.random()      # 0.25x..0.75x bw
                events.append(FaultEvent("link_degrade", step, lvl,
                                         round(factor, 4)))
                heal = step + 1 + rng.randrange(8)
                if heal < steps:
                    events.append(FaultEvent("link_restore", heal, lvl))
            if delay and rng.random() < delay:
                events.append(FaultEvent(
                    "delay", step, magnitude=round(0.01 * (1 + 4 *
                                                          rng.random()), 4)))
            if payload_corrupt and rng.random() < payload_corrupt:
                # launch ordinal, decoupled from the step counter
                events.append(FaultEvent("payload_corrupt",
                                         rng.randrange(max(1, 4 * steps))))
            if file_corrupt and rng.random() < file_corrupt:
                tgt = file_targets[rng.randrange(len(file_targets))]
                events.append(FaultEvent("file_corrupt", step, tgt))
        # dedupe by identity (two draws can alias the same launch ordinal)
        seen, uniq = set(), []
        for ev in events:
            if ev.ident not in seen:
                seen.add(ev.ident)
                uniq.append(ev)
        return cls(seed=int(seed), events=tuple(uniq))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse an env-var style spec: `seed=7,steps=256,delay=0.02,
        payload_corrupt=0.05,link_degrade=0.01,device_loss=0,
        file_corrupt=0`. A bare integer is shorthand for that seed with
        mild survivable defaults (no device loss)."""
        spec = (spec or "").strip()
        kv = {}
        if spec:
            if "=" not in spec:
                kv["seed"] = spec
            else:
                for part in spec.split(","):
                    part = part.strip()
                    if not part:
                        continue
                    k, _, v = part.partition("=")
                    kv[k.strip()] = v.strip()
        seed = int(float(kv.pop("seed", 0)))
        steps = int(float(kv.pop("steps", 256)))
        rates = {"device_loss": 0.0, "link_degrade": 0.0, "delay": 0.02,
                 "payload_corrupt": 0.02, "file_corrupt": 0.0}
        for k in list(rates):
            if k in kv:
                rates[k] = float(kv.pop(k))
        if kv:
            raise ValueError(f"unknown fault-plan keys: {sorted(kv)}")
        return cls.generate(seed, steps, **rates)

    def key(self) -> str:
        h = hashlib.sha256(repr((self.seed, self.events)).encode())
        return h.hexdigest()[:16]

    def events_at(self, step: int) -> list:
        return [e for e in self.events
                if e.at == step and e.kind in STEP_KINDS]

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)


class InjectedFault(RuntimeError):
    """Raised when an armed fault fires (device loss, corrupted payload).
    Carries the triggering event so handlers can log exactly what hit."""

    def __init__(self, event: FaultEvent):
        super().__init__(f"injected fault: {event.kind} at {event.at}"
                         + (f" target={event.target}" if event.target
                            else ""))
        self.event = event


_LOCK = threading.Lock()
_STACK: list = []                 # explicitly entered injectors (LIFO)
_ENV_INJECTOR = None              # lazily built from REPRO_FAULT_PLAN
_ENV_SPEC_SEEN = None

ENV_VAR = "REPRO_FAULT_PLAN"


class FaultInjector:
    """Arms a FaultPlan for a scoped region. Context-manager entry pushes
    the injector onto a process-global stack (innermost wins) so library
    code reaches it via `active_injector()` without plumbing."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set = set()
        self._launches = 0
        self._launch_events = {e.at: e for e in plan.events
                               if e.kind in LAUNCH_KINDS}
        self._by_step: dict = {}
        for e in plan.events:
            if e.kind in STEP_KINDS:
                self._by_step.setdefault(e.at, []).append(e)
        self.counts: dict = {}
        self._lock = threading.Lock()

    # -- scoping ----------------------------------------------------------
    def __enter__(self):
        with _LOCK:
            _STACK.append(self)
        return self

    def __exit__(self, *exc):
        with _LOCK:
            if self in _STACK:
                _STACK.remove(self)
        return False

    # -- firing -----------------------------------------------------------
    def _record(self, ev: FaultEvent) -> None:
        self.counts[ev.kind] = self.counts.get(ev.kind, 0) + 1
        default_metrics().counter(
            "faults_injected_total",
            "fault events fired by the chaos injector").inc()

    def step_events(self, step: int) -> list:
        """Unfired step-scoped events due at `step`. Each event fires
        once per injector lifetime: restore-and-replay passing the same
        step again sees an empty list, so chaos runs terminate."""
        out = []
        with self._lock:
            for ev in self._by_step.get(step, ()):
                if ev.ident in self._fired:
                    continue
                self._fired.add(ev.ident)
                self._record(ev)
                out.append(ev)
        return out

    def check_launch(self, label: str = "") -> None:
        """Consume one guarded-launch ordinal; raise InjectedFault when a
        payload-corruption event is armed at this ordinal. Called by
        GuardedSchedule before dispatching a collective."""
        with self._lock:
            ordinal = self._launches
            self._launches += 1
            ev = self._launch_events.get(ordinal)
            if ev is None or ev.ident in self._fired:
                return
            self._fired.add(ev.ident)
            self._record(ev)
        raise InjectedFault(ev)

    def corrupt_file(self, path: str) -> bool:
        """Deterministically corrupt the file at `path` in place (seeded
        by plan seed + basename, so replays clobber the same bytes).
        Returns False when the file doesn't exist."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        rng = random.Random(f"{self.plan.seed}:{os.path.basename(path)}")
        garbage = bytes(rng.randrange(256) for _ in range(
            min(64, max(1, size))))
        try:
            with open(path, "r+b") as f:
                f.seek(0)
                f.write(b"\x00CHAOS\x00" + garbage)
                f.truncate(max(len(garbage) + 8, size // 2))
        except OSError:
            return False
        default_metrics().counter(
            "faults_files_corrupted_total",
            "files clobbered by the chaos injector").inc()
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"key": self.plan.key(), "seed": self.plan.seed,
                    "fired": dict(self.counts),
                    "launches": self._launches,
                    "pending": len(self.plan.events) - len(self._fired)}


def _env_injector():
    global _ENV_INJECTOR, _ENV_SPEC_SEEN
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return None
    with _LOCK:
        if _ENV_INJECTOR is None or _ENV_SPEC_SEEN != spec:
            try:
                plan = FaultPlan.parse(spec)
            except (ValueError, TypeError):
                return None        # malformed spec never crashes the host
            _ENV_INJECTOR = FaultInjector(plan)
            _ENV_SPEC_SEEN = spec
        return _ENV_INJECTOR


def active_injector():
    """Innermost explicitly-entered injector, else the env-armed one,
    else None. The common library call sites (GuardedSchedule,
    FaultTolerantLoop) poll this so chaos needs no plumbing."""
    with _LOCK:
        if _STACK:
            return _STACK[-1]
    return _env_injector()
