"""Fault tolerance + straggler mitigation + elastic re-placement.

The reference package's `runtime/ft.py` with the port's checkpoint
store, planner service and telemetry:

* FaultTolerantLoop — checkpoint/restart loop. Runs `step_fn`
  repeatedly, checkpoints every `ckpt_every` steps (async), and on any
  step failure (device loss, an injected fault, a guarded launch that
  failed) restores the newest intact checkpoint and replays. The data
  pipeline is pure-in-step, so replay is exact. The loop owns the state
  it is given: a restore overwrites the live state's tensors in place
  (`CheckpointManager.restore`), so it needs no second copy of the state
  on the device. With a manager on a process mesh (`mesh=`, one process
  a rank) every rank runs the loop alike: the seeded step events fire
  on every rank at the same step, injected payload corruptions fail the
  same guarded call everywhere, `file_corrupt` clobbers rank 0's member
  of the newest step, and every rank restores the step that every rank
  verifies. A failure that is not injected is one rank's own: it is
  raised, never replayed, and the launcher ends the run.
* StragglerWatchdog — per-step timing over the shared telemetry ring
  (`runtime.telemetry`); a step slower than `threshold ×` the ring's EWMA
  is flagged.
* elastic_remesh — re-place a state on another device: the counterpart
  of the reference's `jax.device_put` onto new shardings. A checkpoint
  holds the shards of one local mesh as they are, so a remesh keeps
  every leaf's shape (re-sharding onto another rank count is not done
  here, nor by the reference's manual engine).

Straggler, failure-restart and remesh events all open a telemetry
*re-measure window* (`Telemetry.remeasure`): predicted-vs-measured
residuals, online calibration samples and arrival offsets gathered before
the event describe hardware that no longer exists.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import torch

from repro_torch.checkpoint import (CheckpointManager, tree_flatten,
                                    tree_unflatten)

from .metrics import default_metrics
from .telemetry import Telemetry, peek_default_telemetry
from .trace import default_tracer


@dataclasses.dataclass
class StragglerWatchdog:
    """Per-step straggler detector over the shared telemetry ring.

    `observe(step, dt) -> bool`, True when the step straggled. The EWMA
    baseline lives in `telemetry.ring(key)`; slow steps stay in the
    window for percentiles but do not move the baseline."""
    threshold: float = 2.0
    halflife: int = 20
    telemetry: Telemetry | None = None
    key: str = "train/step"
    # bounded: a long job with periodic stragglers must not grow an
    # unbounded event list; the deque keeps the freshest max_events
    max_events: int = 256
    events: deque = dataclasses.field(default=None)

    def __post_init__(self):
        if self.telemetry is None:
            self.telemetry = Telemetry()
        if self.events is None:
            self.events = deque(maxlen=self.max_events)

    @property
    def _ring(self):
        return self.telemetry.ring(self.key, halflife=self.halflife)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step straggled."""
        ring = self._ring
        ewma = ring.ewma
        if ewma is None:
            ring.add(dt)
            return False
        straggled = dt > self.threshold * ewma
        ring.add(dt, baseline=not straggled)
        if straggled:
            self.events.append((step, dt, ewma))
            default_tracer().instant("ft/straggler", step=step, dt=dt,
                                     ewma=ewma)
            default_metrics().counter(
                "ft_straggler_events_total",
                "steps flagged slower than threshold x EWMA").inc()
        return straggled


class FaultTolerantLoop:
    def __init__(self, step_fn: Callable[[Any, int], Any],
                 state: Any, ckpt: CheckpointManager, *,
                 ckpt_every: int = 50,
                 max_restarts: int = 10,
                 watchdog: StragglerWatchdog | None = None,
                 on_event: Callable[[str, dict], None] | None = None,
                 planner=None,
                 invalidate_on_resume: bool = True,
                 telemetry: Telemetry | None = None,
                 injector=None,
                 forgive_after: int = 200):
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        # one measurement datapath: explicit telemetry wins, then the
        # planner's, then the watchdog's
        self.telemetry = telemetry \
            or (planner.telemetry if planner is not None
                and getattr(planner, "telemetry", None) is not None
                else None)
        if watchdog is None:
            watchdog = StragglerWatchdog(telemetry=self.telemetry)
        self.watchdog = watchdog
        if self.telemetry is None:
            self.telemetry = watchdog.telemetry
        self.on_event = on_event or (lambda kind, info: None)
        self.restarts = 0
        # lowered schedules and bucket plans describe the mesh they were
        # lowered for; a restore may land on other hardware, so by
        # default every resume drops them (core.bucketing)
        self.planner = planner
        self.invalidate_on_resume = invalidate_on_resume
        # None defers to the scoped / env-armed injector
        # (`runtime.faults.active_injector`) at run time
        self.injector = injector
        # `forgive_after` consecutive successful steps reset `restarts`
        # to 0 (0 disables), so occasional failures in a long job never
        # exhaust max_restarts
        self.forgive_after = forgive_after
        self._progress = 0

    def _remeasure(self, reason: str, info: dict) -> None:
        """Open a telemetry re-measure window after an event that may
        change the executing hardware."""
        if self.telemetry is not None:
            self.telemetry.remeasure(reason, info)

    def _invalidate(self, reason: str, step: int) -> None:
        from repro_torch.core.bucketing import invalidate_schedules
        dropped = invalidate_schedules(self.planner)
        self._remeasure(reason, {"step": step, "dropped": dropped})
        self.on_event("invalidate", {"step": step, "dropped": dropped})

    def resume_or_init(self) -> int:
        self.ckpt.wait()          # an in-flight save lands first
        last = self.ckpt.latest_step()
        if last is not None:
            with default_tracer().span("ft/restore", step=last):
                self.state, step = self.ckpt.restore(self.state)
            default_metrics().counter(
                "ft_resumes_total",
                "checkpoint restores (resume-or-init hits)").inc()
            if self.invalidate_on_resume:
                self._invalidate("resume", step)
            self.on_event("resume", {"step": step})
            return step
        return 0

    def _active_injector(self):
        if self.injector is not None:
            return self.injector
        from .faults import active_injector
        return active_injector()

    def _apply_fault(self, ev, step: int) -> None:
        """Realize one injected step-scoped fault (DESIGN.md §12).
        device_loss raises (the except path restores-and-replays, like a
        real preemption); link faults flow into the planner's health map
        so it replans around the sag; delay slows this step (exercising
        the watchdog); file_corrupt clobbers the newest checkpoint (the
        checksum fallback restores the previous one)."""
        inj = self._active_injector()
        if ev.kind == "device_loss":
            from .faults import InjectedFault
            raise InjectedFault(ev)
        if ev.kind == "delay":
            time.sleep(min(max(ev.magnitude, 0.0), 0.25))
        elif ev.kind in ("link_degrade", "link_restore"):
            planner = self.planner
            if planner is not None and hasattr(planner, "mark_degraded"):
                factor = ev.magnitude if ev.kind == "link_degrade" else 1.0
                dropped = planner.mark_degraded(ev.target or "root_sw",
                                                factor)
                self.on_event("degrade" if factor < 1.0 else "restore",
                              {"step": step, "level": ev.target,
                               "factor": factor, "dropped": dropped})
        elif ev.kind == "file_corrupt" and inj is not None:
            # settle the in-flight save first, so the fault clobbers the
            # completed newest checkpoint instead of racing its writer
            self.ckpt.wait()
            steps = self.ckpt.available_steps()
            if steps:
                tag = f"step_{steps[0]:08d}"
                # on a process mesh rank 0's member alone: the agreed
                # restore then skips the step on every rank
                pm = self.ckpt.mesh
                if pm is None or pm.rank == 0:
                    inj.corrupt_file(self.ckpt.arrays_path(steps[0]))
                self.on_event("ckpt_corrupt", {"step": step,
                                               "target": tag})

    def run(self, total_steps: int, start_step: int | None = None) -> Any:
        step = self.resume_or_init() if start_step is None else start_step
        while step < total_steps:
            t0 = time.perf_counter()
            try:
                inj = self._active_injector()
                if inj is not None:
                    for ev in inj.step_events(step):
                        self._apply_fault(ev, step)
                self.state = self.step_fn(self.state, step)
                self._progress += 1
                if self.forgive_after and self.restarts \
                        and self._progress >= self.forgive_after:
                    default_metrics().counter(
                        "ft_restart_budget_resets_total",
                        "restart budgets reset after sustained progress"
                    ).inc()
                    self.on_event("budget_reset",
                                  {"step": step, "restarts": self.restarts})
                    self.restarts = 0
                    self._progress = 0
            except Exception as e:   # device loss, a failed launch: replay
                if self.ckpt.mesh is not None and not _mesh_wide(e):
                    # one rank's own failure: the others wait in a
                    # collective of the step, so nothing is agreed on;
                    # raised, the launcher ends every rank
                    raise
                self._progress = 0
                self.restarts += 1
                default_tracer().instant("ft/failure", step=step,
                                         restart=self.restarts)
                default_metrics().counter(
                    "ft_restarts_total",
                    "failed steps that triggered restore-and-replay").inc()
                self.on_event("failure", {"step": step, "error": repr(e),
                                          "restart": self.restarts})
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                if (self.invalidate_on_resume
                        and self.ckpt.latest_step() is None):
                    # no checkpoint to restore: resume_or_init will not
                    # invalidate, but the failure may still mean a new
                    # allocation, so drop stale schedules here too
                    self._invalidate("restart", 0)
                step = self.resume_or_init()
                continue
            dt = time.perf_counter() - t0
            if self.watchdog.observe(step, dt):
                self._remeasure("straggler", {"step": step, "dt": dt})
                self.on_event("straggler", {"step": step, "dt": dt})
            step += 1
            if step % self.ckpt_every == 0:
                with default_tracer().span("ft/checkpoint", step=step):
                    self.ckpt.save(step, self.state)
                default_metrics().counter(
                    "ft_checkpoints_total",
                    "periodic checkpoint saves").inc()
                self.on_event("checkpoint", {"step": step})
        self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return self.state


def _mesh_wide(err: BaseException) -> bool:
    """Whether every rank of a process mesh fails alike with `err`: an
    injected fault, which fires at the same step (a step event) or the
    same guarded call (a payload corruption, before any round of it is
    posted) on every rank, since every rank parses the same seeded plan
    and makes the same guarded calls."""
    from .faults import InjectedFault
    return isinstance(err, InjectedFault)


def elastic_remesh(state: Any, device: str | torch.device, *,
                   planner=None, invalidate: bool = True,
                   telemetry: Telemetry | None = None) -> Any:
    """Place every tensor leaf of `state` on `device`, its shape unchanged
    (other leaves are kept as they are); the counterpart of the
    reference's `jax.device_put` onto new shardings.

    A remesh may change the executing mesh, so by default every lowered
    CompiledSchedule and bucket plan derived from the planner's cache is
    dropped and a telemetry re-measure window opens. Pass `planner` to
    invalidate a specific service; the default invalidates the
    process-wide service (and its telemetry hub) if one exists."""
    with default_tracer().span("ft/remesh", invalidate=invalidate):
        if invalidate:
            from repro_torch.core.bucketing import invalidate_schedules
            dropped = invalidate_schedules(planner)
            tele = telemetry \
                or (getattr(planner, "telemetry", None)
                    if planner is not None
                    else peek_default_telemetry())
            if tele is not None:
                tele.remeasure("remesh", {"dropped": dropped})
        default_metrics().counter(
            "ft_remesh_total", "elastic remesh operations").inc()
        leaves, _ = tree_flatten(state)
        return tree_unflatten(state, [
            x.to(device) if isinstance(x, torch.Tensor) else x
            for x in leaves])
