"""The port's fault injector (`repro_torch.runtime.faults`), fault-tolerant
loop and elastic re-placement (`repro_torch.runtime.ft`) and the guard's
use of the injector, on the CPU.

The reference's cases (tests/test_faults.py: FaultPlan and
FaultInjector, the watchdog's bounded log, the loop's replay of an
injected device loss and its link faults into the planner's health;
tests/test_substrate.py: the loop's replay, resume and schedule
invalidation, elastic remesh) run against the port, with the port's
planner service. The same plan arguments give the same plan, with the
same `key()`, in both packages. Exact throughout.
"""
import os

import numpy as np
import pytest
import torch

from repro.runtime import faults as ref_faults
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.planner.service import PlannerService
from repro_torch.runtime.faults import (ENV_VAR, FaultEvent, FaultInjector,
                                        FaultPlan, InjectedFault,
                                        active_injector)
from repro_torch.runtime.ft import (FaultTolerantLoop, StragglerWatchdog,
                                    elastic_remesh)
from repro_torch.runtime.metrics import default_metrics

RATES = dict(device_loss=0.05, link_degrade=0.05, delay=0.1,
             payload_corrupt=0.1, file_corrupt=0.05)


@pytest.fixture
def quiet_faults(monkeypatch):
    """No ambient injector: an empty scoped plan masks $REPRO_FAULT_PLAN."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    with FaultInjector(FaultPlan()) as inj:
        yield inj


def _counter(name: str) -> float:
    return default_metrics().counter(name).value


# ---------------------------------------------------------------------------
# FaultPlan: determinism, parsing, the reference's plans
# ---------------------------------------------------------------------------
def test_generate_is_deterministic():
    a = FaultPlan.generate(7, 200, **RATES)
    b = FaultPlan.generate(7, 200, **RATES)
    assert a.events == b.events
    assert a.key() == b.key()
    assert a.key() != FaultPlan.generate(8, 200, **RATES).key()


@pytest.mark.parametrize("seed", [0, 1, 41, 9_999])
def test_plan_key_stable_across_regeneration(seed):
    kw = dict(steps=64, device_loss=0.05, link_degrade=0.1, delay=0.1,
              payload_corrupt=0.1)
    assert FaultPlan.generate(seed, **kw).key() == \
        FaultPlan.generate(seed, **kw).key()


@pytest.mark.parametrize("spec", [
    "seed=7,steps=256,payload_corrupt=0.05",
    "seed=7,steps=200,link_degrade=0.01,payload_corrupt=0.05",
    "seed=3,steps=64,device_loss=0.1,file_corrupt=0.1,delay=0.5",
    "41", ""])
def test_plan_equals_the_reference(spec):
    """`FaultPlan.parse` (and so `generate`) gives the reference's events
    and `key()` for the same spec."""
    port, ref = FaultPlan.parse(spec), ref_faults.FaultPlan.parse(spec)
    assert port.key() == ref.key()
    assert [(e.kind, e.at, e.target, e.magnitude) for e in port.events] \
        == [(e.kind, e.at, e.target, e.magnitude) for e in ref.events]


@pytest.mark.parametrize("seed,steps", [(0, 1), (17, 32), (500, 64)])
def test_step_events_fire_once_per_injector(seed, steps):
    plan = FaultPlan.generate(seed, steps, delay=0.3, link_degrade=0.2)
    inj = FaultInjector(plan)
    first = [ev for s in range(steps) for ev in inj.step_events(s)]
    again = [ev for s in range(steps) for ev in inj.step_events(s)]
    assert sorted(e.ident for e in first) == \
        sorted(e.ident for e in plan.events if e.kind in
               ("delay", "link_degrade", "link_restore"))
    assert again == []                    # replay after restore: no re-fire


def test_parse_spec_and_bare_seed():
    p = FaultPlan.parse("seed=7,steps=64,delay=0.5,payload_corrupt=0")
    assert p.seed == 7 and p.count("delay") > 0
    assert p.count("payload_corrupt") == 0
    assert p.events == FaultPlan.parse(" seed=7, steps=64, delay=0.5,"
                                       "payload_corrupt=0 ").events
    bare = FaultPlan.parse("41")
    assert bare.seed == 41
    assert bare.count("device_loss") == 0     # survivable defaults
    with pytest.raises(ValueError):
        FaultPlan.parse("seed=1,bogus=2")


def test_link_degrade_pairs_with_restore():
    plan = FaultPlan.generate(3, 200, link_degrade=0.2)
    degrades = [e for e in plan.events if e.kind == "link_degrade"]
    restores = {(e.target, e.at) for e in plan.events
                if e.kind == "link_restore"}
    assert degrades
    for d in degrades:
        assert 0.25 <= d.magnitude <= 0.75
        assert any(t == d.target and d.at < at <= d.at + 8
                   for t, at in restores) or d.at + 8 >= 200


# ---------------------------------------------------------------------------
# FaultInjector: scoping, launch ordinals, file corruption
# ---------------------------------------------------------------------------
def test_injector_scoping_is_lifo(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert active_injector() is None
    outer, inner = FaultInjector(FaultPlan()), FaultInjector(FaultPlan())
    with outer:
        assert active_injector() is outer
        with inner:
            assert active_injector() is inner
        assert active_injector() is outer
    assert active_injector() is None


def test_env_var_arms_process_wide_injector(monkeypatch):
    monkeypatch.setenv(ENV_VAR, "seed=9,steps=16,delay=0.5")
    inj = active_injector()
    assert inj is not None
    assert inj.plan.key() == FaultPlan.parse("seed=9,steps=16,delay=0.5"
                                             ).key()
    with FaultInjector(FaultPlan()) as scoped:
        assert active_injector() is scoped
    monkeypatch.setenv(ENV_VAR, "seed=9,not_a_fault=1")
    assert active_injector() is None


def test_check_launch_consumes_ordinals(quiet_faults):
    plan = FaultPlan(seed=1, events=(FaultEvent("payload_corrupt", 2),))
    with FaultInjector(plan) as inj:
        inj.check_launch("a")             # ordinal 0
        inj.check_launch("b")             # ordinal 1
        with pytest.raises(InjectedFault) as ei:
            inj.check_launch("c")         # ordinal 2: armed
        assert ei.value.event.kind == "payload_corrupt"
        inj.check_launch("d")             # fired once: ordinal 3 clean
        assert inj.stats()["launches"] == 4
        assert inj.stats()["fired"] == {"payload_corrupt": 1}


def test_corrupt_file_is_deterministic(tmp_path):
    payload = os.urandom(4096)
    p1, p2 = tmp_path / "blob.bin", tmp_path / "sub"
    p2.mkdir()
    p2 = p2 / "blob.bin"
    p1.write_bytes(payload)
    p2.write_bytes(payload)
    a = FaultInjector(FaultPlan(seed=5))
    b = FaultInjector(FaultPlan(seed=5))
    assert a.corrupt_file(str(p1)) and b.corrupt_file(str(p2))
    assert p1.read_bytes() == p2.read_bytes()     # seeded by (seed, name)
    assert p1.read_bytes() != payload[:len(p1.read_bytes())]
    assert p1.read_bytes().startswith(b"\x00CHAOS\x00")
    assert not a.corrupt_file(str(tmp_path / "missing.bin"))


# ---------------------------------------------------------------------------
# the guard: an injected payload corruption is a failed launch
# ---------------------------------------------------------------------------
def test_guard_raises_injected_payload_corruption(quiet_faults, monkeypatch):
    """An armed `payload_corrupt` at launch ordinal 1 raises InjectedFault
    from the guard's second launch, counted as one failure; no fold of
    that launch runs (no `fused_reduce_into` call, `ops.LAUNCHES`
    unchanged); the next launch runs; nothing demotes."""
    from repro_torch.core.lower import guard_schedule
    cs = PlannerService().get_axis_executable("data", 8, 4096.0).schedule
    g = guard_schedule(cs)
    calls = []
    real = ops.fused_reduce_into
    monkeypatch.setattr(ops, "fused_reduce_into",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 512)).astype(np.float32))
    plan = FaultPlan(seed=1, events=(FaultEvent("payload_corrupt", 1),))
    failures = _counter("guarded_failures_total")
    before = dict(g.stats)
    with FaultInjector(plan) as inj:
        want = g.run_local(X)
        folds = len(calls)
        launches = dict(ops.LAUNCHES)
        with pytest.raises(InjectedFault, match="payload_corrupt at 1"):
            g.run_local(X)
        assert len(calls) == folds and ops.LAUNCHES == launches
        assert torch.equal(g.run_local(X), want)
        assert len(calls) == 2 * folds
        assert inj.stats()["launches"] == 3
    assert g.stats["launches"] == before["launches"] + 3
    assert g.stats["failures"] == before["failures"] + 1
    assert _counter("guarded_failures_total") == failures + 1
    assert g.demotions == 0
    assert torch.allclose(want, X.sum(0).expand_as(X), rtol=1e-6,
                          atol=1e-5)


# ---------------------------------------------------------------------------
# the loop (tests/test_faults.py, tests/test_substrate.py)
# ---------------------------------------------------------------------------
def test_watchdog_event_log_is_bounded():
    wd = StragglerWatchdog(threshold=2.0, max_events=4)
    wd.observe(0, 0.01)                   # seeds the EWMA baseline
    for step in range(1, 40):
        wd.observe(step, 5.0)             # every step straggles
    assert len(wd.events) == 4
    assert wd.events[-1][0] == 39         # deque keeps the freshest


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, halflife=5)
    for s in range(20):
        assert not wd.observe(s, 1.0)
    assert wd.observe(20, 5.0)            # 5x the EWMA
    assert wd.events and wd.events[0][0] == 20
    assert not wd.observe(21, 1.2)        # baseline not poisoned


def _acc(v: float = 0.0) -> dict:
    return {"acc": torch.tensor(v, dtype=torch.float64)}


def test_loop_replays_injected_device_loss_and_forgives(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    plan = FaultPlan(seed=1, events=(FaultEvent("device_loss", 3),
                                     FaultEvent("delay", 1,
                                                magnitude=0.001)))
    events = []
    loop = FaultTolerantLoop(
        lambda state, step: {"acc": state["acc"] + 1.0}, _acc(),
        CheckpointManager(str(tmp_path), async_save=False),
        ckpt_every=2, injector=FaultInjector(plan), forgive_after=2,
        on_event=lambda kind, info: events.append(kind))
    out = loop.run(8)
    kinds = set(events)
    assert float(out["acc"]) == 8.0       # restore-and-replay is exact
    assert "failure" in kinds
    assert "budget_reset" in kinds        # 2 good steps reset the budget
    assert loop.restarts == 0


def test_loop_link_fault_flows_into_planner_health(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    svc = PlannerService()
    plan = FaultPlan(seed=1, events=(
        FaultEvent("link_degrade", 1, "root_sw", 0.5),
        FaultEvent("link_restore", 3, "root_sw")))
    seen = []
    mid_run_health = {}

    def step_fn(state, step):
        if step == 2:
            mid_run_health.update(svc.degraded())
        return {"acc": state["acc"] + 1.0}

    loop = FaultTolerantLoop(
        step_fn, _acc(), CheckpointManager(str(tmp_path), async_save=False),
        ckpt_every=10, planner=svc, injector=FaultInjector(plan),
        on_event=lambda kind, info: seen.append((kind, dict(info))))
    loop.run(5)
    assert mid_run_health == {"root_sw": 0.5}     # degraded mid-run...
    assert svc.degraded() == {}                   # ...restored by the end
    kinds = [k for k, _ in seen]
    assert "degrade" in kinds and "restore" in kinds


def _failing_loop(path, fail_at, ckpt_every, svc=None, **kw):
    seen = {"failed": False}

    def step_fn(state, step):
        if step == fail_at and not seen["failed"]:
            seen["failed"] = True
            raise RuntimeError("injected device loss")
        return {"acc": state["acc"] + step}

    return FaultTolerantLoop(step_fn, _acc(),
                             CheckpointManager(path, keep=3,
                                               async_save=False),
                             ckpt_every=ckpt_every, planner=svc, **kw)


def test_ft_loop_recovers_from_failures(tmp_path):
    """A failure at step 7 restores step 5 and ends on the failure-free
    run's state; the restore writes into the live state's tensor."""
    clean = _failing_loop(str(tmp_path / "a"), -1, 5).run(12)
    loop = _failing_loop(str(tmp_path / "b"), 7, 5)
    seen = {}

    def on_event(kind, info):
        seen.setdefault(kind, loop.state["acc"])
    loop.on_event = on_event
    faulty = loop.run(12)
    assert float(clean["acc"]) == float(faulty["acc"]) == sum(range(12))
    assert loop.restarts == 1
    assert seen["resume"] is seen["failure"]      # restored in place


def test_ft_loop_resumes_from_disk(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(10, _acc(45.0))                      # sum of 0..9
    loop = FaultTolerantLoop(lambda s, i: {"acc": s["acc"] + i}, _acc(),
                             mgr, ckpt_every=100)
    assert float(loop.run(12)["acc"]) == sum(range(12))


def test_ft_loop_waits_for_the_inflight_save(tmp_path, monkeypatch):
    """A device loss just after an async save restores that save, not an
    older one: the loop lets the writer land before it reads LATEST."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    plan = FaultPlan(seed=1, events=(FaultEvent("device_loss", 4),))
    events = []
    loop = FaultTolerantLoop(
        lambda s, i: {"acc": s["acc"] + i}, _acc(), mgr, ckpt_every=4,
        injector=FaultInjector(plan),
        on_event=lambda kind, info: events.append((kind, info)))
    assert float(loop.run(6)["acc"]) == sum(range(6))
    assert ("resume", {"step": 4}) in events
    assert mgr.latest_step() == 6


# ---------------------------------------------------------------------------
# schedule invalidation (tests/test_substrate.py)
# ---------------------------------------------------------------------------
def test_elastic_remesh_invalidates_bucket_schedules():
    """A remesh may change the mesh: every lowered CompiledSchedule and
    bucket plan derived from the planner cache is dropped, the next
    lookup rebuilds for the new size, and every leaf is placed on the
    device with its shape unchanged."""
    svc = PlannerService()
    bp8 = svc.get_bucket_plan([("data", 8)], 4096.0)
    assert bp8.axis_plans[0].schedule.n == 8
    assert svc.executable_count() > 0
    remeshes = _counter("ft_remesh_total")
    state = {"w": torch.ones((4, 4)), "step": 3, "l": [torch.zeros(2)]}
    out = elastic_remesh(state, "cpu", planner=svc)
    assert torch.equal(out["w"], torch.ones((4, 4))) and out["step"] == 3
    assert out["l"][0].shape == (2,)
    assert svc.executable_count() == 0          # stale schedules gone
    assert _counter("ft_remesh_total") == remeshes + 1
    assert "remesh" in [e.kind for e in svc.telemetry.events]

    bp4 = svc.get_bucket_plan([("data", 4)], 4096.0)
    assert bp4.source == "cold"
    assert bp4.axis_plans[0].schedule.n == 4
    assert bp4.axis_plans[0].schedule is not bp8.axis_plans[0].schedule


def test_ft_resume_invalidates_and_rebuilds_bucket_schedules(tmp_path):
    svc = PlannerService()
    svc.get_bucket_plan([("data", 8)], 8192.0)
    assert svc.executable_count() > 0
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(10, _acc(45.0))
    events = []
    loop = FaultTolerantLoop(
        lambda s, i: {"acc": s["acc"] + i}, _acc(), mgr,
        ckpt_every=100, planner=svc,
        on_event=lambda kind, info: events.append((kind, info)))
    out = loop.run(12)
    assert float(out["acc"]) == sum(range(12))
    kinds = [k for k, _ in events]
    assert "resume" in kinds and "invalidate" in kinds
    assert dict(events)["invalidate"]["dropped"] > 0
    assert svc.executable_count() == 0
    bp = svc.get_bucket_plan([("data", 4)], 8192.0)
    assert bp.axis_plans[0].schedule.n == 4


def test_ft_failure_restart_invalidates_bucket_schedules(tmp_path):
    svc = PlannerService()
    svc.get_bucket_plan([("data", 8)], 4096.0)
    loop = _failing_loop(str(tmp_path), 7, 5, svc)
    assert float(loop.run(12)["acc"]) == sum(range(12))
    assert loop.restarts == 1
    assert svc.executable_count() == 0


def test_ft_restart_without_checkpoint_invalidates(tmp_path):
    """A failure before the first checkpoint restarts from step 0 with no
    restore; the stale schedules are dropped all the same."""
    svc = PlannerService()
    svc.get_bucket_plan([("data", 8)], 4096.0)
    loop = _failing_loop(str(tmp_path), 3, 50, svc)
    out = loop.run(6)
    # no checkpoint: the in-memory state survives the restart (steps 0-2
    # already applied) and the loop replays 0..5 on top
    assert float(out["acc"]) == sum(range(3)) + sum(range(6))
    assert loop.restarts == 1
    assert svc.executable_count() == 0


def test_ft_resume_invalidation_opt_out(tmp_path):
    svc = PlannerService()
    svc.get_bucket_plan([("data", 8)], 4096.0)
    before = svc.executable_count()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(10, _acc(45.0))
    loop = FaultTolerantLoop(
        lambda s, i: {"acc": s["acc"] + i}, _acc(), mgr,
        ckpt_every=100, planner=svc, invalidate_on_resume=False)
    loop.run(12)
    assert svc.executable_count() == before       # schedules kept
