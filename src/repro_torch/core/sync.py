"""Mesh-axis level classes and per-axis plan selection.

From the reference `core/sync.py`: which Table-5 level class prices each
mesh-axis position, the single-switch stand-in topology an axis is
planned on, the per-axis plan labels `PlannerService.get_axis_plans`
returns, the trainer's `SyncConfig`, and `resolve_axis_plans` for
`strategy="plan"`, the GenTree plan lowered to a schedule the local mesh
runs. The flat strategies (`psum`, `ring`, `rhd`, `cps`, `hcps`,
`gentree`) and `sync_gradients` need the multi-process executor (ROADMAP
§1 item 4); wire precisions are chosen by the bucket plans (item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .cost_model import GPU_AXIS_BASIS, GenModelParams, best_flat_plan


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    axis: str
    strategy: str                   # psum | ring | rhd | cps | hcps | plan
    factors: tuple[int, ...] | None = None
    # strategy == "plan": the lowered GenTree schedule to execute
    # (core.lower.CompiledSchedule; compared/hashed by identity)
    schedule: object | None = None
    # modeled cost of this axis's plan at the priced size (seconds) —
    # what the runtime pairs with measured timings when it feeds the
    # online loop (PlannerService.observe, DESIGN.md §10)
    predicted: float | None = None


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """strategy: auto|psum|ring|rhd|cps|hcps|gentree|plan per DP axis.
    "gentree" picks a flat plan-type label per axis; "plan" lowers the
    GenTree Plan IR itself and executes its compiled schedule — bucketed
    and pipelined by default: bucket_bytes=None lets GenModel pick the
    bucket size, an explicit value pins it, and 0 disables bucketing
    (per-leaf execution). pipeline=False runs buckets back-to-back.
    The reference's fields and defaults; the port runs `strategy="plan"`
    with `bucket_bytes=0` at full precision (see `resolve_axis_plans`).
    """
    strategy: str = "auto"
    factors: tuple[int, ...] | None = None   # for explicit hcps
    compress: str | None = None              # None | "int8"
    params: dict[str, GenModelParams] | None = None
    bucket_bytes: int | None = None          # None=auto | 0=off | fixed
    pipeline: bool = True                    # double-buffer RS/AG halves
    # buckets go in reverse-layer readiness order (bucketed path only)
    backward_overlap: bool = True
    # wrap executed schedules in core.lower.GuardedSchedule (counts
    # launches, records and re-raises failures)
    guard: bool = True
    # wire precision name ("f32"|"bf16"|"fp8"|"int8") and the relative
    # gradient error the caller accepts
    precision: str | None = None
    tolerance: float | None = None


# Table-5 class per mesh-axis position: the leaf axis rides the fast
# in-machine fabric ("root_sw" pricing), every outer axis the slower
# between-machine fabric ("cross_dc"). Uncalibrated, "root_sw" prices
# at the GPU testbed's NVLink row (`cost_model.GPU_AXIS_BASIS`).
AXIS_LEVELS = ("root_sw",) + ("cross_dc",) * 8


def axis_level(i: int) -> str:
    return AXIS_LEVELS[min(i, len(AXIS_LEVELS) - 1)]


def level_switch_topo(n: int, params: dict[str, GenModelParams],
                      level: str):
    """Single-switch stand-in for a mesh axis at a Table-5 level class:
    one switch, n servers whose uplink bandwidth realizes the level's β
    (seconds per 4-byte unit → bytes/s), pricing α/γ/δ/ε/w_t coming from
    the params table. The ONE synthesis shared by axis pricing
    (`plan_axes_gentree`) and axis execution
    (`PlannerService.get_axis_executable`) — the executed plan must be
    the plan the model priced."""
    from .topology import single_switch
    p = params.get(level, params["server"])
    bw = 4.0 / p.beta if p.beta > 0 else 1e18
    return single_switch(int(n), bw=bw, lat=0.0, level=level)


def plan_axes_gentree(axes: Sequence[tuple[str, int]], size_floats: float,
                      params: dict[str, GenModelParams] | None = None, *,
                      engine: str | None = None,
                      gentree_kwargs: dict | None = None) -> list[AxisPlan]:
    """Per-level plan selection for a hierarchical mesh.

    axes: [(axis_name, size), ...] ordered leaf-level first. Level 0
    prices with the in-machine parameters, outer levels with the
    between-machine parameters (`axis_level`).

    With default `engine`/`gentree_kwargs` each axis is priced by the
    GenModel closed forms (`best_flat_plan`). When either is configured,
    the axis is priced by running GenTree itself on the equivalent
    single-switch topology with exactly that engine and those kwargs.
    """
    params = params or GPU_AXIS_BASIS
    gkw = dict(gentree_kwargs or {})
    use_gentree = engine is not None or bool(gkw)
    out: list[AxisPlan] = []
    for i, (name, n) in enumerate(axes):
        lvl = axis_level(i)
        p = params[lvl]
        # the γ/δ terms always price at the chip ("server") level
        srv = params["server"]
        p = dataclasses.replace(p, gamma=srv.gamma, delta=srv.delta)
        if n == 1:
            continue
        if use_gentree:
            from .gentree import gentree as run_gentree
            topo = level_switch_topo(n, {lvl: p, "server": srv}, lvl)
            res = run_gentree(topo, size_floats,
                              params={lvl: p, "server": srv},
                              engine=engine, **gkw)
            dec = res.decisions[topo.name]
            kind = "cps" if dec.algo == "acps" else dec.algo
            fac = dec.factors
            cost = dec.cost
        else:
            kind, fac, cost = best_flat_plan(n, size_floats, p)
        out.append(AxisPlan(name, kind, tuple(fac) if fac else None,
                            predicted=float(cost)))
    return out


def resolve_axis_plans(axes: Sequence[tuple[str, int]], cfg: SyncConfig,
                       size_floats: float) -> list[AxisPlan]:
    """Per-axis plans of `strategy="plan"`: for each axis of size > 1 the
    planner's executable (`get_axis_executable` at the axis's Table-5
    class, `cfg.params` honoured), wrapped in the schedule guard unless
    `cfg.guard` is off. The level index counts the original axis position
    (size-1 axes are skipped but keep their level), as the reference's.
    Lookups go through the process-wide planner service."""
    if cfg.strategy != "plan":
        raise NotImplementedError(
            f"sync strategy {cfg.strategy!r} needs the multi-process "
            "executor (ROADMAP §1 item 4); the port runs strategy='plan'")
    if cfg.compress is not None:
        raise NotImplementedError(
            f"compress={cfg.compress!r} (allreduce_int8_cps) needs the "
            "multi-process executor (ROADMAP §1 item 4)")
    if cfg.precision is not None:
        raise NotImplementedError(
            f"precision={cfg.precision!r}: compressed gradient sync comes "
            "with the bucket plans (ROADMAP §1 item 2)")
    from repro_torch.core.lower import guard_schedule
    from repro_torch.planner.service import default_service
    svc = default_service()
    out = []
    for i, (a, n) in enumerate(axes):
        if n <= 1:
            continue
        resp = svc.get_axis_executable(a, n, size_floats,
                                       level=axis_level(i),
                                       params=cfg.params)
        sched = resp.schedule
        if cfg.guard:
            sched = guard_schedule(sched,
                                   telemetry=getattr(svc, "telemetry", None))
        out.append(AxisPlan(a, "plan", schedule=sched,
                            predicted=resp.predicted_time))
    return out
