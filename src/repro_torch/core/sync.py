"""Mesh-axis level classes and per-axis plan selection.

The serving slice needs only the JAX-free part of the reference
`core/sync.py`: which Table-5 level class prices each mesh-axis position,
the single-switch stand-in topology an axis is planned on, and the
per-axis plan labels `PlannerService.get_axis_plans` returns. Gradient
synchronization (`SyncConfig`, `sync_gradients`, …) belongs to the
trainer slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .cost_model import GPU_TESTBED, GenModelParams, best_flat_plan


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


# Table-5 class per mesh-axis position: the leaf axis rides the fast
# in-machine fabric ("root_sw" pricing), every outer axis the slower
# between-machine fabric ("cross_dc").
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
    params = params or GPU_TESTBED
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
