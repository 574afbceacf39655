"""The paper's optimality results as checkable predicates (§3.3).

Theorem 1: memory-access lower bound  D_min = (N+1)·S/N  memory ops.
Theorem 2: no plan is simultaneously δ-optimal and ε-optimal when N > w_t.
These are used by property-based tests and by the sync-strategy chooser.
"""
from __future__ import annotations

from .plans import Plan


def delta_lower_bound_mem_ops(n: int, size: float) -> float:
    """Theorem 1: min total memory ops of any AllReduce = (N+1)·S/N."""
    return (n + 1) * size / n


def is_delta_optimal(plan: Plan, rel_tol: float = 1e-6) -> bool:
    """Compares the *parallel* per-server memory cost against Theorem 1's
    (N+1)S/N bound (servers reduce their blocks concurrently)."""
    lb = delta_lower_bound_mem_ops(plan.n, plan.size)
    return plan.max_mem_ops_per_server() <= lb * (1.0 + rel_tol)


def is_epsilon_optimal(plan: Plan, w_t: int) -> bool:
    """ε-optimal ⇔ no step has receive fan-in above the incast threshold."""
    return plan.max_fan_in() <= w_t


def theorem2_holds(plan: Plan, w_t: int) -> bool:
    """No plan may be both δ- and ε-optimal when N > w_t (Theorem 2)."""
    if plan.n <= w_t:
        return True
    return not (is_delta_optimal(plan) and is_epsilon_optimal(plan, w_t))


def mem_ops_with_h_steps(n: int, size: float, h: int) -> float:
    """Eq. (15): T = (N − 1 + 2h)·S/N·δ  — memory ops for h-step reduction."""
    return (n - 1 + 2 * h) * size / n


# ---------------------------------------------------------------------------
# Overlap-adjusted pipeline bounds (DESIGN.md §15)
# ---------------------------------------------------------------------------
def overlap_lower_bound(t_rs: float, t_ag: float, k: int) -> float:
    """Lower bound on any k-bucket RS/AG pipeline, contention included.

    Each steady-state round runs one RS and one AG concurrently; the
    per-link occupancy merge can never price a joint round below
    max(T_RS, T_AG) — a merged round still carries every unit of the
    slower half on its busiest link — so the optimistic
    `bucketing.pipelined_time` (t_joint = max) is a true lower bound for
    EVERY issuance policy, merged or sequential."""
    from .bucketing import pipelined_time
    return pipelined_time(t_rs, t_ag, k)


def overlap_upper_bound(t_rs: float, t_ag: float, k: int) -> float:
    """Upper bound: a joint round never exceeds T_RS + T_AG (sequential
    issuance is always available), so the contended pipeline is at most
    `bucketing.serial_time` — the no-overlap schedule."""
    from .bucketing import serial_time
    return serial_time(t_rs, t_ag, k)


def overlap_certificate(t_rs: float, t_ag: float, k: int,
                        t_contended: float,
                        rel_tol: float = 1e-9) -> dict:
    """Checkable certificate for a contended pipeline quote: the quote
    must be sandwiched between the overlap-adjusted lower bound and the
    sequential upper bound. `gap_ratio` = (quoted − lower) / lower is the
    price of contention — 0 means the links were disjoint enough for the
    optimistic model to be exact. Quoted on `StepPlan` pipeline quotes
    and checked by tests/test_overlap.py."""
    lb = overlap_lower_bound(t_rs, t_ag, k)
    ub = overlap_upper_bound(t_rs, t_ag, k)
    q = float(t_contended)
    slack = rel_tol * max(1.0, lb, ub)
    return {
        "k": int(k), "t_rs": float(t_rs), "t_ag": float(t_ag),
        "lower_bound": float(lb), "upper_bound": float(ub),
        "quoted": q,
        "sandwiched": bool(lb - slack <= q <= ub + slack),
        "gap_ratio": float((q - lb) / lb) if lb > 0 else 0.0,
    }
