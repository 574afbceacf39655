"""Fitting toolkit (paper §3.4): estimate GenModel parameters for a cluster.

The paper fits (α, 2β+γ, δ, ε, w_t) from co-located-PS benchmarks over
2..N communicators, plus the Fig.-4 memory microbenchmark for (δ, γ).
Everything here is plain least squares on numpy — no hardware assumptions —
so it runs on recorded measurements from any cluster (or our simulator).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from .cost_model import GenModelParams, cost_cps


def fit_delta_gamma(xs: np.ndarray, times: np.ndarray, s: float
                    ) -> tuple[float, float]:
    """Fit the Fig.-4 microbenchmark:  T(x) = (x+1)·S·δ + (x−1)·S·γ.

    xs: fan-in degrees; times: measured seconds; s: vector length (units).
    Returns (delta, gamma) per data unit.
    """
    A = np.stack([(xs + 1) * s, (xs - 1) * s], axis=1)
    coef, *_ = np.linalg.lstsq(A, times, rcond=None)
    return float(coef[0]), float(coef[1])


def detect_w_t(xs: np.ndarray, times: np.ndarray,
               rel_jump: float = 0.08) -> int:
    """Detect the incast threshold: the smallest fan-in where the x-to-x
    time departs from its flat plateau by more than `rel_jump` (paper §3.2:
    T(x) = α + Sβ is constant below w_t)."""
    base = float(np.median(times[: max(2, len(times) // 3)]))
    for x, t in zip(xs, times):
        if t > base * (1.0 + rel_jump):
            return int(x)
    return int(xs[-1]) + 1  # no incast observed in range


def fit_epsilon(xs: np.ndarray, times: np.ndarray, s: float, w_t: int,
                beta_alpha_base: float | None = None) -> float:
    """Fit ε from the post-threshold linear growth of x-to-x tests:
    T(x) = (α + Sβ) + max(x − w_t, 0)·S·ε."""
    base = beta_alpha_base
    if base is None:
        mask = xs < w_t
        base = float(np.mean(times[mask])) if mask.any() else float(times[0])
    mask = xs >= w_t
    if not mask.any():
        return 0.0
    excess = (xs[mask] - w_t) * s
    extra = times[mask] - base
    denom = float(np.dot(excess, excess))
    return float(np.dot(excess, extra) / denom) if denom > 0 else 0.0


def _lstsq_cps(ns, sizes, times, w_t):
    col_alpha = np.full_like(ns, 2.0)
    col_bg = 2.0 * (ns - 1) * sizes / ns
    col_delta = (ns + 1) * sizes / ns
    col_eps = 2.0 * (ns - 1) * sizes / ns * np.maximum(ns - w_t, 0.0)
    A = np.stack([col_alpha, col_bg, col_delta, col_eps], axis=1)
    coef, res, *_ = np.linalg.lstsq(A, times, rcond=None)
    pred = A @ coef
    return coef, float(((pred - times) ** 2).sum())


def fit_from_cps_benchmarks(ns: np.ndarray, sizes: np.ndarray,
                            times: np.ndarray,
                            w_t: int | None = None) -> GenModelParams:
    """Fit (α, β, γ, δ, ε) jointly from co-located-PS runs at varying
    (N, S). Uses the Table-2 CPS expression as the design matrix. The β and
    γ coefficients keep a fixed 2:1 ratio (paper: only 2β+γ is identifiable)
    — we report β = (2β+γ)/2·(2/2.5), γ = .5β convention-free by fitting the
    combined column and splitting with the paper's convention γ = β/2·...;
    here we simply expose the combined coefficient through β and set γ via
    the δ microbench when available."""
    ns = np.asarray(ns, dtype=float)
    sizes = np.asarray(sizes, dtype=float)
    times = np.asarray(times, dtype=float)
    if w_t is None:
        # grid-search the threshold: pick the w_t whose piecewise-linear
        # CPS model explains the curve best (robust to interleaved sizes,
        # unlike plateau detection on raw x-to-x times)
        best = None
        for cand in range(2, int(ns.max()) + 1):
            _, resid = _lstsq_cps(ns, sizes, times, cand)
            if best is None or resid < best[1]:
                best = (cand, resid)
        w_t = best[0]
    coef, _ = _lstsq_cps(ns, sizes, times, w_t)
    alpha, bg, delta, eps = [float(max(c, 0.0)) for c in coef]
    # split combined β+γ/2 with the paper's 2:1 coefficient structure:
    beta = bg * 2.0 / 2.5
    gamma = bg / 2.5
    return GenModelParams(alpha=alpha, beta=beta, gamma=gamma,
                          delta=delta, epsilon=eps, w_t=int(w_t))


def fit_params_for_level(base: GenModelParams, **overrides) -> GenModelParams:
    return replace(base, **overrides)


# ---------------------------------------------------------------------------
# Per-term residual attribution — the cost ledger's diagnosis side
# (DESIGN.md §11).  Input: one share vector per observed collective
# (predicted seconds booked under each GenModel term, from
# cost_model.evaluate_plan_terms) plus the measured wall time.  Output:
# per-term multipliers m_t minimizing ||S·m − measured||₂, i.e. the
# uniform per-term scaling that best explains all samples at once.
# m_t == 1 → the term is priced right; m_t == 3 → "δ drifted 3×".
# ---------------------------------------------------------------------------
TERM_NAMES = ("alpha", "beta", "gamma", "delta", "incast")


def attribute_term_drift(shares: list[dict[str, float]],
                         measured: list[float],
                         ) -> dict[str, float | None]:
    """Least-squares per-term drift multipliers over a sample window.

    ``shares[i][t]`` is the predicted seconds sample *i* books under term
    *t*; ``measured[i]`` its wall time.  Terms with zero share across the
    whole window are unidentifiable and map to ``None``.  Needs at least
    one sample; with fewer samples than active terms the minimum-norm
    solution is returned (pinned to the observed directions).
    """
    if len(shares) != len(measured):
        raise ValueError("shares and measured must have equal length")
    if not shares:
        return {t: None for t in TERM_NAMES}
    S = np.array([[float(sh.get(t, 0.0)) for t in TERM_NAMES]
                  for sh in shares], dtype=float)
    y = np.asarray(measured, dtype=float)
    active = S.any(axis=0)
    out: dict[str, float | None] = {t: None for t in TERM_NAMES}
    if not active.any():
        return out
    coef, *_ = np.linalg.lstsq(S[:, active], y, rcond=None)
    for t, m in zip(np.array(TERM_NAMES)[active], coef):
        out[str(t)] = float(m)
    return out


# ---------------------------------------------------------------------------
# Online-measurement normalization (runtime telemetry → the CPS fit)
# ---------------------------------------------------------------------------
def cps_equivalent_time(n: int, size_floats: float, measured: float,
                        plan_predicted: float, p: GenModelParams) -> float:
    """Normalize the measured wall time of an *arbitrary executed plan*
    into the equivalent co-located-PS sample the least-squares path above
    consumes.

    The runtime executes whatever plan GenTree picked — not the CPS
    microbench the Table-2 design matrix describes — so a raw measured
    time cannot enter `fit_from_cps_benchmarks` directly. But the model
    itself prices both: scaling the measurement by the *modeled* ratio
    cost_cps(n, S) / plan_predicted maps "what the executed plan took"
    onto "what the CPS bench would have taken" under the same parameter
    drift. At zero drift the factor round-trips exactly; under drift the
    multiplicative error terms (β, ε) it is designed to recover dominate,
    which is precisely when the refit fires. This keeps ONE fitting
    codepath: offline microbenches and online telemetry samples both run
    through the Table-2 least squares.
    """
    if plan_predicted <= 0.0:
        return float(measured)
    factor = cost_cps(int(n), float(size_floats), p) / float(plan_predicted)
    return float(measured) * factor
