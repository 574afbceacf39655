"""The port's calibration against the JAX package's, on the CPU.

- `PlannerService.calibrate` with the `closed_form` and `simulator`
  backends: every level's fitted params within 1e-9 relative of the
  reference service's (w_t equal), the params version bumped, the fitted
  set the pricing basis of every path (axis plans priced as the
  calibrated reference prices them), keys and predictions changed;
- `TorchProvider(device="cpu")`: curves of the configured shapes, no
  kernel launch (the wrappers run their plain versions on the CPU), and
  the CPS schedule it times computes the column sum (1e-6);
- units and sizes: with the clock and the timed calls replaced by the
  exact Fig.-4 and CPS closed-form times, `calibrate_levels(provider=
  TorchProvider("cpu"))` recovers the injected α, β, γ, δ, ε and w_t;
- no fallback: `backend="torch"` without a card raises, and a service
  asked to calibrate on it keeps its params.

Both packages calibrate from `PAPER_TABLE5` (or another source passed to
both).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core.cost_model import GenModelParams as JParams
from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
from repro.core import topology as jtopo
from repro.planner.calibrate import CalibrationConfig as JConfig
from repro.planner.service import PlannerService as JService

from repro_torch.core import topology as ttopo
from repro_torch.core.cost_model import (GPU_AXIS_BASIS, GenModelParams,
                                         PAPER_TABLE5, cost_cps)
from repro_torch.core.lower import CompiledSchedule
from repro_torch.kernels import ops
from repro_torch.planner import calibrate as tcal
from repro_torch.planner.calibrate import (CalibrationConfig, TorchProvider,
                                           calibrate_levels, provider_for,
                                           validate_params)
from repro_torch.planner.service import PlannerService

J_GPU = {k: JParams(**dataclasses.asdict(v))
         for k, v in GPU_AXIS_BASIS.items()}
SOURCES = {"default": (None, None), "table5": (PAPER_TABLE5, J_TABLE5),
           "gpu": (GPU_AXIS_BASIS, J_GPU)}
TERMS = ("alpha", "beta", "gamma", "delta", "epsilon")
# a small sweep for the measured backend on the CPU
SMALL = dict(ns=(2, 3, 4, 5), sizes=(1000.0, 4000.0), fig4_xs=(2, 3, 5),
             fig4_size=3000.0, levels=("root_sw", "server"))


def _close(a, b, rel) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b)) + 1e-300


def _same_params(got, want, rel=1e-9):
    assert sorted(got) == sorted(want)
    for lvl, w in want.items():
        g = got[lvl]
        assert int(g.w_t) == int(w.w_t), lvl
        for t in TERMS:
            assert _close(getattr(g, t), getattr(w, t), rel), (lvl, t)


# ---- PlannerService.calibrate -----------------------------------------------
@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("backend", ["closed_form", "simulator"])
def test_service_calibrate_matches_reference(backend, source):
    tsrc, jsrc = SOURCES[source]
    t, j = PlannerService(), JService()
    topo = ttopo.single_switch(8)
    before = t.get_plan(topo, 1 << 20)
    axis_before = t.get_axis_executable("x", 8, 20480.0)
    version = t._params_version
    assert t.stats()["calibrated"] is False
    got = t.calibrate(tsrc, cfg=CalibrationConfig(backend=backend))
    want = j.calibrate(jsrc, cfg=JConfig(backend=backend))
    assert got.backend == want.backend == backend
    _same_params(got.params, want.params)
    _same_params(t.params, j.params)
    for lvl, s in want.samples.items():
        np.testing.assert_allclose(got.samples[lvl].times, s.times,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.samples[lvl].fig4_times,
                                   s.fig4_times, rtol=1e-12)
    assert t.calibration is got and t.stats()["calibrated"] is True
    assert t._params_version == version + 1
    assert not (t._merged_cache or t._pred_cache or t._shares_cache)
    for lvl, p in t.params.items():
        assert validate_params(p) == [], lvl
    # the fitted set prices full-topology plans as the reference's does;
    # fitted from the GPU testbed, it moves them off PAPER_TABLE5
    after = t.get_plan(topo, 1 << 20)
    jafter = j.get_plan(jtopo.single_switch(8), 1 << 20)
    assert after.key == jafter.key and after.algo == jafter.algo
    assert _close(after.predicted_time, jafter.predicted_time, 1e-9)
    if source == "gpu":
        assert after.key != before.key and after.source == "cold"
        assert after.predicted_time != before.predicted_time
    # the axis basis is the fitted set, no longer GPU_AXIS_BASIS: the
    # port prices the axis as the calibrated reference does
    assert t._effective_axis_params() == t.params
    axis_after = t.get_axis_executable("x", 8, 20480.0)
    jaxis = j.get_axis_executable("x", 8, 20480.0)
    assert axis_after.key == jaxis.key and axis_after.algo == jaxis.algo
    assert _close(axis_after.predicted_time, jaxis.predicted_time, 1e-9)
    if source != "gpu":
        assert axis_after.key != axis_before.key
        assert axis_after.predicted_time != axis_before.predicted_time


def test_calibrate_clears_observe_caches_and_reprices():
    t = PlannerService()
    first = t.observe("root_sw", 8, 20480.0, 1e-3, source="local_mesh")
    assert t._pred_cache
    t.calibrate(cfg=CalibrationConfig(backend="closed_form"))
    assert not t._pred_cache
    second = t.observe("root_sw", 8, 20480.0, 1e-3, source="local_mesh")
    assert second["predicted"] != first["predicted"]
    t_rs, t_ag = t._axis_halves_time(8, "root_sw", 20480.0, "float32",
                                     t.params)
    assert second["predicted"] == pytest.approx(t_rs + t_ag, rel=1e-12)


# ---- TorchProvider on the CPU -----------------------------------------------
def test_torch_provider_on_cpu_gives_curves_without_launches():
    cfg = CalibrationConfig(backend="torch", **SMALL)
    prov = TorchProvider(device="cpu")
    assert prov.name == "torch" and prov.device == torch.device("cpu")
    ops.reset_launches()
    ns, sizes, times = prov.cps_curve("root_sw", PAPER_TABLE5["root_sw"],
                                      cfg)
    xs, f4 = prov.fig4_curve("root_sw", PAPER_TABLE5["root_sw"], cfg)
    assert sum(ops.LAUNCHES.values()) == 0
    cells = len(cfg.ns) * len(cfg.sizes)
    assert ns.shape == sizes.shape == times.shape == (cells,)
    assert ns.tolist() == [float(n) for n in cfg.ns for _ in cfg.sizes]
    assert sizes.tolist() == [s for _ in cfg.ns for s in cfg.sizes]
    assert xs.tolist() == [float(x) for x in cfg.fig4_xs]
    assert f4.shape == (len(cfg.fig4_xs),)
    assert np.isfinite(times).all() and (times > 0).all()
    assert np.isfinite(f4).all() and (f4 > 0).all()
    res = calibrate_levels(None, cfg, provider=prov)
    assert res.backend == "torch" and sorted(res.params) == sorted(
        cfg.levels)
    for lvl, p in res.params.items():
        assert validate_params(p) == [], lvl
    assert sum(ops.LAUNCHES.values()) == 0


def test_local_cps_schedule_is_the_column_sum(monkeypatch):
    seen = []
    real = CompiledSchedule.run_local

    def spy(self, X):
        out = real(self, X)
        seen.append((self.describe(), X.clone(), out.clone()))
        return out

    monkeypatch.setattr(CompiledSchedule, "run_local", spy)
    ns, sizes, _ = tcal.measure_local_cps((3, 4), (1000.0, 257.0),
                                          device="cpu", repeats=3)
    assert ns.tolist() == [3.0, 3.0, 4.0, 4.0]
    assert len(seen) == 4 * (1 + 3)          # a warm-up and 3 timed runs
    for what, X, out in seen:
        assert what.startswith("cps:") and f"n={X.shape[0]} " in what
        want = X.double().sum(dim=0)
        err = float((out.double() - want).abs().max()) / float(
            want.abs().max())
        assert out.shape == X.shape and err <= 1e-6, (what, err)


def test_card_fold_counts_a_warm_up_and_the_repeats(monkeypatch):
    calls = []
    real = ops.fused_reduce

    def spy(parts):
        calls.append(tuple(parts.shape))
        return real(parts)

    monkeypatch.setattr(ops, "fused_reduce", spy)
    times = tcal._measure_card_fold((2, 4), 100.0, device="cpu")
    assert times.shape == (2,)
    assert calls == [(2, 100)] * 6 + [(4, 100)] * 6


# ---- units and sizes, pinned by injected closed-form times ------------------
INJECTED = GenModelParams(alpha=3e-5, beta=2e-10, gamma=5e-11,
                          delta=1.3e-12, epsilon=4e-11, w_t=5)


def test_injected_timings_recover_params(monkeypatch):
    """Each timed call advances a fake clock by its closed-form time at the
    shape it was given: T(x) = (x+1)·S·δ + (x−1)·S·γ for a fold of an
    (x, S) tensor, `cost_cps(n, S)` for an AllReduce of (n, S). The fit
    then recovers the injected params only if the provider times in
    seconds and passes S in floats."""
    p = INJECTED
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    real_fold = ops.fused_reduce

    def fold(parts):
        x, s = parts.shape
        clock[0] += (x + 1) * s * p.delta + (x - 1) * s * p.gamma
        return real_fold(parts)

    def run_local(self, X):
        n, s = X.shape
        clock[0] += cost_cps(n, s, p)
        return X

    monkeypatch.setattr(ops, "fused_reduce", fold)
    monkeypatch.setattr(CompiledSchedule, "run_local", run_local)
    cfg = CalibrationConfig(backend="torch", ns=tuple(range(2, 11)),
                            sizes=(1e4, 4e4, 1.6e5),
                            fig4_xs=tuple(range(2, 10)), fig4_size=2e4,
                            levels=("root_sw", "server"))
    res = calibrate_levels(None, cfg, provider=TorchProvider(device="cpu"))
    for lvl in cfg.levels:
        got = res.params[lvl]
        assert int(got.w_t) == p.w_t, lvl
        for t in TERMS:
            assert _close(getattr(got, t), getattr(p, t), 1e-6), (lvl, t)


# ---- no fallback --------------------------------------------------------------
def test_torch_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CalibrationConfig(backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        provider_for(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchProvider()
    svc = PlannerService()
    version = svc._params_version
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.calibrate(cfg=cfg)
    assert svc.params is None and svc.calibration is None
    assert svc._params_version == version


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        provider_for(CalibrationConfig(backend="lax"))
