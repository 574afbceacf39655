"""The port's bucketed ZeRO-3 step against the reference's
`make_manual_train_step` on its bucketed path, on a plain 8-device
`Mesh`, from the same weights (`convert.params_from_jax`) and the same
`SyntheticLM` batches, with `SyncConfig(strategy="plan",
params=PAPER_TABLE5)` on both sides:

- f32 with bucket_bytes pinned to `BUCKETED["float32"]`, so that the
  smoke model's 12 leaves fall into several buckets of both halves: the
  per-step loss and gnorm within 1e-5 relative and the state after 3
  steps as `test_torch_train_f32.py` holds it, with one
  `fused_reduce_into` launch per fold phase of each bucket's gather and
  scatter;
- bf16 at the default, GenModel-chosen bucket (bucket_bytes None): the
  shards exactly, the per-step loss and gnorm within 5e-3 relative.

The reference runs in `test_torch_train.py`'s subprocess (its
"bucketed/<dtype>" parts), whose docstring states the tolerances. The
port's bucketed f32 steps equal its per-leaf steps bit for bit, and
the scatter issues its buckets last first under `backward_overlap`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.trace import Tracer, set_default_tracer

from test_torch_train import (BUCKETED, DATA, LR, N, STEPS,  # noqa: F401
                              _api, _leaves, _np, _params, check_shards,
                              check_steps, few_threads, inputs, port_run,
                              run_reference)

SYNC = {dtype: SyncConfig(strategy="plan", bucket_bytes=b,
                          params=PAPER_TABLE5)
        for dtype, b in BUCKETED.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs,
                         ("bucketed/float32", "bucketed/bfloat16"))


@pytest.fixture(scope="module")
def runs(ref):
    return {dtype: port_run(ref, dtype, SYNC[dtype], prefix="bucketed")
            for dtype in BUCKETED}


def test_bucketed_f32_steps_match_reference(ref, runs):
    step = runs["float32"]["step"]
    assert len(step.scatter_buckets) >= 3 and len(step.gather_buckets) >= 3
    check_steps(ref, runs["float32"], "float32", prefix="bucketed")


def test_bucketed_f32_state_after_three_steps_matches_reference(ref, runs):
    state = runs["float32"]["state"]
    for what, got in (("params", state["params"]),
                      ("opt/m", state["opt"]["m"]),
                      ("opt/v", state["opt"]["v"])):
        want = _leaves(ref, f"bucketed/float32/final/{what}")
        for t, w in zip(got, want, strict=True):
            assert t.shape == w.shape
            tol = 1e-5 * np.abs(w).max()
            if what == "params":
                tol += 1e-3 * STEPS * LR
            assert np.abs(_np(t) - w).max() <= tol, what


def test_bf16_default_plan_matches_reference(ref, runs):
    check_shards(ref, "bfloat16", prefix="bucketed")
    bp = runs["bfloat16"]["step"].bucket_plan
    assert bp is not None and bp.num_buckets == 1
    check_steps(ref, runs["bfloat16"], "bfloat16", prefix="bucketed")


@pytest.mark.parametrize("dtype", list(BUCKETED))
def test_one_launch_per_fold_phase_of_each_bucket(runs, dtype):
    """Each gather bucket's all-gather and each scatter bucket's
    reduce-scatter launch one gathered reduce per fold phase of the
    schedule's halves, and the step calls no other kernel wrapper."""
    run = runs[dtype]
    step = run["step"]
    (plan,) = step.plans
    cs = plan.schedule
    assert plan.schedule is step.bucket_plan.axis_plans[0].schedule
    rs = sum(len(st.folds) for st in cs.rs + ([cs.reorder]
                                              if cs.reorder else []))
    ag = sum(len(st.folds) for st in ([cs.unorder] if cs.unorder else [])
             + cs.ag)
    want = STEPS * (len(step.gather_buckets) * ag
                    + len(step.scatter_buckets) * rs)
    assert run["counts"] == {"fused_reduce_into": want}
    assert plan.schedule.stats == {"launches": STEPS * (
        len(step.gather_buckets) + len(step.scatter_buckets)),
        "failures": 0}


def _steps_of(sync, ref, dtype="float32", steps=2):
    shards = train.shard_params_zero3(
        _params(ref, f"bucketed/{dtype}/init", getattr(torch, dtype)), N)
    state = {"params": shards, "opt": adamw_init(shards)}
    step = train.make_manual_train_step(_api("stablelm-12b"), N,
                                        AdamWConfig(lr=LR), sync=sync,
                                        device="cpu",
                                        param_dtype=getattr(torch, dtype))
    data = SyntheticLM(DataConfig(**DATA))
    out = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch_at(s).items()}
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["gnorm"])))
    return step, state, out


def test_bucketed_equals_per_leaf_bit_for_bit(ref, runs):
    """Same folds in the same order a block: the bucketed f32 step and
    the per-leaf step give the same state."""
    _, state, out = _steps_of(dataclasses.replace(SYNC["float32"],
                                                  bucket_bytes=0), ref,
                              steps=STEPS)
    assert out == list(zip(runs["float32"]["losses"],
                           runs["float32"]["gnorms"]))
    for a, b in zip(state["params"], runs["float32"]["state"]["params"],
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [True, False])
def test_scatter_issue_order_follows_backward_overlap(ref, overlap):
    tracer = Tracer(enabled=True)
    prev = set_default_tracer(tracer)
    try:
        step, _, _ = _steps_of(dataclasses.replace(
            SYNC["float32"], backward_overlap=overlap), ref, steps=1)
    finally:
        set_default_tracer(prev)
    k = len(step.scatter_buckets)
    rs = [sp.args["bucket"] for sp in tracer.spans
          if sp.name == "bucket/zero3_rs"]
    ag = [sp.args["bucket"] for sp in tracer.spans
          if sp.name == "bucket/zero3_ag"]
    assert rs == (list(range(k - 1, -1, -1)) if overlap else list(range(k)))
    assert ag == list(range(len(step.gather_buckets)))


def test_lossy_wire_in_the_trainer_raises():
    for sync in (SyncConfig(strategy="plan", precision="fp8",
                            params=PAPER_TABLE5),
                 SyncConfig(strategy="plan", bucket_bytes=1 << 15,
                            precision="int8", params=PAPER_TABLE5)):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
            train.make_manual_train_step(_api("stablelm-12b"), N,
                                         sync=sync, device="cpu")


def test_a_clamped_precision_trains_at_full_precision():
    """fp8 beyond the caller's tolerance clamps to f32: no wire, no
    refusal."""
    step = train.make_manual_train_step(
        _api("stablelm-12b"), N, sync=SyncConfig(
            strategy="plan", precision="fp8", tolerance=1e-4,
            params=PAPER_TABLE5), device="cpu")
    assert step.bucket_plan.precision == "f32"
    assert step.plans[0].schedule.wire is None


def test_fallback_to_per_leaf_is_logged(monkeypatch, caplog):
    """Where the reference's bucket_plan_for returns None (a plan that
    does not lower), the step takes the per-leaf path, says so, and
    records no bucket plan."""
    from repro_torch.core.lower import LoweringError
    from repro_torch.planner.service import PlannerService

    def fail(self, *a, **k):
        raise LoweringError("no block annotations")
    monkeypatch.setattr(PlannerService, "get_bucket_plan", fail)
    with caplog.at_level("WARNING", logger="repro_torch.launch.train"):
        step = train.make_manual_train_step(_api("stablelm-12b"), N,
                                            sync=SYNC["bfloat16"],
                                            device="cpu")
    assert step.bucket_plan is None and step.scatter_buckets == []
    assert "per-leaf" in caplog.text and "no block annotations" in caplog.text
    (plan,) = step.plans
    assert plan.schedule.blocks_per_shard == 1


def test_state_of_another_dtype_is_refused(ref):
    step = train.make_manual_train_step(_api("stablelm-12b"), N,
                                        sync=SYNC["float32"], device="cpu",
                                        param_dtype=torch.bfloat16)
    shards = train.shard_params_zero3(
        _params(ref, "bucketed/float32/init"), N)
    with pytest.raises(ValueError, match="priced for"):
        step({"params": shards, "opt": adamw_init(shards)}, {})


def test_unequal_gathered_rows_are_refused_bucket_by_bucket(monkeypatch,
                                                            ref):
    from repro_torch.core.lower import CompiledSchedule
    real = CompiledSchedule.run_local_all_gather

    def skewed(self, S):
        full = real(self, S).clone()
        full[-1, 0] += 1.0
        return full
    monkeypatch.setattr(CompiledSchedule, "run_local_all_gather", skewed)
    with pytest.raises(RuntimeError, match="gathered rows"):
        _steps_of(SYNC["float32"], ref, steps=1)


def test_run_training_takes_the_bucketed_default():
    logs = []
    out = train.run_training(
        train.TrainConfig(steps=2, seq_len=16, engine="manual", sync="plan",
                          device="cpu", log_every=1), on_log=logs.append)
    bp = out["bucket_plan"]
    assert bp is not None and bp.num_buckets == 1
    (plan,) = out["plans"]
    assert plan.schedule is bp.axis_plans[0].schedule
    assert any(line.startswith("planner: bucket plan") for line in logs)
    assert all(np.isfinite(out["losses"]))
