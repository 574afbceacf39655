"""The port's checkpointed trainer (`run_training` with a checkpoint
directory: `FaultTolerantLoop` over the manual ZeRO-3 step) on the CPU at
smoke size (stablelm-12b, 8 local ranks, bf16, the reference
`run_training`'s defaults):

- the reference's `test_ckpt_restart_replays_exactly` (tests/
  test_train.py): a run interrupted after 10 of 20 steps and resumed
  from its checkpoint ends on the uninterrupted run's loss (equal here;
  the reference holds it to 1e-5 relative);
- the card's soak (`chip_smoke.py` phase `ft`) on the CPU: FT's fault
  plan (a delay, a device loss, a link sag and its restore on root_sw, a
  corrupted newest checkpoint, a second device loss that falls back past
  it) plus one corrupted payload at a guarded launch, with the bucket
  pinned to 32 KiB (several buckets a half): the faulted run ends on the
  fault-free run's state bit for bit;
- against the reference: the reference's `run_training` under FT's plan
  (no payload corruption; the reference would retry that launch) on a
  plain 8-device `Mesh`, in `test_torch_train.py`'s subprocess (its "ft"
  part). The port resumes from the reference's init state, saved by the
  reference as a step-0 checkpoint, runs under the same plan, and takes
  the same steps in the same order; every loss within 5e-3 relative,
  the bf16 step's tolerance of `test_torch_train.py`. Then a checkpoint
  the reference wrote at step 9 is restored into the port's trainer,
  which continues to the reference's losses of steps 9-11 within the
  same tolerance.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import tree_flatten
from repro_torch.launch import train
from repro_torch.planner.service import default_service
from repro_torch.runtime.faults import (ENV_VAR, FaultEvent, FaultInjector,
                                        FaultPlan)
from repro_torch.runtime.metrics import default_metrics

from test_torch_train import (DATA, FT, LR, STEP_TOL,  # noqa: F401
                              few_threads, inputs, run_reference)

SOAK_BUCKET_BYTES = 32768       # chip_smoke.py's TRAIN_SMOKE_BUCKET_BYTES
# the soak's payload corruption hits the gather of bucket 5 in the first
# run of step 8, after 9 completed step calls (0-3, then 3-7 after the
# first device loss): its launch ordinal counts every guarded launch of
# the run before it
SOAK_PAYLOAD_AFTER, SOAK_PAYLOAD_BUCKET = 9, 5
# the soak's step calls that complete, in order: the device loss at 4
# restores step 3; the payload at step 8 restores step 6; the loss at 11
# falls back past the corrupted step 9 to step 6
SOAK_STEPS = ([0, 1, 2, 3] + [3, 4, 5, 6, 7] + [6, 7, 8, 9, 10]
              + [6, 7, 8, 9, 10, 11])
COUNTERS = ("ft_restarts_total", "ckpt_restore_fallbacks_total",
            "guarded_failures_total", "faults_files_corrupted_total")


@pytest.fixture(autouse=True)
def no_ambient_faults(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)


def _plan(extra=()) -> FaultPlan:
    return FaultPlan(seed=7, events=tuple(FaultEvent(*e)
                                          for e in FT["events"]) + extra)


def _config(ckpt_dir, **kw) -> train.TrainConfig:
    return train.TrainConfig(**{
        "arch": "stablelm-12b", "steps": FT["steps"],
        "seq_len": DATA["seq_len"], "global_batch": DATA["global_batch"],
        "lr": LR, "engine": "manual", "sync": "plan", "device": "cpu",
        "ckpt_dir": str(ckpt_dir), "ckpt_every": FT["ckpt_every"],
        "log_every": 1000, **kw})


def _last_by_step(steps, values) -> dict:
    return dict(zip(steps, values))


def _same_state(a: dict, b: dict) -> bool:
    la, _ = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# restart from disk (tests/test_train.py)
# ---------------------------------------------------------------------------
def test_ckpt_restart_replays_exactly(tmp_path):
    tc = dict(steps=20, seq_len=32, global_batch=2, lr=1e-3, ckpt_every=10,
              log_every=1000, engine="manual", sync="plan", device="cpu",
              local_ranks=2)            # a row of the batch a rank
    quiet = lambda *_: None  # noqa: E731
    full = train.run_training(train.TrainConfig(
        **tc, ckpt_dir=str(tmp_path / "full")), on_log=quiet)
    # interrupted run: first do 10 steps, then resume to 20 from disk
    part = train.run_training(train.TrainConfig(
        **{**tc, "steps": 10}, ckpt_dir=str(tmp_path / "part")),
        on_log=quiet)
    resumed = train.run_training(train.TrainConfig(
        **tc, ckpt_dir=str(tmp_path / "part")), on_log=quiet)
    assert part["steps"] == list(range(10))
    assert resumed["steps"] == list(range(10, 20))
    assert resumed["losses"][-1] == pytest.approx(full["losses"][-1],
                                                  rel=1e-5)
    assert resumed["losses"] == full["losses"][10:]
    assert _same_state(resumed["state"], full["state"])
    assert sorted(os.listdir(tmp_path / "part")) == [
        "LATEST", "step_00000010", "step_00000020"]


# ---------------------------------------------------------------------------
# the card's soak, on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    d = tmp_path_factory.mktemp("soak")
    quiet = lambda *_: None  # noqa: E731
    svc = default_service()
    with FaultInjector(FaultPlan()):          # masks any ambient plan
        clean = train.run_training(_config(
            d / "clean", bucket_bytes=SOAK_BUCKET_BYTES), on_log=quiet)
    step = clean["step"]
    launches = len(step.gather_buckets) + len(step.scatter_buckets)
    ordinal = SOAK_PAYLOAD_AFTER * launches + SOAK_PAYLOAD_BUCKET
    plan = _plan((FaultEvent("payload_corrupt", ordinal),))
    before = {k: default_metrics().counter(k).value for k in COUNTERS}
    with FaultInjector(plan) as inj:
        chaos = train.run_training(_config(
            d / "chaos", bucket_bytes=SOAK_BUCKET_BYTES), on_log=quiet)
    delta = {k: default_metrics().counter(k).value - before[k]
             for k in COUNTERS}
    return {"clean": clean, "chaos": chaos, "fired": inj.stats()["fired"],
            "delta": delta, "degraded": svc.degraded()}


def test_soak_ends_on_the_fault_free_state(soak):
    clean, chaos = soak["clean"], soak["chaos"]
    step = clean["step"]                          # several buckets a half
    assert min(len(step.gather_buckets), len(step.scatter_buckets)) >= 3
    assert clean["steps"] == list(range(FT["steps"]))
    assert chaos["steps"] == SOAK_STEPS
    assert _same_state(chaos["state"], clean["state"])
    want = _last_by_step(clean["steps"], clean["losses"])
    got = _last_by_step(chaos["steps"], chaos["losses"])
    assert got == want                            # every step, bit for bit
    # a replayed step repeats its first run's loss exactly
    for s, loss in zip(chaos["steps"], chaos["losses"]):
        assert loss == want[s]


def test_soak_fires_and_survives_every_fault(soak):
    assert soak["fired"] == {"delay": 1, "device_loss": 2,
                             "link_degrade": 1, "link_restore": 1,
                             "file_corrupt": 1, "payload_corrupt": 1}
    delta = soak["delta"]
    assert delta["ft_restarts_total"] == 3
    assert delta["ckpt_restore_fallbacks_total"] == 1
    assert delta["guarded_failures_total"] == 1
    assert delta["faults_files_corrupted_total"] == 1
    assert soak["degraded"] == {}
    (plan,) = soak["chaos"]["plans"]
    assert plan.schedule.demotions == 0
    assert soak["chaos"]["loop"].restarts == 3


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs, ("ft",))


def test_checkpointed_run_matches_reference(ref, tmp_path):
    """From the reference's init (its step-0 checkpoint) under the same
    plan: the same step calls, each loss within the bf16 step
    tolerance, and the plan's faults fired as in the reference."""
    ckpt = tmp_path / "port"
    shutil.copytree(os.path.join(ref["ft/dir"], "init"), ckpt)
    with FaultInjector(_plan()) as inj:
        out = train.run_training(_config(ckpt), on_log=lambda *_: None)
    assert list(ref["ft/steps"]) == out["steps"]
    assert len(ref["ft/losses"]) == len(out["losses"])
    np.testing.assert_allclose(out["losses"], ref["ft/losses"],
                               rtol=STEP_TOL["bfloat16"], atol=0)
    assert sorted(f"{k} {v}" for k, v in inj.stats()["fired"].items()) \
        == list(ref["ft/fired"])


def test_reference_checkpoint_continues_in_the_port(ref, tmp_path):
    """The reference's step-9 checkpoint restored into the port's trainer:
    steps 9-11 give the reference's losses there."""
    ckpt = tmp_path / "from_ref"
    src = os.path.join(ref["ft/dir"], "run")
    assert sorted(d for d in os.listdir(src) if d.startswith("step_")) \
        == ["step_00000009", "step_00000012"]
    shutil.copytree(os.path.join(src, "step_00000009"),
                    ckpt / "step_00000009")
    (ckpt / "LATEST").write_text("step_00000009")
    out = train.run_training(_config(ckpt), on_log=lambda *_: None)
    assert out["steps"] == [9, 10, 11]
    want = _last_by_step(list(ref["ft/steps"]), list(ref["ft/losses"]))
    np.testing.assert_allclose(out["losses"], [want[s] for s in (9, 10, 11)],
                               rtol=STEP_TOL["bfloat16"], atol=0)
    assert out["ckpt"].last_restore["step"] == 9
