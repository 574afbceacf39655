"""The auto engine on one device (`launch.train.make_train_step` with no
mesh, `run_training(TrainConfig(engine="auto"))`, the CLI's default
engine) against the JAX package's auto engine, on the CPU at smoke size.

Three JAX subprocesses run side by side (`_auto_ref.CHILD`: the
reference's `make_train_step` on a plain one-device (1, 1)
`jax.sharding.Mesh`, never `jax.make_mesh`), two families each, f32 and
bf16, 3 steps from the reference's own init, which the port's runs take
through `convert.params_from_jax` (bf16 crosses exactly, a MoE router
stays f32). Both sides read the same explicit batches, made here with
the port's `SyntheticLM` as `run_training` builds it (the audio batch
keeps its tokens, as `test_torch_family_train.py` feeds it).

Tolerances: losses and gnorms at every step, f32 within 1e-5 and bf16
within 5e-3 relative (`test_torch_train.py`'s STEP_TOL, and its
reasons), but the MoE model's bf16 gnorms within 1e-1
(BF16_MOE_GNORM_TOL, and why). Then the counterparts of the reference's
`test_auto_engine_loss_decreases` and `test_ckpt_restart_replays_exactly`
(`tests/test_train.py`), the CLI, and the contracts: no kernel wrapper
launches during an auto step, the activation hook is installed only
within a step, and the batch check raises on the global batch.
"""
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _auto_ref as R
import _dist_workers as W
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import actsharding

FAMILIES = ["stablelm-12b", "deepseek-moe-16b", "rwkv6-1.6b", "hymba-1.5b",
            "qwen2-vl-7b", "whisper-large-v3"]
DTYPES = ["float32", "bfloat16"]
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# the MoE model's bf16 gnorms: its top-k routes some tokens otherwise in
# bf16 on either side, and after two updates the routed sets part (the
# bar and the reason of mixtral's in `test_torch_family_train.py`);
# measured 3.9e-2 at step 3, the losses within 5e-3 throughout
BF16_MOE_GNORM_TOL = 1e-1
RUNS = [(f"{a}/{d}", a, d, "1x1", True, {}, a)
        for a in FAMILIES for d in DTYPES]
# two families a subprocess, three side by side
CHILDREN = [RUNS[i:i + 4] for i in range(0, len(RUNS), 4)]


def _inputs() -> dict:
    out = {}
    for arch in FAMILIES:
        cfg = W.auto_api(arch, {}).cfg
        data = SyntheticLM(train.data_config(cfg, W.AUTO_SEQ, W.AUTO_BATCH))
        for s in range(W.AUTO_STEPS):
            for k, v in data.batch_at(s).items():
                out[f"batch/{arch}/{s}/{k}"] = (
                    v.astype(np.int32) if v.dtype.kind == "i" else v)
    return out


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs (the JAX subprocesses
    run beside it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's runs by label)."""
    d = tmp_path_factory.mktemp("auto_train")
    inputs = _inputs()
    np.savez(d / "batches.npz", **inputs)
    jobs = [R.spawn(d, f"ref{i}", runs, d / "batches.npz", lr=W.AUTO_LR,
                    steps=W.AUTO_STEPS) for i, runs in enumerate(CHILDREN)]
    ref, port = {}, {}
    try:
        for (proc, init, out), runs in zip(jobs, CHILDREN):
            inputs.update(R.wait_init(proc, init))
            for label, arch, dtype, _, fsdp, ov, bkey in runs:
                port[label] = W.auto_steps(None, inputs, label, arch, dtype,
                                           fsdp, ov, bkey)
        for proc, _, out in jobs:
            ref.update(R.finish(proc, out))
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
    return ref, port


@pytest.mark.parametrize("label", [r[0] for r in RUNS])
def test_one_device_matches_the_reference_auto_step(runs, label):
    ref, port = runs
    dtype = label.split("/")[1]
    got = port[label]
    np.testing.assert_allclose(got["losses"], ref[f"{label}/losses"],
                               rtol=STEP_TOL[dtype], atol=0)
    moe_bf16 = label == "deepseek-moe-16b/bfloat16"
    np.testing.assert_allclose(got["gnorms"], ref[f"{label}/gnorms"],
                               rtol=BF16_MOE_GNORM_TOL if moe_bf16
                               else STEP_TOL[dtype], atol=0)
    assert all(set(pl) == {"Replicate()"} for pl in got["placements"])


def test_auto_engine_loss_decreases():
    out = train.run_training(train.TrainConfig(
        arch="stablelm-12b", steps=30, seq_len=64, global_batch=4,
        lr=3e-3, log_every=1000, device="cpu"), on_log=lambda *_: None)
    losses = out["losses"]
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_ckpt_restart_replays_exactly(tmp_path):
    tc = dict(arch="stablelm-12b", steps=20, seq_len=32, global_batch=2,
              lr=1e-3, ckpt_every=10, log_every=1000, device="cpu")

    def run(steps, name):
        return train.run_training(train.TrainConfig(
            **{**tc, "steps": steps}, ckpt_dir=str(tmp_path / name)),
            on_log=lambda *_: None)
    full = run(20, "full")
    run(10, "part")
    resumed = run(20, "part")
    assert resumed["steps"] == list(range(10, 20))
    assert resumed["losses"][-1] == pytest.approx(full["losses"][-1],
                                                  rel=1e-5)


def test_cli_trains_with_the_default_engine(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--engine", "auto", "--smoke", "--device", "cpu",
        "--steps", "2", "--seq-len", "16"])
    train.main()
    out = capsys.readouterr().out
    assert "auto engine: one device (cpu)" in out
    assert "step     0" in out and "final loss:" in out
    assert "planner" not in out


def test_auto_step_launches_no_kernel_and_uninstalls_its_hook():
    """`ops.LAUNCHES` does not move across an auto step (the training
    forward runs no kernel wrapper), and the activation hook and mesh
    context are installed only within a step, so serving and the manual
    engine run with `constrain` the identity."""
    api = W.auto_api("deepseek-moe-16b", {})
    step, state_pl, batch_pl = train.make_train_step(api, None,
                                                     device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = train.place_state(api.init_params(gen, torch.float32, "cpu"),
                              None, step.placements)
    data = SyntheticLM(train.data_config(api.cfg, 16, 2))
    batch = train.batch_tensors(data.batch_at(0), "cpu")
    # the reference's P(("data",)) on the one-device mesh: a size-1 dim
    assert batch_pl(batch) == {k: (Shard(0), Replicate()) for k in batch}
    assert all(pl == (Replicate(), Replicate())
               for pl in state_pl([torch.zeros(8, 8)])["params"])
    ops.reset_launches()
    before = dict(ops.LAUNCHES)
    _, m = step(state, batch)
    assert dict(ops.LAUNCHES) == before
    assert np.isfinite(float(m["loss"])) and "events" not in m
    assert actsharding.mesh_ctx() is None
    x = torch.ones(4, 3)
    assert actsharding.constrain(x) is x
    assert int(state["opt"]["step"]) == 1


def test_batch_dp_hook_refuses_the_global_batch():
    hook = actsharding.batch_dp_hook((("data", 4), ("model", 1)), 8)
    x = torch.zeros(2, 5, 3)
    assert hook(x) is x                  # a rank's rows
    with pytest.raises(RuntimeError, match="global batch of 8"):
        hook(torch.zeros(8, 5, 3))
    # one data-parallel rank holds the whole batch by right
    one = actsharding.batch_dp_hook((("data", 1),), 8)
    assert one(torch.zeros(8, 5, 3)).shape == (8, 5, 3)


def test_a_local_mesh_raises():
    api = W.auto_api("stablelm-12b", {})
    for mesh in (4, [("data", 4)]):
        with pytest.raises(ValueError, match="one process a rank"):
            train.make_train_step(api, mesh, device="cpu")
    tc = train.TrainConfig(steps=1, device="cpu")
    with pytest.raises(ValueError, match="one process a rank"):
        train.run_training(tc, mesh=[("pod", 2), ("data", 4)],
                           on_log=lambda *_: None)


def test_dryrun_zero1_and_seqpar_name_item_8f():
    from repro_torch.launch import dryrun
    cfg = W.auto_api("stablelm-12b", {}).cfg
    for v in ("zero1", "seqpar"):
        with pytest.raises(NotImplementedError, match="item 8f"):
            dryrun.apply_variants(cfg, (v,))
