"""The command lines over a process mesh (gloo on the CPU, smoke size):
`launch.serve --nproc 4 --backend gloo` (every rank's self-check, rank 0
serving) and `launch.train --nproc 2 --backend gloo` with `--ckpt-dir`
and `--faults` (each rank's member of the final checkpoint, LATEST
written once every member has landed, the plan armed on every rank)."""
import os
import sys

from repro_torch.launch import serve, train
from repro_torch.runtime.faults import ENV_VAR


def test_serve_cli_on_processes(monkeypatch, capfd):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--smoke", "--device", "cpu", "--nproc", "4",
        "--backend", "gloo", "--batch", "2", "--max-new", "4"])
    serve.main()
    out = capfd.readouterr().out
    assert "process mesh: 4 processes, backend gloo, device cpu" in out
    assert "on 4 processes (gloo, cpu)" in out
    assert "served batch=2 prompt=32 new=4" in out
    errs = out.split("self-check rel err by rank: ")[1].splitlines()[0]
    assert len(errs.split(", ")) == 4
    assert all(float(e) < 1e-5 for e in errs.split(", "))


def test_train_cli_with_checkpoints_and_faults_on_processes(
        monkeypatch, capfd, tmp_path):
    monkeypatch.delenv(ENV_VAR, raising=False)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(sys, "argv", [
        "train", "--engine", "manual", "--sync", "plan", "--smoke",
        "--device", "cpu", "--nproc", "2", "--backend", "gloo",
        "--steps", "3", "--seq-len", "16", "--ckpt-dir", str(ckpt),
        "--faults", "seed=1,steps=3,delay=0,payload_corrupt=0"])
    train.main()
    out = capfd.readouterr().out
    assert "process mesh: 2 processes, backend gloo" in out
    assert "chaos: armed fault plan" in out
    assert "checkpoint: step 3" in out
    assert "final loss:" in out
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000003"]
    assert (ckpt / "LATEST").read_text() == "step_00000003"
    assert sorted(os.listdir(ckpt / "step_00000003")) == [
        "rank_00000", "rank_00001"]
