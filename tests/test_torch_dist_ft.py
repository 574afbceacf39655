"""Checkpoints and the fault-tolerant loop with one process a rank (a
process mesh over gloo on the CPU) against the local mesh.

`run_training` with a checkpoint directory on 4 processes
(`tests/_dist_workers.py:ft_worker`, each launch with a deadline), at
smoke size (stablelm-12b, bf16, the bucket pinned to 32 KiB, 12 steps,
a checkpoint every 3), as `tests/test_torch_train_ft.py`'s soak runs it
on the local mesh:

- fault-free, every rank's state and losses equal the 4-rank local
  mesh's rows, and each rank's member of a checkpoint holds its row of
  the local mesh's checkpoint, byte for byte;
- under the soak's fault plan (a delay, a device loss at step 4, a link
  sag and its restore, `file_corrupt` at step 10 — rank 0's member of
  the newest step only — and a device loss at step 11) plus one
  corrupted payload at a guarded launch: every rank fires the same
  faults, makes the same guarded calls, restores the same steps (the
  agreed restore skips the corrupted step on every rank) and ends on
  the fault-free state bit for bit;
- a run of 6 steps resumed to 12 in a fresh launch ends on the
  fault-free state;
- a real (not injected) launch error on one rank alone ends the run
  within the launcher's deadline, naming that rank and its error.
"""
import os
import time

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.checkpoint import tree_flatten
from repro_torch.launch import mesh as M
from repro_torch.runtime.faults import ENV_VAR, FaultPlan

TIMEOUT_S = 300
FAIL_TIMEOUT_S = 90
PART_STEPS = 6
# the soak's step calls that complete, in order: the device loss at 4
# restores step 3; the payload at step 8 restores step 6; the loss at 11
# falls back past the corrupted step 9 to step 6
CHAOS_STEPS = ([0, 1, 2, 3] + [3, 4, 5, 6, 7] + [6, 7, 8, 9, 10]
               + [6, 7, 8, 9, 10, 11])
RESUMES = [3, 6, 6]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the resuming launch's, the local mesh's
    fault-free run, the root directory)."""
    root = tmp_path_factory.mktemp("dist_ft")
    saved = os.environ.pop(ENV_VAR, None)
    try:
        ranks = M.launch(W.ft_worker, 4, backend="gloo", device="cpu",
                         timeout_s=TIMEOUT_S, threads=1,
                         args=(str(root), PART_STEPS))
        resumed = M.launch(W.ft_resume_worker, 4, backend="gloo",
                           device="cpu", timeout_s=TIMEOUT_S, threads=1,
                           args=(str(root),))
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            local = W.ft_run(4, root / "local", FaultPlan())
        finally:
            torch.set_num_threads(before)
    finally:
        if saved is not None:
            os.environ[ENV_VAR] = saved
    return ranks, resumed, local, root


def _leaves(state):
    return tree_flatten(state)[0]


def _rank_state_equals(state, local_state, r: int) -> bool:
    """A rank's state equals row r of the local mesh's: every shard and
    moment its row, the step counter itself."""
    got, want = _leaves(state), _leaves(local_state)
    return len(got) == len(want) and all(
        (g == w if not isinstance(g, torch.Tensor) or g.dim() == 0
         else g.dtype == w.dtype and torch.equal(g, w[r]))
        for g, w in zip(got, want))


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x == y if not isinstance(x, torch.Tensor)
        else x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_fault_free_ranks_equal_the_local_mesh(runs):
    ranks, _, local, _ = runs
    assert local["steps"] == list(range(W.FT_RUN["steps"]))
    assert min(local["buckets"]) >= 3           # several buckets a half
    for r, res in enumerate(ranks):
        clean = res["clean"]
        assert clean["steps"] == local["steps"]
        assert clean["losses"] == local["losses"]
        assert clean["buckets"] == local["buckets"]
        assert _rank_state_equals(clean["state"], local["state"], r), r


def test_every_rank_makes_the_local_meshs_guarded_calls(runs):
    """`check_launch` ordinals count guarded calls: every rank makes the
    same calls as the local mesh (one a bucket a half a step), so a
    payload corruption fails the same call everywhere."""
    ranks, _, local, _ = runs
    assert {res["clean"]["launches"] for res in ranks} \
        == {local["launches"]}
    assert len({res["chaos"]["launches"] for res in ranks}) == 1


def test_chaos_ends_on_the_fault_free_state(runs):
    ranks, _, _, _ = runs
    for r, res in enumerate(ranks):
        clean, chaos = res["clean"], res["chaos"]
        assert chaos["steps"] == CHAOS_STEPS, r
        assert _same(chaos["state"], clean["state"]), r
        want = dict(zip(clean["steps"], clean["losses"]))
        for s, loss in zip(chaos["steps"], chaos["losses"]):
            assert loss == want[s], (r, s)


def test_every_rank_restores_the_same_steps(runs):
    ranks, _, _, _ = runs
    for res in ranks:
        assert res["chaos"]["resumes"] == [
            f"ft: resume {{'step': {s}}}" for s in RESUMES]
        assert res["chaos"]["restarts"] == 3


def test_faults_fire_alike_and_rank_zero_alone_corrupts(runs):
    ranks, _, _, _ = runs
    for r, res in enumerate(ranks):
        chaos = res["chaos"]
        assert chaos["fired"] == {"delay": 1, "device_loss": 2,
                                  "link_degrade": 1, "link_restore": 1,
                                  "file_corrupt": 1, "payload_corrupt": 1}
        d = chaos["delta"]
        assert d["ft_restarts_total"] == 3
        assert d["ckpt_restore_fallbacks_total"] == 1
        assert d["guarded_failures_total"] == 1
        assert d["faults_files_corrupted_total"] == (1 if r == 0 else 0)
        assert chaos["demotions"] == 0


def test_checkpoint_members_hold_the_local_meshs_rows(runs):
    """Each step on disk is one member a rank, no step left half
    written; rank r's arrays are row r of the local mesh's, byte for
    byte (bf16 as its bits)."""
    _, _, _, root = runs
    run, local = root / "clean", root / "local"
    assert sorted(os.listdir(run)) == sorted(os.listdir(local)) == [
        "LATEST", "step_00000009", "step_00000012"]
    assert (run / "LATEST").read_text() == "step_00000012"
    for step in ("step_00000009", "step_00000012"):
        assert sorted(os.listdir(run / step)) == [
            f"rank_{r:05d}" for r in range(4)]
        with np.load(local / step / "arrays.npz") as z:
            want = {k: z[k] for k in z.files}
        for r in range(4):
            with np.load(run / step / f"rank_{r:05d}" / "arrays.npz") as z:
                assert sorted(z.files) == sorted(want)
                for k in z.files:
                    w = want[k] if want[k].ndim == 0 else want[k][r]
                    assert z[k].dtype == w.dtype
                    assert z[k].tobytes() == w.tobytes(), (step, r, k)


def test_resume_in_a_fresh_launch(runs):
    ranks, resumed, _, root = runs
    for r, (res, again) in enumerate(zip(ranks, resumed)):
        assert res["part"]["steps"] == list(range(PART_STEPS))
        assert again["steps"] == list(range(PART_STEPS, W.FT_RUN["steps"]))
        assert again["resumes"] == [f"ft: resume {{'step': {PART_STEPS}}}"]
        assert _same(again["state"], res["clean"]["state"]), r
        assert again["losses"] == res["clean"]["losses"][PART_STEPS:]
    assert sorted(os.listdir(root / "part")) == [
        "LATEST", "step_00000009", "step_00000012"]


def test_one_ranks_own_failure_ends_the_run(tmp_path):
    """A launch error on rank 1 alone is not replayed: it is raised, and
    the launcher ends every rank within its deadline, naming rank 1 and
    its error (the others wait in a collective of the step)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 4 failed") as e:
        M.launch(W.ft_one_rank_fails_worker, 4, backend="gloo",
                 device="cpu", timeout_s=FAIL_TIMEOUT_S, threads=1,
                 args=(str(tmp_path),))
    assert "rank 1's launch failed (simulated)" in str(e.value)
    assert time.monotonic() - t0 < FAIL_TIMEOUT_S


def test_leaf_mismatch_raises_on_every_rank(tmp_path):
    """A checkpoint whose leaves do not fit the tree restored into raises
    `LeafMismatch` on every rank, as on one process, rather than falling
    back to an older step."""
    got = M.launch(W.ckpt_mismatch_worker, 2, backend="gloo",
                   device="cpu", timeout_s=FAIL_TIMEOUT_S, threads=1,
                   args=(str(tmp_path),))
    assert [g[0] for g in got] == ["LeafMismatch"] * 2
    assert all("shape (4,)" in g[1] for g in got)
    assert sorted(os.listdir(tmp_path / "step_00000001")) == [
        "rank_00000", "rank_00001"]
