"""The auto engine with one process a rank (a process mesh over gloo on the
CPU) against the JAX package's auto engine and the port's one-device run.

One fixture runs, side by side, one JAX subprocess (`_auto_ref.CHILD`:
the reference's `make_train_step` on a plain (4, 1) `jax.sharding.Mesh`
and on (2, 2, 1) as ("pod", "data", "model"), 3 steps from its own
init) and one launch of 4 processes (`_dist_workers.auto_worker`, with a
deadline) that train `_dist_workers.AUTO_RUNS` from that init: the
smoke stablelm-12b with FSDP in f32 and bf16, ZeRO-1, on ("pod", 2) ×
("data", 2), and on a batch whose mask zeroes most of rank 0's rows;
the smoke deepseek-moe-16b at its 16 dispatch groups (each rank's
tokens whole groups), at `moe_groups=0` (one global block whose
capacity binds: the ranks gather their tokens) and `moe_local`. The
same runs on one device, in this process at the ranks' one torch
thread, are what the ranks must equal. The workers also run the
reference's `test_manual_engines_match_auto` over the processes and a
checkpoint restart.

Tolerances: against the reference, f32 within 1e-5 and bf16 within
5e-3 relative at every step (`test_torch_train.py`'s STEP_TOL); against
the port's one-device run within 1e-5 relative in f32 (the ranks sum
their shares of the loss, the norm and the gradients in another order),
the final parameters within 1e-4 of each leaf's largest |value|
(PARAM_TOL, and why);
the manual per-leaf "plan" engine within 5e-2 of the auto engine after
8 steps, the reference's bar.
"""
import numpy as np
import pytest
import torch

import _auto_ref as R
import _dist_workers as W
from repro_torch.core.transport import Line, ProcessMesh
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.launch import train

TIMEOUT_S = 300
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
ONE_TOL = 1e-5
# the final parameters against the one-device run's, relative to each
# leaf's largest |value|: AdamW divides each gradient element by its own
# running RMS, so an element whose gradient is near zero (an embedding
# row of a rare token) turns a summation-order difference of 1e-7 into
# a part of its step (lr 1e-3); measured 2.5e-5 on one element of 32,768
PARAM_TOL = 1e-4
MANUAL_TOL = 5e-2
RUNS = {r[0]: r for r in W.AUTO_RUNS}


def _inputs() -> dict:
    """The explicit batches, as `run_training`'s pipeline makes them
    (integers as int32 for both sides); "masked" keeps 8 of rank 0's 64
    labels and all of the others'."""
    out = {}
    for bkey, arch, ov in (("dense", "stablelm-12b", W.WIDE),
                           ("moe", "deepseek-moe-16b", {})):
        cfg = W.auto_api(arch, ov).cfg
        data = SyntheticLM(train.data_config(cfg, W.AUTO_SEQ, W.AUTO_BATCH))
        for s in range(W.AUTO_STEPS):
            b = {k: v.astype(np.int32) if v.dtype.kind == "i" else v
                 for k, v in data.batch_at(s).items()}
            for k, v in b.items():
                out[f"batch/{bkey}/{s}/{k}"] = v
            if bkey == "dense":
                mask = np.ones((W.AUTO_BATCH, W.AUTO_SEQ), np.float32)
                mask[:W.AUTO_BATCH // 4, 4:] = 0.0
                for k, v in {**b, "mask": mask}.items():
                    out[f"batch/masked/{s}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the ranks' results, the one-device runs
    by label, the inputs)."""
    d = tmp_path_factory.mktemp("dist_auto")
    inputs = _inputs()
    np.savez(d / "batches.npz", **inputs)
    child, init_path, out_path = R.spawn(
        d, "ref", W.AUTO_RUNS, d / "batches.npz", lr=W.AUTO_LR,
        steps=W.AUTO_STEPS)
    try:
        inputs.update(R.wait_init(child, init_path))
        ranks = M.launch(W.auto_worker, 4, backend="gloo", device="cpu",
                         timeout_s=TIMEOUT_S, threads=1,
                         args=(str(init_path), str(d / "batches.npz"),
                               str(d / "ckpt")))
        before = torch.get_num_threads()
        torch.set_num_threads(1)        # the ranks' thread count
        try:
            one = {label: W.auto_steps(None, inputs, label, arch, dtype,
                                       fsdp, ov, bkey)
                   for label, arch, dtype, _, fsdp, ov, bkey in W.AUTO_RUNS}
        finally:
            torch.set_num_threads(before)
        ref = R.finish(child, out_path)
    finally:
        if child.poll() is None:
            child.kill()
    return ref, ranks, one, inputs


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("label", list(RUNS))
def test_ranks_match_the_reference_auto_step(runs, label):
    ref, ranks, _, _ = runs
    dtype = RUNS[label][2]
    for res in ranks:
        got = res[label]
        np.testing.assert_allclose(got["losses"], ref[f"{label}/losses"],
                                   rtol=STEP_TOL[dtype], atol=0)
        np.testing.assert_allclose(got["gnorms"], ref[f"{label}/gnorms"],
                                   rtol=STEP_TOL[dtype], atol=0)
    assert ranks[0][label]["losses"][-1] < ranks[0][label]["losses"][0]


@pytest.mark.parametrize("label", [k for k, r in RUNS.items()
                                   if r[2] == "float32" and k != "moe-local"])
def test_ranks_match_the_one_device_run(runs, label):
    """Every rank's losses and gnorms are the one-device run's within
    1e-5, and its local tensors of the final parameters are its slice of
    each leaf at the leaf's placement within PARAM_TOL. (Not `moe_local`:
    the reference's dispatch sorts each DP shard's tokens alone, so on
    four devices it is another function than on one.)"""
    _, ranks, one, _ = runs
    want = one[label]
    axes = W.AUTO_AXES[RUNS[label][3]]
    sizes = [s for _, s in axes]
    for r, res in enumerate(ranks):
        got = res[label]
        assert _rel(got["losses"], want["losses"]) <= ONE_TOL
        assert _rel(got["gnorms"], want["gnorms"]) <= ONE_TOL
        coords = M.coords_of(r, sizes)
        for p, w, pl in zip(got["params"], want["params"], got["placements"]):
            for c, n, spec in zip(coords, sizes, pl):
                if spec.startswith("Shard"):
                    dim = int(spec[spec.index("dim=") + 4:].rstrip(")"))
                    size = w.shape[dim] // n
                    w = w.narrow(dim, c * size, size)
            assert p.shape == w.shape
            assert _rel(p, w) <= PARAM_TOL


def test_fsdp_and_zero1_placements(runs):
    """FSDP shards the large leaves over "data": the widened embedding
    (4,096, 64) and head (64, 4,096) on dim 1, as the reference's rule
    skips dim 0 of every leaf of two dims or more; ZeRO-1 replicates every
    parameter, its moments sharded as FSDP's (`sharding.opt_specs`)."""
    _, ranks, _, _ = runs
    fsdp = ranks[0]["dense-fsdp"]["placements"]
    assert sorted(pl for pl in fsdp if pl != ("Replicate()",)) == [
        ("Shard(dim=1)",), ("Shard(dim=1)",)]
    zero1 = ranks[0]["dense-zero1"]
    assert all(pl == ("Replicate()",) for pl in zero1["placements"])
    assert zero1["moment_placements"] == fsdp
    pod = ranks[0]["dense-pod"]["placements"]
    assert all(pl[0] == "Replicate()" for pl in pod)      # pod: pure DP
    assert any(pl[1].startswith("Shard") for pl in pod)


def test_masked_batch_is_the_global_masked_mean(runs):
    """Rank 0 keeps 8 of its 64 labels: the loss is the global masked
    mean (the reference's), and the mean of the ranks' means would miss
    it by more than ten times the tolerance."""
    ref, ranks, one, inputs = runs
    got = ranks[0]["dense-mask"]["losses"][0]
    api = W.auto_api("stablelm-12b", W.WIDE)
    batch = W.auto_batch(inputs, "masked", 0)
    with torch.no_grad():
        params = W.auto_init(inputs, "dense-mask", "float32")
        means = [float(api.loss_fn(params, train._rank_batch(batch, r, 4)))
                 for r in range(4)]
    mean_of_means = float(np.mean(means))
    assert abs(got - ref["dense-mask/losses"][0]) <= 1e-5 * abs(got)
    assert abs(mean_of_means - got) > 10 * 1e-5 * abs(got)


def test_capacity_binds_and_the_dispatch_is_global(runs, monkeypatch):
    """At `moe_groups=0` the routing of the global 256 tokens drops slots
    (one block, capacity from the global count); the ranks gather their
    tokens and match the one-device run, where a rank-local dispatch
    (each rank's 64 tokens as its own block) would miss by far more."""
    from repro_torch.models import layers
    _, ranks, one, inputs = runs
    api = W.auto_api("deepseek-moe-16b", {"moe_groups": 0})
    seen = []
    real = layers.moe_route

    def spy(p, xt, k):
        out = real(p, xt, k)
        seen.append(out[2])
        return out
    monkeypatch.setattr(layers, "moe_route", spy)
    with torch.no_grad():
        api.loss_fn(W.auto_init(inputs, "moe-global", "float32"),
                    W.auto_batch(inputs, "moe", 0), remat=False)
    assert seen and seen[0].shape[0] == W.AUTO_BATCH * W.AUTO_SEQ
    assert sum(layers.moe_drops(t, api.cfg) for t in seen) > 0
    want = one["moe-global"]["losses"][0]
    assert _rel(ranks[0]["moe-global"]["losses"][0], want) <= ONE_TOL
    local = ranks[0]["moe-global-local-dispatch"]
    assert abs(local - want) > 10 * ONE_TOL * abs(want)


def test_gather_c10d_equals_dtensors_own_gather(runs):
    """The gather the auto engine issues over gloo with CUDA tensors
    (`train.gather_c10d`) equals DTensor's own Shard → Replicate and the
    whole leaf, at every placement of a (6, 8, 4) leaf that splits it
    evenly on ("data", 4) (2) and on ("pod", 2) × ("data", 2) (14)."""
    _, ranks, _, _ = runs
    for res in ranks:
        cases = res["gather_c10d"]
        assert len(cases) == 2 + 14 and all(ok for *_, ok in cases)


def test_device_mesh_of_a_process_mesh(runs):
    _, ranks, _, _ = runs
    for r, res in enumerate(ranks):
        assert res["device_mesh"] == (("pod", "data"), (2, 2),
                                      M.coords_of(r, [2, 2]))


def test_manual_engine_matches_auto_over_processes(runs):
    """The reference's `test_manual_engines_match_auto` (rwkv6-1.6b, 8
    steps) with the manual engine's per-leaf "plan" step, both over the
    4 processes."""
    _, ranks, _, _ = runs
    eng = ranks[0]["engines"]
    assert len(eng["auto"]) == len(eng["manual"]) == 8
    assert abs(eng["manual"][-1] - eng["auto"][-1]) < MANUAL_TOL
    assert all(res["engines"] == eng for res in ranks)


def test_checkpoint_restart_over_processes_replays_exactly(runs):
    """4 steps at once, or 2 and then a resumed run from the same
    directory (each rank restoring its DTensors' local tensors in
    place): the same last loss."""
    _, ranks, _, _ = runs
    ck = ranks[0]["ckpt"]
    assert ck["part"][1] == [0, 1] and ck["resumed"][1] == [2, 3]
    assert ck["resumed"][0][-1] == pytest.approx(ck["full"][0][-1],
                                                 rel=1e-5)
    assert all(res["ckpt"] == ck for res in ranks)


def _fake_mesh(axes):
    """A ProcessMesh of no process group, its data-parallel line named:
    what is refused is refused before any collective."""
    dp = tuple(a for a, _ in axes if a != "model")
    n = int(np.prod([s for a, s in axes if a != "model"]))
    return ProcessMesh(axes=tuple(axes), rank=0, coords=(0,) * len(axes),
                       backend="gloo", device=torch.device("cpu"),
                       lines={dp: Line(None, tuple(range(n)), 0)})


def test_model_axis_above_one_raises_item_8f():
    """A "model" axis above 1 trains over a process mesh since item 8f.1
    (`test_torch_dist_tp.py`); what still raises is the local mesh's
    (axis, size) pairs under a "model" axis: the auto engine's ranks are
    processes, and a local mesh holds them as rows of one device's
    tensors."""
    api = W.auto_api("stablelm-12b", {})
    local = (("data", 2), ("model", 2))
    with pytest.raises(ValueError, match="local mesh"):
        train.make_train_step(api, local)
    tc = train.TrainConfig(steps=1, device="cpu")
    with pytest.raises(ValueError, match="local mesh"):
        train.run_training(tc, mesh=local, on_log=lambda *_: None)


def test_ep_dispatch_under_the_auto_context_raises_item_8f():
    from repro_torch.models import actsharding, layers
    api = W.auto_api("deepseek-moe-16b", {})
    gen = torch.Generator().manual_seed(0)
    lp = api.init_params(gen, torch.float32, "cpu")["layers"][0]["moe"]
    x = torch.randn(2, 4, api.cfg.d_model)
    actsharding.set_hook(None, _fake_mesh((("data", 4),)))
    try:
        with pytest.raises(NotImplementedError, match="item 8f"):
            layers.moe(lp, x, api.cfg, dispatch="ep")
    finally:
        actsharding.set_hook(None)
