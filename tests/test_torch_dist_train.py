"""The manual ZeRO-3 trainer with one process a rank (a process mesh over
gloo on the CPU) against the local mesh and the JAX package's.

One fixture runs, side by side, one JAX subprocess (the reference's
`make_manual_train_step` on a plain 4-device `jax.sharding.Mesh`, sync
"plan" at Table 5: f32 per leaf and bucketed, bf16 per leaf, 3 steps
from its own init) and one launch of 4 processes
(`tests/_dist_workers.py:train_worker`, with a deadline) that train the
smoke stablelm-12b from that init on ("data", 4) per leaf and bucketed
in f32, per leaf in bf16, per leaf on the fp8 wire and at 32 KiB
buckets on the int8 wire, and on ("pod", 2) × ("data", 2) per leaf;
probe each mesh's schedules, time the CPS curve and run `run_training`
as the CLI's ranks do. The same runs on the local mesh, at the ranks'
one torch thread, are what the ranks must equal.

Tolerances: the ranks' losses, gnorms and shards equal the 4-rank local
mesh's exactly (the same arithmetic, rank by rank); against the
reference, f32 within 1e-5 and bf16 within 5e-3 relative at every step
(`test_torch_train.py`'s STEP_TOL, and its reasons).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.core.transport import ProcessMesh
from repro_torch.launch import mesh as M
from repro_torch.launch import train

TIMEOUT_S = 300
STEP_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
REF_RUNS = {label: (dtype, bucket_bytes)
            for label, axes, dtype, bucket_bytes, wire in W.TRAIN_RUNS
            if axes == (("data", 4),) and wire is None}

_CHILD = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.cost_model import PAPER_TABLE5
from repro.core.sync import SyncConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch.train import make_manual_train_step, shard_params_zero3
from repro.models import transformer
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import AdamWConfig, adamw_init

init_path, out_path, spec = sys.argv[1], sys.argv[2], eval(sys.argv[3])
res = {}


def put(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)            # exact
        res[f"{prefix}/{key}"] = a


mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
data = SyntheticLM(DataConfig(**spec["data"]))
cfg = smoke_config(get_config("stablelm-12b"))


def api_of(dtype):
    return dataclasses.replace(
        build(cfg), init_params=lambda key, d=getattr(jnp, dtype):
        transformer.init_params(key, cfg, d))


# the init first, so the port's ranks start while the reference trains
for dtype in sorted({d for d, _ in spec["runs"].values()}):
    put(f"init/{dtype}", api_of(dtype).init_params(jax.random.PRNGKey(0)))
np.savez(init_path + ".tmp.npz", **res)
os.replace(init_path + ".tmp.npz", init_path)
res = {}
for label, (dtype, bucket_bytes) in spec["runs"].items():
    api = api_of(dtype)
    params = api.init_params(jax.random.PRNGKey(0))
    state = {"params": shard_params_zero3(params, mesh),
             "opt": adamw_init(shard_params_zero3(params, mesh))}
    state["opt"] = {k: jax.tree.map(lambda z, p: jax.device_put(
        z, p.sharding), state["opt"][k], state["params"]) for k in ("m", "v")}
    state["opt"]["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                          NamedSharding(mesh, P()))
    step = make_manual_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                                  sync=SyncConfig(strategy="plan",
                                                  bucket_bytes=bucket_bytes,
                                                  params=PAPER_TABLE5))
    losses, gnorms = [], []
    for s in range(spec["steps"]):
        state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(s)))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res[f"{label}/losses"] = np.asarray(losses)
    res[f"{label}/gnorms"] = np.asarray(gnorms)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the ranks' results, the local mesh's
    runs by label)."""
    d = tmp_path_factory.mktemp("dist_train")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr({"data": W.DATA, "lr": W.LR, "steps": W.STEPS,
                 "runs": REF_RUNS})
    init = d / "init.npz"
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(init), str(d / "ref.npz"), spec],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 300
        while not init.exists():
            assert child.poll() is None, child.communicate()[1][-4000:]
            assert time.monotonic() < deadline, "no init from the reference"
            time.sleep(0.2)
        inputs = dict(np.load(init))
        ranks = M.launch(W.train_worker, 4, backend="gloo", device="cpu",
                         timeout_s=TIMEOUT_S, threads=1, args=(str(init),))
        before = torch.get_num_threads()
        torch.set_num_threads(1)        # the ranks' thread count
        try:
            local = {label: W.train_steps(
                4 if len(axes) == 1 else [tuple(a) for a in axes], inputs,
                dtype, bucket_bytes, wire)
                for label, axes, dtype, bucket_bytes, wire in W.TRAIN_RUNS}
        finally:
            torch.set_num_threads(before)
        _, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 0, err[-4000:]
    return dict(np.load(d / "ref.npz")), ranks, local


LABELS = [label for label, *_ in W.TRAIN_RUNS]


@pytest.mark.parametrize("label", LABELS)
def test_ranks_equal_the_local_mesh_trainer(runs, label):
    _, ranks, local = runs
    want = local[label]
    assert want["losses"][-1] < want["losses"][0]
    for r, res in enumerate(ranks):
        got = res[label]
        assert got["losses"] == want["losses"]
        assert got["gnorms"] == want["gnorms"]
        assert got["buckets"] == want["buckets"]
        for s, w in zip(got["shards"], want["shards"]):
            assert torch.equal(s, w[r])


@pytest.mark.parametrize("label", [label for label, *_, wire in
                                   W.TRAIN_RUNS if wire is None])
def test_ranks_gather_the_same_bytes(runs, label):
    """At full precision every rank's gathered copy is the same (under a
    lossy wire each keeps its own: its shard exact, the others
    decoded)."""
    _, ranks, _ = runs
    digests = {res[label]["digest"] for res in ranks}
    assert len(digests) == 1 and None not in digests


@pytest.mark.parametrize("label", list(REF_RUNS))
def test_ranks_match_the_reference_step(runs, label):
    ref, ranks, _ = runs
    dtype = REF_RUNS[label][0]
    got = ranks[0][label]
    np.testing.assert_allclose(got["losses"], ref[f"{label}/losses"],
                               rtol=STEP_TOL[dtype], atol=0)
    np.testing.assert_allclose(got["gnorms"], ref[f"{label}/gnorms"],
                               rtol=STEP_TOL[dtype], atol=0)


def test_bucketed_run_takes_the_bucket_plan(runs):
    _, ranks, _ = runs
    assert ranks[0]["f32-bucketed"]["buckets"] >= 1
    assert ranks[0]["f32-per-leaf"]["buckets"] == 0


@pytest.mark.parametrize("axes", [(("data", 4),),
                                  (("pod", 2), ("data", 2))],
                         ids=["data4", "pod2xdata2"])
def test_sync_probe_observes_each_live_axis_twice(runs, axes):
    _, ranks, _ = runs
    live = [a for a, s in axes if s > 1]
    outs = [res[("probe", axes)] for res in ranks]
    obs, lines = outs[0]
    assert len(obs) == 2 * len(live)
    assert all(o == outs[0][0] for o, _ in outs)   # every rank alike
    assert all(measured > 0 and predicted > 0
               for _, predicted, measured in obs)
    assert len(lines) == len(obs) and "sync probe" in lines[0]


def test_measure_dist_cps_returns_its_triple(runs):
    _, ranks, _ = runs
    ns, sizes, times = ranks[0]["cps"]
    assert ns == [2.0, 2.0, 4.0, 4.0] and sizes == [64.0, 256.0] * 2
    assert all(t > 0 for t in times)
    assert all(res["cps"] == ranks[0]["cps"] for res in ranks)


def test_torch_provider_on_a_process_mesh_times_the_dist_cps(runs):
    _, ranks, _ = runs
    ns, sizes, times = ranks[0]["provider_cps"]
    assert ns == [2.0, 4.0] and sizes == [128.0, 128.0]
    assert all(t > 0 for t in times)
    assert all(res["provider_cps"] == ranks[0]["provider_cps"]
               for res in ranks)


def test_run_training_on_a_process_mesh(runs):
    _, ranks, _ = runs
    losses = [res["run_training"] for res in ranks]
    assert len(losses[0]) == 2 and all(x == losses[0] for x in losses)
    assert np.isfinite(losses[0]).all()


def _fake_mesh(axes=(("data", 4),)):
    """A ProcessMesh of no process group: what is refused is refused
    before any collective."""
    return ProcessMesh(axes=axes, rank=0, coords=(0,) * len(axes),
                       backend="gloo", device=torch.device("cpu"))


def test_moe_expert_parallel_over_a_process_mesh_raises():
    """Item 8b lifted this refusal: the step builds on a process mesh,
    its experts split over the first live axis and its exchange the
    planned all-to-all (tests/test_torch_dist_ep.py trains it over
    processes)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    api = build(smoke_config(get_config("deepseek-moe-16b")))
    assert api.cfg.n_experts % 4 == 0
    step = train.make_manual_train_step(api, _fake_mesh(), device="cpu")
    assert step.ep == ("data", 4)
    assert step.ep_schedule is not None
    assert step.ep_schedule.inner.family == "all_to_all"


@pytest.mark.parametrize("field,value", [("ckpt_dir", "ckpt"),
                                         ("fault_plan", "seed=7,steps=2"),
                                         ("engine", "auto")])
def test_out_of_scope_on_a_process_mesh_raises(field, value, tmp_path):
    """Nothing of these is refused on a process mesh any more: item 8c
    brought checkpoints and fault plans into scope there
    (tests/test_torch_dist_ft.py runs them over processes), item 8d the
    auto engine (tests/test_torch_dist_auto.py trains it over
    processes), whose scope check passes there, on a "model" axis above
    1 too since item 8f.1 (tests/test_torch_dist_tp.py); a local mesh
    under the auto engine raises ValueError."""
    import dataclasses
    tc = dataclasses.replace(train.TrainConfig(
        steps=1, engine="manual", sync="plan", device="cpu"),
        **{field: str(tmp_path / value) if field == "ckpt_dir" else value})
    assert train._check_train_scope(tc, _fake_mesh()) is None
    if field == "engine":
        assert train._check_train_scope(tc, _fake_mesh(
            (("data", 2), ("model", 2)))) is None
        with pytest.raises(ValueError, match="local mesh"):
            train._check_train_scope(tc, (("data", 2), ("model", 2)))


def test_nccl_with_two_ranks_on_one_device_raises():
    with pytest.raises(M.SharedDeviceError, match="--backend gloo"):
        M.rank_devices(2, "nccl", "cuda:0")
    # one named card refuses two ranks whatever the machine's cards
    with pytest.raises(M.SharedDeviceError, match="two ranks on one"):
        M.launch(W.train_worker, 2, backend="nccl", device="cuda:0")
    if torch.cuda.device_count() < 2:
        with pytest.raises(M.SharedDeviceError, match="--backend gloo"):
            M.rank_devices(2, "nccl", "cuda")


def test_cli_with_nccl_and_too_few_cards_names_gloo(monkeypatch, capsys):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards or more are present")
    monkeypatch.setattr(sys, "argv", [
        "train", "--engine", "manual", "--sync", "plan", "--smoke",
        "--nproc", "2", "--backend", "nccl"])
    with pytest.raises(M.SharedDeviceError, match="--backend gloo"):
        train.main()
