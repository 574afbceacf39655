"""Expert-parallel MoE training with one process a rank (a process mesh
over gloo on the CPU) against the local mesh and the JAX package's.

One fixture runs, side by side, one JAX subprocess (the reference's
`make_manual_train_step` for the smoke deepseek-moe-16b on a plain
4-device `jax.sharding.Mesh` ("data", "model"), sync "plan" per leaf at
Table 5, f32, 3 steps from its own init) and one launch of 4 processes
(`tests/_dist_workers.py:ep_worker`, with a deadline) that train on
("data", 4), EP over "data": deepseek-moe-16b (8 routed experts, 2 a
rank) from the reference's init with the planned all-to-all exchange,
and from seeded weights with the flat copy exchange ("ring" sync);
mixtral-8x22b (8 experts top 2, its window past the smoke prompt) with
the planned exchange. Each process runs its own rank's forward and
backward, `layers.moe(dispatch="ep")` exchanging over the EP axis's
process group, each layer checkpointed with early stop off.

Tolerances: every rank's losses, gnorms and final shards equal the
4-rank local mesh's (`forward_ep`, every rank in one graph) exactly,
and each rank counts the local mesh's exchanges, 6 a MoE layer a step
(2 forward, 2 recomputed, 2 transposed); against the reference, f32
within 1e-5 relative at every step (`test_torch_moe_train.py`'s
STEP_TOL).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.launch import mesh as M

TIMEOUT_S = 300
STEP_TOL = 1e-5
ARCH = "deepseek-moe-16b"
CASES = [(ARCH, "plan", True, "data4"), (ARCH, "ring", False, "data4"),
         ("mixtral-8x22b", "plan", False, "data4"),
         (ARCH, "plan", False, "pod2xdata2")]
IDS = [f"{a}-{lb}-{k}" for a, lb, _, k in CASES]

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
mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
data = SyntheticLM(DataConfig(**spec["data"]))
cfg = smoke_config(get_config(spec["arch"]))
api = dataclasses.replace(build(cfg), init_params=lambda key:
                          transformer.init_params(key, cfg, jnp.float32))
params = api.init_params(jax.random.PRNGKey(0))
res = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["init/float32/" + "/".join(str(p.key) for p in path)] = \
        np.asarray(leaf)
np.savez(init_path + ".tmp.npz", **res)
os.replace(init_path + ".tmp.npz", init_path)
state = {"params": shard_params_zero3(params, mesh),
         "opt": adamw_init(shard_params_zero3(params, mesh))}
state["opt"] = {k: jax.tree.map(lambda z, p: jax.device_put(
    z, p.sharding), state["opt"][k], state["params"]) for k in ("m", "v")}
state["opt"]["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                      NamedSharding(mesh, P()))
step = make_manual_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                              sync=SyncConfig(strategy="plan",
                                              bucket_bytes=0,
                                              params=PAPER_TABLE5))
losses, gnorms = [], []
for s in range(spec["steps"]):
    state, m = step(state, jax.tree.map(jnp.asarray, data.batch_at(s)))
    losses.append(float(m["loss"]))
    gnorms.append(float(m["gnorm"]))
np.savez(out_path, losses=np.asarray(losses), gnorms=np.asarray(gnorms))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's losses and gnorms, the ranks' results, the local
    mesh's runs by case)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import data_config
    from repro_torch.models.config import smoke_config
    d = tmp_path_factory.mktemp("dist_ep")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    dc = data_config(smoke_config(get_config(ARCH)), **W.EP_DATA)
    spec = repr({"arch": ARCH, "lr": W.LR, "steps": W.STEPS,
                 "data": dict(vocab=dc.vocab, seq_len=dc.seq_len,
                              global_batch=dc.global_batch, seed=dc.seed)})
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
        ranks = M.launch(W.ep_worker, 4, backend="gloo", device="cpu",
                         timeout_s=TIMEOUT_S, threads=1,
                         args=(CASES, str(init)))
        inputs = dict(np.load(init))
        before = torch.get_num_threads()
        torch.set_num_threads(1)        # the ranks' thread count
        try:
            local = {(a, lb, k): W.ep_train_steps(
                [tuple(x) for x in W.EP_MESHES[k]], a, lb,
                inputs if ref else None) for a, lb, ref, k in CASES}
        finally:
            torch.set_num_threads(before)
        _, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 0, err[-4000:]
    return dict(np.load(d / "ref.npz")), ranks, local


@pytest.mark.parametrize("arch,label,key", [(a, lb, k)
                                             for a, lb, _, k in CASES],
                         ids=IDS)
def test_ranks_equal_the_local_mesh_ep_trainer(runs, arch, label, key):
    """The experts split over the first live axis: "data" on ("data",
    4), "pod" on (pod 2, data 2)."""
    _, ranks, local = runs
    want = local[(arch, label, key)]
    assert want["ep"] == W.EP_MESHES[key][0]
    assert want["planned"] == (label == "plan")
    assert want["losses"][-1] < want["losses"][0]
    for r, res in enumerate(ranks):
        got = res[(arch, label, key)]
        assert got["ep"] == want["ep"] and got["planned"] == want["planned"]
        assert got["losses"] == want["losses"]
        assert got["gnorms"] == want["gnorms"]
        for s, w in zip(got["shards"], want["shards"]):
            assert torch.equal(s, w[r])


@pytest.mark.parametrize("arch,label,key", [(a, lb, k)
                                             for a, lb, _, k in CASES],
                         ids=IDS)
def test_each_rank_counts_the_local_meshs_exchanges(runs, arch, label,
                                                    key):
    """Each rank issues a MoE layer's exchanges in the local mesh's
    order and number: 2 in the forward, 2 recomputed, 2 transposed."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    _, ranks, local = runs
    L = smoke_config(get_config(arch)).n_layers
    want = [{"forward": 2 * L, "recompute": 2 * L, "backward": 2 * L}] \
        * W.STEPS
    assert local[(arch, label, key)]["ex"] == want
    assert all(res[(arch, label, key)]["ex"] == want for res in ranks)


def test_ranks_match_the_reference_ep_step(runs):
    ref, ranks, _ = runs
    got = ranks[0][(ARCH, "plan", "data4")]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=STEP_TOL,
                               atol=0)
    np.testing.assert_allclose(got["gnorms"], ref["gnorms"], rtol=STEP_TOL,
                               atol=0)
