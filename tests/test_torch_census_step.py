"""The census of the port's manual ZeRO-3 step against the reference's
`analyze_hlo` of its compiled `make_manual_train_step`, on the CPU at
smoke size (stablelm-12b, 8 ranks, global batch 8 of 32 tokens).

Both run the XLA-native label, `SyncConfig(strategy="psum")`: one
all-gather and one reduce-scatter a leaf, and the two metrics' pmeans.
The reference runs in a subprocess with 8 forced host devices on a plain
`jax.sharding.Mesh` (as tests/test_torch_train.py's); its module is
compiled, not run. Both sides hold f32 parameters: XLA's CPU backend
widens bf16 collectives to f32 (its all-gathers of bf16 shards read
f32[...] in the HLO), so a bf16 step's payloads would differ by the
backend's widening, not by the port.

- Per family, the counts and the payloads match exactly, with one merge:
  XLA's all-reduce combiner folds the loss and gnorm pmeans (two f32
  scalars) into one all-reduce of a 2-tuple, so the port's two
  all-reduce records (4 bytes each) are held to the reference's one (8
  bytes) by their total payload;
- the step's mix (`mix_from_stats`) prices the same step plan on both
  services, the all-reduce merge aside;
- FLOPs per rank: the reference's dot FLOPs less the port's own gap,
  exactly. The gap is one op: the reference's attention checkpoints each
  q block again inside the checkpointed layer (`lax.scan(jax.checkpoint(
  body))`), so its backward recomputes the block's two products (q·kᵀ,
  (4, 32, 32), and p·v, (4, 32, 16), 131,072 FLOPs each a rank) a third
  time; the port's `train_attention` recomputes them once, with the
  layer. 2 layers × 2 × 131,072 = 524,288 of 25,690,112 (2.04 %).
  Every other product (the projections, the MLP, the logits, and the
  backward's) matches in count and shape.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import analysis
from repro_torch.launch.train import (batch_tensors, data_config,
                                      make_manual_train_step,
                                      shard_params_zero3)
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.planner.service import PlannerService

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "stablelm-12b"
N, SEQ, BATCH = 8, 32, 8

_CHILD = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core.sync import SyncConfig
from repro.data import DataConfig, SyntheticLM
from repro.launch import hlo_analysis as ha
from repro.launch.train import make_manual_train_step, shard_params_zero3
from repro.models import transformer
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import AdamWConfig, adamw_init

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = smoke_config(get_config(arch))
api = dataclasses.replace(build(cfg), init_params=lambda key,
                          dtype=jnp.float32: transformer.init_params(
                              key, cfg, dtype))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(8, 1), ("data", "model"))
shards = shard_params_zero3(api.init_params(jax.random.PRNGKey(0)), mesh)
state = {"params": shards, "opt": adamw_init(shards)}
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch, seed=0)).batch_at(0)
step = make_manual_train_step(api, mesh, AdamWConfig(),
                              sync=SyncConfig(strategy="psum"))
st = ha.analyze_hlo(step.lower(state, data).compile().as_text())
print(json.dumps(dataclasses.asdict(st)))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _CHILD, ARCH, str(SEQ),
                           str(BATCH)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    from repro.launch.hlo_analysis import ModuleStats
    return ModuleStats(**json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def port():
    torch.set_num_threads(2)
    cfg = smoke_config(get_config(ARCH))
    api = build(cfg)
    step = make_manual_train_step(api, N, AdamWConfig(),
                                  sync=SyncConfig(strategy="psum"),
                                  device="cpu", param_dtype=torch.float32)
    shards = shard_params_zero3(api.init_params(
        torch.Generator().manual_seed(0), torch.float32, "cpu"), N)
    state = {"params": shards, "opt": adamw_init(shards)}
    batch = batch_tensors(SyntheticLM(data_config(cfg, SEQ, BATCH))
                          .batch_at(0), "cpu")
    with analysis.census(N) as c:
        step(state, batch)
    return c, cfg, len(shards)


def test_families_match_reference(reference, port):
    c, _, leaves = port
    st = c.stats()
    assert st.coll_counts == {"all-gather": leaves, "reduce-scatter": leaves,
                              "all-reduce": 2}
    # the reference's combiner merged the two pmeans into one all-reduce
    assert reference.coll_counts == {"all-gather": leaves,
                                     "reduce-scatter": leaves,
                                     "all-reduce": 1}
    assert st.coll_payload_by_kind == reference.coll_payload_by_kind
    assert st.coll_by_kind["all-gather"] == \
        reference.coll_by_kind["all-gather"]
    assert st.coll_by_kind["reduce-scatter"] == \
        reference.coll_by_kind["reduce-scatter"]
    assert {r.n for r in c.records} == {N}


def test_step_plan_of_the_census(reference, port):
    """The census's mix prices the reference service's plan for the
    reference's census with its merged all-reduce split back in two."""
    from repro.core.cost_model import PAPER_TABLE5 as J_TABLE5
    from repro.planner.service import PlannerService as JService
    st = port[0].stats()
    want = dataclasses.replace(reference, coll_counts={
        **reference.coll_counts, "all-reduce": 2})
    got = PlannerService().get_step_plan([("data", N)], st,
                                         params=PAPER_TABLE5)
    ref = JService().get_step_plan([("data", N)], want, params=J_TABLE5)
    assert got.key == ref.key
    assert got.total_best == pytest.approx(ref.total_best, rel=1e-9)
    assert sorted(got.quotes) == sorted(ref.quotes)


def test_flops_match_reference_but_the_nested_remat(reference, port):
    c, cfg, _ = port
    rows = BATCH // N
    # the reference's third pass over each layer's two attention products
    nested = cfg.n_layers * 2 * (2 * rows * cfg.n_heads * SEQ * SEQ
                                 * cfg.head_dim)
    assert c.stats().flops == reference.flops - nested
    assert nested / reference.flops == pytest.approx(0.0204, abs=1e-4)
