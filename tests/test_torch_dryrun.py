"""The dry run on the meta device (`python -m repro_torch.launch.dryrun`)
at full size, on the CPU with no card: stablelm-12b `train_4k` (the
ZeRO-3 step on 8 ranks, bucketed), deepseek-moe-16b `train_4k` (with the
expert-parallel all-to-all) and qwen3-32b `decode_32k` (one decode step
against a 32,768-slot cache), each through the CLI in a process of its
own, side by side.

- `model_flops` is the reference's `model_flops_train` /
  `model_flops_forward` of the cell; the roofline terms are the census's
  totals at the H100's rates;
- `coll_counts` is the step's sync units × families: one all-gather and
  one reduce-scatter a gather / scatter bucket, the two metrics'
  pmeans, and for the MoE model 6 all-to-alls a MoE layer (dispatch and
  combine, forward, recompute and backward); the decode step (one
  device) has none;
- a cell the configuration does not support is a documented skip; the
  variants the auto engine needs raise, naming ROADMAP item 8; an
  unknown one raises.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.train import make_manual_train_step
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import build

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [("stablelm-12b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
         ("qwen3-32b", "decode_32k"), ("stablelm-12b", "long_500k")]
KEYS = {"hlo_flops", "hlo_bytes", "coll_bytes", "coll_by_kind",
        "coll_counts", "compute_s", "memory_s", "collective_s", "dominant",
        "model_flops", "useful_ratio", "roofline_fraction",
        "bytes_per_device"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for arch, shape in CELLS:
        out = tmp / f"{arch}_{shape}.json"
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--json", str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    got = {}
    for arch, shape, out, p in procs:
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, stderr[-4000:]
        doc = json.loads(out.read_text())
        assert doc["device"] == "meta" and doc["ranks"] == 8
        (res,) = doc["results"]
        got[(arch, shape)] = (res, stdout)
    return got


def _step(arch):
    """The cell's step as the dry run's process builds it: on a fresh
    default planner (a warm one answers from its size-bucketed cache)."""
    from repro_torch.planner import service
    prev = service.peek_default_service()
    service.set_default_service(None)
    try:
        api = build(get_config(arch))
        return api.cfg, make_manual_train_step(
            api, 8, sync=SyncConfig(strategy="plan"), device="meta")
    finally:
        service.set_default_service(prev)


def test_stablelm_train(results):
    res, out = results[("stablelm-12b", "train_4k")]
    assert KEYS <= set(res) and res["chips"] == 8 and "[ ok ]" in out
    cfg, step = _step("stablelm-12b")
    sh = SHAPES["train_4k"]
    assert res["model_flops"] == analysis.model_flops_train(
        cfg, sh.global_batch * sh.seq_len)
    assert step.bucket_plan is not None
    assert res["coll_counts"] == {
        "all-gather": len(step.gather_buckets),
        "reduce-scatter": len(step.scatter_buckets), "all-reduce": 2}
    assert res["compute_s"] == pytest.approx(
        res["hlo_flops"] / (8 * analysis.PEAK_FLOPS), rel=1e-12)
    assert res["memory_s"] == pytest.approx(
        res["hlo_bytes"] / (8 * analysis.HBM_BW), rel=1e-12)
    assert res["collective_s"] == pytest.approx(
        res["coll_bytes"] / (8 * analysis.LINK_BW), rel=1e-12)
    # the products: 6·N·D with the layer's recompute, within a third
    assert 1.0 < res["hlo_flops"] / res["model_flops"] < 4 / 3 + 0.05


def test_moe_train(results):
    res, _ = results[("deepseek-moe-16b", "train_4k")]
    cfg, step = _step("deepseek-moe-16b")
    assert step.ep == ("data", 8)
    sh = SHAPES["train_4k"]
    assert res["model_flops"] == analysis.model_flops_train(
        cfg, sh.global_batch * sh.seq_len)
    moe_layers = cfg.n_layers
    assert res["coll_counts"] == {
        "all-gather": len(step.gather_buckets),
        "reduce-scatter": len(step.scatter_buckets), "all-reduce": 2,
        "all-to-all": 6 * moe_layers}


def test_decode(results):
    res, _ = results[("qwen3-32b", "decode_32k")]
    cfg = get_config("qwen3-32b")
    assert res["chips"] == 1 and res["kind"] == "decode"
    assert res["model_flops"] == analysis.model_flops_forward(
        cfg, SHAPES["decode_32k"].global_batch)
    assert res["coll_counts"] == {} and res["coll_bytes"] == 0.0
    # every layer's norms (2 and qk_norm's 2) and attention, the final
    # norm: each wrapper's work counted from the shapes
    L = cfg.n_layers
    assert res["kernels"]["rmsnorm"][0] == 4 * L + 1
    assert res["kernels"]["flash_attention"][0] == L
    # the cache alone: 2 · L · B · Hkv · S · hd bf16
    cache = 2 * L * 128 * cfg.n_kv_heads * 32768 * cfg.head_dim * 2
    assert res["bytes_per_device"] > cache
    assert res["dominant"] == "memory"


def test_unsupported_cell_is_a_documented_skip(results):
    res, out = results[("stablelm-12b", "long_500k")]
    assert res["skipped"].startswith("unsupported") and "[skip]" in out


def test_variants():
    cfg = get_config("stablelm-12b")
    got = dryrun.apply_variants(cfg, ("kvblock=512", "moegroups=4",
                                      "moelocal"))
    assert (got.attn_kv_block, got.moe_groups, got.moe_local) == (512, 4,
                                                                  True)
    for v in ("zero1", "seqpar"):
        with pytest.raises(NotImplementedError, match="item 8"):
            dryrun.apply_variants(cfg, (v,))
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.apply_variants(cfg, ("fsdp2",))


def test_kv_block_cell_runs_on_meta():
    """A variant cell in the process: the KV-block scan in the training
    step at a cut depth (one layer) keeps the step's collectives."""
    import dataclasses
    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=1)
    api = build(dryrun.apply_variants(cfg, ("kvblock=1024",)))
    from repro_torch.launch.train import shard_params_zero3
    from repro_torch.optim import adamw_init
    step = make_manual_train_step(api, 8, sync=SyncConfig(strategy="plan"),
                                  device="meta")
    shards = shard_params_zero3(api.params_spec(), 8)
    state = {"params": shards, "opt": adamw_init(shards)}
    with analysis.census(8) as c:
        step(state, api.train_specs(SHAPES["train_4k"]))
    st = c.stats()
    assert st.coll_counts["all-reduce"] == 2 and st.flops > 0
    assert math.isfinite(st.hbm_bytes)
