"""The port's ZeRO-3 trainer over a two-level local mesh, [("pod", 2),
("data", 4)], against the reference's `make_manual_train_step` on a plain
`Mesh(devices.reshape(2, 4), ("pod", "data"))` (its `run_training` builds
meshes with `jax.make_mesh`, which these tests avoid), from the same
weights (`shard_params_zero3` on both sides, `convert.params_from_jax`)
and the same `SyntheticLM` batches, per leaf, with
`SyncConfig(strategy=label, bucket_bytes=0, params=PAPER_TABLE5)` on both
sides for the labels plan, ring, cps, hcps, gentree and auto:

- the shards exactly: rank (p, d) holds row 4p + d;
- the chunk order of a two-level gather: the plans gather in mesh order
  ("pod", then "data"), so rank (p, d)'s shard lands at chunk 2d + p and
  the gathered vector of arange(16) is chunks 0, 4, 1, 5, 2, 6, 3, 7 —
  pinned against the reference's, for ring and plan;
- the per-step loss and gnorm: f32 within 1e-5 relative, bf16 (plan)
  within 5e-3 (`test_torch_train.py` states both);
- each level's plan: "pod" priced at level 0, "data" at level 1, the
  reference's `axis_level` by position among the live axes;
- the launches: one `fused_reduce_into` a fold of each flat program, and
  one a fold phase a group of the other axis for a "plan" schedule
  (`collectives._per_group`: 4 groups on "pod", 2 on "data").

A bucketed request on two axes takes the per-leaf path, as the
reference's `bucket_plan_for` does, and logs why. The reference runs in
`test_torch_train.py`'s subprocess (its "mesh/..." parts).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig, axis_level, resolve_axis_plans
from repro_torch.launch import train

from test_torch_train import (MESH, N, STEPS, _api, _leaves,  # noqa: F401
                              _np, _params, check_steps, few_threads,
                              inputs, port_run, run_reference)

M = [("pod", 2), ("data", 4)]
F32 = [label for label, dtype, wire in MESH
       if dtype == "float32" and wire == "f32"]
# the gathered vector of arange(16) on M: chunk 2d + p is rank (p, d)'s
# row 4p + d
ORDER = [0, 4, 1, 5, 2, 6, 3, 7]


def _sync(label, **kw):
    return SyncConfig(strategy=label, bucket_bytes=0, params=PAPER_TABLE5,
                      **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs, ("mesh/order",) + tuple(
        f"mesh/{label}/{wire}/{dtype}" for label, dtype, wire in MESH
        if wire == "f32"))


@pytest.fixture(scope="module")
def runs(ref):
    out = {(label, "float32"): port_run(ref, "float32", _sync(label),
                                        prefix=f"mesh/{label}/f32", mesh=M)
           for label in F32}
    out[("plan", "bfloat16")] = port_run(ref, "bfloat16", _sync("plan"),
                                         prefix="mesh/plan/f32", mesh=M)
    return out


@pytest.mark.parametrize("label", ["ring", "plan"])
def test_two_level_gather_chunk_order(ref, label):
    plans = resolve_axis_plans(M, _sync(label), 2.0)
    assert [pl.axis for pl in plans] == ["pod", "data"]
    (shards,) = train.shard_params_zero3({"x": torch.arange(16.)}, M)
    got = train._gather_leaf(shards, 16, plans, mesh=M)
    want = ref[f"mesh/order/{label}"]
    np.testing.assert_array_equal(_np(got), want)
    chunks = np.arange(16.).reshape(8, 2)[ORDER].reshape(-1)
    np.testing.assert_array_equal(want, np.broadcast_to(chunks, (8, 16)))


def test_two_level_shards_match_reference(ref):
    for dtype in ("float32", "bfloat16"):
        prefix = f"mesh/plan/f32/{dtype}"
        got = train.shard_params_zero3(
            _params(ref, f"{prefix}/init", getattr(torch, dtype)), M)
        want = _leaves(ref, f"{prefix}/shards")
        assert len(got) == len(want) == 12
        for t, w in zip(got, want):
            assert t.shape == w.shape and np.array_equal(_np(t), w)


@pytest.mark.parametrize("label", F32)
def test_two_level_f32_steps_match_reference(ref, runs, label):
    check_steps(ref, runs[(label, "float32")], "float32",
                prefix=f"mesh/{label}/f32")


def test_two_level_bf16_steps_match_reference(ref, runs):
    check_steps(ref, runs[("plan", "bfloat16")], "bfloat16",
                prefix="mesh/plan/f32")


def mesh_launches(step, steps: int, leaves: int) -> int:
    """fused_reduce_into launches of `steps` per-leaf steps over the live
    axes of `step.mesh`: for each leaf and each axis plan, a flat label's
    reduce-scatter folds (its all-gather only copies), or a schedule's
    fold phases of both halves once a group of the other axes."""
    from repro_torch.core import collectives as C
    sizes = dict(step.mesh)
    R = int(np.prod(list(sizes.values())))
    per = 0
    for pl in step.plans:
        n = sizes[pl.axis]
        if pl.strategy == "plan":
            cs = pl.schedule
            halves = (cs.rs + ([cs.reorder] if cs.reorder else [])
                      + ([cs.unorder] if cs.unorder else []) + cs.ag)
            per += R // n * sum(len(st.folds) for st in halves)
        else:
            dims = (list(sizes).index(pl.axis),)
            per += C.flat_program(
                pl.strategy, "reduce_scatter", tuple(sizes.values()), dims,
                pl.factors, order=True).folds
    return steps * leaves * per


def describe(plans) -> list[str]:
    return [f"{p.axis} {p.strategy} {p.factors} "
            + (p.schedule.describe() if p.schedule is not None else "")
            for p in plans]


@pytest.mark.parametrize("label", F32)
def test_two_level_plans_and_launches(ref, runs, label):
    """One plan a live axis in mesh order, each priced at its position's
    level ("pod" at level 0), the reference's plans to the schedule
    (`resolve_axis_plans` on both sides; "auto" is psum on each axis, as
    the reference's step builds it), and the launches `mesh_launches`
    counts; no other kernel."""
    run = runs[(label, "float32")]
    step = run["step"]
    assert step.mesh == M and step.bucket_plan is None and step.wire is None
    assert [pl.axis for pl in step.plans] == ["pod", "data"]
    if label == "auto":
        assert [pl.strategy for pl in step.plans] == ["psum", "psum"]
    else:
        assert describe(step.plans) == list(ref[f"mesh/{label}/f32/float32"
                                                f"/plans"])
    if label == "plan":
        assert [pl.schedule.n for pl in step.plans] == [2, 4]
        assert [axis_level(i) for i in range(2)] == ["root_sw", "cross_dc"]
    assert run["counts"] == {"fused_reduce_into": mesh_launches(
        step, STEPS, 12)}


def test_bucketed_request_on_two_axes_takes_per_leaf(ref, runs, caplog):
    """`SyncConfig(strategy="plan")` (bucketed by default) on two live
    axes: the reference's `bucket_plan_for` gives None there, so the
    step takes the per-leaf path, logs why and holds no bucket plan; its
    steps equal the per-leaf run's bit for bit."""
    with caplog.at_level("WARNING", logger="repro_torch.launch.train"):
        run = port_run(ref, "float32", SyncConfig(strategy="plan",
                                                  params=PAPER_TABLE5),
                       prefix="mesh/plan/f32", mesh=M)
    assert "per-leaf" in caplog.text and "2 live mesh axes" in caplog.text
    step = run["step"]
    assert step.bucket_plan is None and step.scatter_buckets == []
    base = runs[("plan", "float32")]
    assert run["losses"] == base["losses"] and run["gnorms"] == base["gnorms"]
    for a, b in zip(run["state"]["params"], base["state"]["params"],
                    strict=True):
        assert torch.equal(a, b)


def test_run_training_over_the_two_level_mesh():
    logs = []
    out = train.run_training(
        train.TrainConfig(steps=2, seq_len=16, engine="manual", sync="plan",
                          device="cpu", log_every=1),
        on_log=logs.append, mesh=M)
    assert out["bucket_plan"] is None
    assert [pl.axis for pl in out["plans"]] == ["pod", "data"]
    assert all(np.isfinite(out["losses"]))
    assert any(line.startswith("planner: per-leaf sync") for line in logs)
    assert all(s.shape[0] == N for s in out["state"]["params"])


def test_two_level_shards_that_do_not_line_up_are_refused(monkeypatch):
    """A schedule of 12 blocks on "data" pads a leaf of 8 elements to 12,
    3 a rank, then ring on "pod" pads those to 4, 2 a rank: the parameter
    shard is 1, so the step raises instead of padding (ring on both axes
    lines up)."""
    from repro_torch.core.sync import AxisPlan
    sched = type("S", (), {"num_blocks": 12,
                           "describe": lambda self: "12 blocks"})()
    plans = [AxisPlan("pod", "ring"), AxisPlan("data", "plan",
                                               schedule=sched)]
    assert train._shard_of(8, M, plans) == 2
    assert train._shard_of(8, M, plans[:1] + [AxisPlan("data", "ring")]) == 1
    monkeypatch.setattr(train, "resolve_axis_plans", lambda *a, **k: plans)
    with pytest.raises(ValueError, match="reduce-scatter shards hold"):
        train.make_manual_train_step(_api("stablelm-12b"), M, device="cpu")
