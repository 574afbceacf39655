"""The port's manual ZeRO-3 step with the flat sync labels against the
reference's `make_manual_train_step` on a plain 8-device `Mesh`, in f32
at smoke size: `SyncConfig(strategy=label, params=PAPER_TABLE5)` for
ring, rhd, cps, hcps (the factors `resolve_axis_plans` gives, (2, 2, 2)),
gentree (the planner's label for the axis) and auto (psum), on both
sides, from the same f32 weights and `SyntheticLM` batches. Held: the
plan, the per-step loss and gnorm within 1e-5 relative (the tolerance
`test_torch_train.py` states for the f32 step), and exactly one
`fused_reduce_into` launch per fold of each leaf's reduce-scatter (the
flat all-gathers only copy). The reference runs in `test_torch_train.py`'s
subprocess (the "flat/<label>" parts).
"""
import pytest

from repro_torch.core.cost_model import PAPER_TABLE5
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import train
from test_torch_train import (FLAT_LABELS, N, STEPS, _api,  # noqa: F401
                              check_steps, few_threads, inputs, port_run,
                              run_reference)

# one reduce-scatter's folds a leaf, by the label's strategy at n = 8
RS_FOLDS = {"ring": N - 1, "rhd": 3, "cps": 1, "hcps": 3, "psum": 1}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs,
                         tuple(f"flat/{label}" for label in FLAT_LABELS))


@pytest.fixture(scope="module")
def runs(ref):
    return {label: port_run(ref, "float32", SyncConfig(
        strategy=label, params=PAPER_TABLE5), prefix=f"flat/{label}")
        for label in FLAT_LABELS}


@pytest.mark.parametrize("label", FLAT_LABELS)
def test_flat_step_matches_reference(ref, runs, label):
    check_steps(ref, runs[label], "float32", prefix=f"flat/{label}")


@pytest.mark.parametrize("label", FLAT_LABELS)
def test_flat_step_plan_and_launches(runs, label):
    """The step's one axis plan (auto: psum; gentree: a flat label) and
    its launches: each of the 12 leaves' reduce-scatter folds, a step."""
    (plan,) = runs[label]["step"].plans
    want = {"auto": "psum"}.get(label, label)
    if label == "gentree":
        assert plan.strategy in RS_FOLDS
    else:
        assert plan.strategy == want
    if plan.strategy == "hcps":
        assert plan.factors == (2, 2, 2)
    assert runs[label]["step"].bucket_plan is None
    assert runs[label]["counts"] == {
        "fused_reduce_into": STEPS * 12 * RS_FOLDS[plan.strategy]}


@pytest.mark.parametrize("label", ["ring", "gentree", "auto"])
def test_train_config_takes_the_label(label):
    """`TrainConfig(engine="manual", sync=label)` passes the scope check
    (it raised before this slice) and trains on the CPU."""
    tc = train.TrainConfig(steps=1, seq_len=16, engine="manual", sync=label,
                           device="cpu")
    train._check_train_scope(tc)
    out = train.run_training(tc, on_log=lambda *_: None)
    assert len(out["losses"]) == 1 and out["bucket_plan"] is None


def test_rhd_off_a_power_of_two_is_refused():
    """rhd on 6 ranks shards over its power-of-two core (L / 4 a rank),
    not the parameter shards (L / 6): the step refuses the plan."""
    with pytest.raises(ValueError, match="reduce-scatter shards hold"):
        train.make_manual_train_step(_api("stablelm-12b"), 6,
                                     sync=SyncConfig(strategy="rhd"),
                                     device="cpu")
