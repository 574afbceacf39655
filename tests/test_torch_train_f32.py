"""The port's manual ZeRO-3 step in f32 against the reference's
`make_manual_train_step` on a plain 8-device `Mesh`, from the same f32
weights (`convert.params_from_jax`) and the same `SyntheticLM` batches:
the per-step loss and gnorm within 1e-5 relative, the state after 3
steps, and one `fused_reduce_into` launch per fold phase of each leaf's
gather and scatter. The reference runs in `test_torch_train.py`'s
subprocess (the "train/float32" part), where the tolerances are stated.
"""
import numpy as np
import pytest

from test_torch_train import (LR, STEPS, _leaves, _np,  # noqa: F401
                              check_launches, check_steps, few_threads,
                              inputs, port_run, run_reference)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs, ("train/float32",))


@pytest.fixture(scope="module")
def run_f32(ref):
    return port_run(ref, "float32")


def test_train_step_losses_match_reference(ref, run_f32):
    check_steps(ref, run_f32, "float32")


def test_train_state_after_three_steps_matches_reference(ref, run_f32):
    """f32: the moments within 1e-5 of each leaf's largest |value|, the
    parameter shards within that plus a thousandth of the largest
    distance 3 AdamW steps can move an element (3·lr): an element whose
    gradient is ~1e-6 of its leaf's largest takes steps that f32
    rounding of the larger terms it is summed from moves by a large
    share of their size."""
    state = run_f32["state"]
    assert int(state["opt"]["step"]) == int(ref["train/float32/final/opt/"
                                                "step"])
    for what, got in (("params", state["params"]),
                      ("opt/m", state["opt"]["m"]),
                      ("opt/v", state["opt"]["v"])):
        want = _leaves(ref, f"train/float32/final/{what}")
        for t, w in zip(got, want, strict=True):
            assert t.shape == w.shape
            tol = 1e-5 * np.abs(w).max()
            if what == "params":
                tol += 1e-3 * STEPS * LR
            assert np.abs(_np(t) - w).max() <= tol, what


def test_one_fused_reduce_launch_per_fold_phase(run_f32):
    check_launches(run_f32)
