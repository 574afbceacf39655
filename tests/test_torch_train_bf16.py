"""The port's manual ZeRO-3 step in bf16, the reference's default dtype,
against the reference's `make_manual_train_step` on a plain 8-device
`Mesh`, from the same bf16 weights (`convert.params_from_jax`) and the
same `SyntheticLM` batches: the shards exactly, the per-step loss and
gnorm within 5e-3 relative (`test_torch_train.py` states why), and one
`fused_reduce_into` launch per fold phase of each leaf's gather and
scatter. The reference runs in `test_torch_train.py`'s subprocess (the
"train/bfloat16" part).
"""
import pytest

from test_torch_train import (check_launches, check_shards,  # noqa: F401
                              check_steps, few_threads, inputs, port_run,
                              run_reference)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs, ("train/bfloat16",))


@pytest.fixture(scope="module")
def run_bf16(ref):
    return port_run(ref, "bfloat16")


def test_bf16_shards_match_reference(ref):
    check_shards(ref, "bfloat16")


def test_bf16_train_step_losses_match_reference(ref, run_bf16):
    check_steps(ref, run_bf16, "bfloat16")


def test_bf16_one_fused_reduce_launch_per_fold_phase(run_bf16):
    check_launches(run_bf16)
