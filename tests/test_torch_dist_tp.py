"""Tensor parallelism on the auto engine's "model" axis, with one process
a rank (gloo on the CPU), against the JAX package's auto engine on the
same mesh and the port's one-device run: the transformer families
(`_tp_runs.py` holds the fixture's body and the tolerances).

The runs (`_dist_workers.TP_RUNS`): stablelm-12b, gemma2-27b, qwen3-32b,
gemma3-4b, deepseek-moe-16b and mixtral-8x22b (the auto engine's global
dispatch over the DP line) and qwen2-vl-7b, each its smoke model widened
(`TP_DENSE`, `TP_MOE`) with FSDP in f32 on ("data", 2) x ("model", 2);
stablelm-12b also in bf16, with ZeRO-1, on ("data", 1) x ("model", 4),
on ("pod", 2) x ("data", 1) x ("model", 2) and on the masked batch.
"""
import pytest

import _dist_workers as W
import _tp_runs as TP

LABELS = [r[0] for r in W.TP_RUNS if r[1] not in W.TP_REST]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TP.run(tmp_path_factory.mktemp("dist_tp"), LABELS, extras=False)


@pytest.mark.parametrize("label", LABELS)
def test_ranks_match_the_reference_tp_step(runs, label):
    ref, ranks, _, _ = runs
    TP.check_reference(ref, ranks, label)


@pytest.mark.parametrize("label", [k for k in LABELS
                                   if k != "stablelm-bf16"])
def test_ranks_match_the_one_device_run(runs, label):
    _, ranks, one, _ = runs
    TP.check_one_device(ranks, one, label)


@pytest.mark.parametrize("label", LABELS)
def test_every_kind_of_spec_occurs(runs, label):
    """The widened smoke model holds each kind of "model" spec the
    full-size rule gives: column, row, replicated, the embedding on its
    hidden dim and the head on its vocabulary."""
    _, ranks, _, _ = runs
    assert TP.kinds(ranks, label) == TP.KINDS
