"""The port's uncalibrated pricing basis of mesh axes.

The leaf axis is priced at class "root_sw" (`core.sync.AXIS_LEVELS`).
In the paper's GPU testbed (`GPU_TESTBED`) that class is the RoCE spine
between machines, while the leaf axis rides NVLink inside a machine, the
testbed's "middle_sw" row; `GPU_AXIS_BASIS` prices the leaf class at that
row and keeps the between-machine row for the outer axes.
"""
import pytest

from repro_torch.core.cost_model import (GPU_AXIS_BASIS, GPU_TESTBED,
                                        best_flat_plan)
from repro_torch.planner.service import PlannerService

DECODE = 4 * 5120          # the 8-rank decode AllReduce of stablelm-12b


def test_basis_prices_the_leaf_class_on_nvlink():
    assert GPU_AXIS_BASIS["root_sw"] == GPU_TESTBED["middle_sw"]
    for level in ("middle_sw", "server", "cross_dc"):
        assert GPU_AXIS_BASIS[level] == GPU_TESTBED[level]
    # the testbed's table itself stays as copied
    assert GPU_TESTBED["root_sw"] == GPU_TESTBED["cross_dc"]


def test_decode_allreduce_prices_at_the_nvlink_row():
    """Uncalibrated, the 8 × 20,480 decode AllReduce prices at the
    NVLink row (≈ 0.0202 ms), half the between-machine row's price, and
    the plan it lowers is the same."""
    new = PlannerService().get_axis_executable("tp", 8, DECODE)
    old = PlannerService().get_axis_executable("tp", 8, DECODE,
                                               params=GPU_TESTBED)
    assert new.predicted_time == pytest.approx(2.02052096e-5, rel=1e-9)
    assert old.predicted_time == pytest.approx(4.03887104e-5, rel=1e-9)
    assert new.schedule.describe() == old.schedule.describe()


def test_observe_prices_against_the_same_basis():
    """`observe` re-prices the decode plan at the exact size (its halves
    simulated) on the default basis: within 1 % of the quoted price, and
    half of what the between-machine row gives."""
    svc = PlannerService()
    quoted = svc.get_axis_executable("tp", 8, DECODE).predicted_time
    obs = svc.observe("root_sw", 8, float(DECODE), 1e-3,
                      source="local_mesh")
    old = PlannerService().observe("root_sw", 8, float(DECODE), 1e-3,
                                   params=GPU_TESTBED, source="local_mesh")
    assert obs["predicted"] == pytest.approx(quoted, rel=1e-2)
    assert obs["predicted"] < 0.6 * old["predicted"]


@pytest.mark.parametrize("size", [DECODE, 2 ** 20, 2 ** 26])
def test_in_machine_axis_prices_below_the_between_machine_one(size):
    """`get_axis_plans` on an 8-rank in-machine axis and a 4-rank outer
    axis: the in-machine axis moves more data but on the faster fabric;
    the plan kinds are those of the old basis."""
    axes = [("data", 8), ("pod", 4)]
    new = PlannerService().get_axis_plans(axes, size)
    old = PlannerService().get_axis_plans(axes, size, params=GPU_TESTBED)
    assert [(a.axis, a.strategy, a.factors) for a in new] \
        == [(a.axis, a.strategy, a.factors) for a in old]
    assert new[1].predicted == old[1].predicted
    assert new[0].predicted < old[0].predicted
    if size == 2 ** 26:
        assert new[0].predicted < new[1].predicted
        assert new[0].predicted == pytest.approx(4.4026926080e-4, rel=1e-9)


def test_leaf_price_is_the_closed_form_at_the_nvlink_row():
    import dataclasses
    p = dataclasses.replace(GPU_TESTBED["middle_sw"],
                            gamma=GPU_TESTBED["server"].gamma,
                            delta=GPU_TESTBED["server"].delta)
    _, _, cost = best_flat_plan(8, 2 ** 26, p)
    [plan] = PlannerService().get_axis_plans([("data", 8)], 2 ** 26)
    assert plan.predicted == pytest.approx(cost, rel=1e-12)
