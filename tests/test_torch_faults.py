"""Two faults of the port, each against what its promise says: a dense
kernel wrapper's device check compares whole devices (two cards are a
mix, not one card), and the planner's executable count includes the
memoised all-to-all / p2p schedules that `invalidate_executables`
drops. Both run on the CPU: the first with stand-in objects whose
`.device` names a card, so no card is needed."""
import types

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.planner.service import PlannerService


def _on(device: str):
    return types.SimpleNamespace(device=torch.device(device))


def test_on_cuda_takes_one_card_and_refuses_two():
    assert ops._on_cuda(_on("cuda:0"), _on("cuda:0"), None) is True
    assert ops._on_cuda(_on("cpu"), None) is False
    with pytest.raises(ValueError, match="all on one CUDA device") as err:
        ops._on_cuda(_on("cuda:0"), _on("cuda:1"))
    assert "cuda:0" in str(err.value) and "cuda:1" in str(err.value)
    with pytest.raises(ValueError, match="all on one CUDA device"):
        ops._on_cuda(_on("cpu"), _on("cuda:0"))


@pytest.mark.parametrize("family", ["all_to_all", "p2p"])
def test_executable_count_includes_family_schedules(family):
    svc = PlannerService()
    assert svc.executable_count() == 0
    resp = svc.get_family_executable(family, "x", 8, 4096.0)
    assert resp.schedule is not None
    count = svc.executable_count()
    assert count >= 1
    assert svc.invalidate_executables() == count
    assert svc.executable_count() == 0
