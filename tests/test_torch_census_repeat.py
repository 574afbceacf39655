"""The census of a training step is a function of the shapes alone: one
smoke step of the expert-parallel trainer (and of the dense one) on the
meta device, censused twice in one process, counts the same FLOPs, HBM
bytes, collectives, kernel work and peak live bytes both times.

The first run of a lowered schedule builds its index tables on the
device and caches them (`core.lower._device_tables`, `FlatOp.tables`,
`DistOp.indices` / `table`); they are built under
`analysis.constants()`, so the census neither counts nor tracks them,
and a step whose schedules an earlier run (or an earlier dry-run cell)
already built counts what a first run does. Without that the peak
moved by the tables' bytes (1,344 at this size) between the two runs.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.bucketing import invalidate_schedules
from repro_torch.core.sync import SyncConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import analysis
from repro_torch.launch.train import (data_config, make_manual_train_step,
                                      shard_params_zero3)
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.optim import AdamWConfig, adamw_init

RANKS = 8


def _counts(api, step) -> tuple:
    shards = shard_params_zero3(api.params_spec(), RANKS)
    state = {"params": shards, "opt": adamw_init(shards)}
    b = SyntheticLM(data_config(api.cfg, 32, 8)).batch_at(0)
    batch = {k: torch.empty(v.shape, dtype=torch.long, device="meta")
             for k, v in b.items()}
    with analysis.census(RANKS) as c:
        step(state, batch)
    s = c.stats()
    return (c.total.flops, c.total.hbm_bytes, c.peak_bytes, s.flops,
            s.hbm_bytes, s.coll_bytes, sorted(s.coll_counts.items()),
            [(r.kind, r.payload, r.n) for r in c.records],
            c.kernel_work())


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b",
                                  "stablelm-12b"])
def test_step_census_repeats_exactly(arch):
    # schedules lowered afresh: the first run builds their tables
    invalidate_schedules()
    api = build(smoke_config(get_config(arch)))
    step = make_manual_train_step(api, RANKS, AdamWConfig(),
                                  sync=SyncConfig(strategy="plan"),
                                  device="meta")
    assert (step.ep is not None) == (arch != "stablelm-12b")
    first = _counts(api, step)
    again = _counts(api, step)
    assert first == again
    assert first[2] > 0 and first[1] > 0
