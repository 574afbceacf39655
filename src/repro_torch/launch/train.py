"""Training entry point: the manual ZeRO-3 engine on a local mesh.

The reference's manual engine (`launch/train.py`) shards every parameter
leaf over the data-parallel ranks (ZeRO-3: flat per-rank shards),
gathers them with a planned AllGather and reduces the gradients with a
planned ReduceScatter: GenTree's plan, lowered by `core.lower` and run
round for round, as the collective of a training step. Here the `n`
ranks are the rows of tensors on one device (the local mesh of
`CompiledSchedule.run_local_*`), as the decode AllReduce of
`launch.serve` is, and each fold phase of a schedule is one
`fused_reduce_into` launch on a card.

Scope: the reference's `SyncConfig(strategy="plan")` on one
data-parallel axis, for the dense family: bucketed by default (GenModel
picks the bucket, `core.bucketing`), per leaf with `bucket_bytes=0`.
These raise `NotImplementedError` and are never replaced by another
path: the flat strategies, the `auto` (pjit) engine and the schedule
probe `observe_sync_probe` (ROADMAP §1 item 4); checkpointing and the
fault loop (item 5); MoE and the recurrent families' training (item 6);
a lossy wire in the trainer (item 9).

    python -m repro_torch.launch.train --engine manual --sync plan --smoke

trains the smoke-size stablelm-12b on the card; `--device cpu` runs it
on the CPU. Without `--smoke` the model is the full configuration.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.sync import AxisPlan, SyncConfig, resolve_axis_plans
from repro_torch.models.registry import ModelAPI
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unstack_layers)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.trace import default_tracer

# the step's parts, timed by CUDA events on a card (`phase_ms`)
PHASES = ("gather", "forward_backward", "reduce_scatter", "adamw")

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# ZeRO-3 layout
# ---------------------------------------------------------------------------
def _split(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    flat = torch.nn.functional.pad(flat, (0, pad)) if pad else flat.clone()
    return flat.reshape(n, -1)


def shard_params_zero3(params: dict, n: int) -> list[torch.Tensor]:
    """The reference's ZeRO-3 shards of `params`: one (n, shard) tensor a
    leaf, row i rank i's shard, in the reference's leaf order. The port's
    per-layer list under "layers" is stacked to (L, ...) leaves first (a
    tree without that list is taken as stacked already); each leaf is
    flattened and zero-padded to a multiple of n. The tensors are
    copies."""
    if isinstance(params.get("layers"), list):
        params = stack_layers(params)
    return [_split(x, n) for _, x in tree_items(params)]


def _gather_leaf(shards: torch.Tensor, numel: int,
                 plans: Sequence[AxisPlan]) -> torch.Tensor:
    """(n, shard) → (n, numel): every rank's gathered copy of the leaf,
    trimmed of its padding."""
    full = shards
    for pl in plans:
        full = pl.schedule.run_local_all_gather(full)
    return full[:, :numel]


def _scatter_leaf(grads: torch.Tensor, plans: Sequence[AxisPlan]
                  ) -> torch.Tensor:
    """(n, numel) per-rank gradients → (n, shard): row i rank i's shard
    of their sum, zero-padded to the schedule's block multiple."""
    out = grads
    for pl in reversed(plans):
        out = pl.schedule.run_local_reduce_scatter(out)
    return out


def _rank_batch(batch: dict, r: int, n: int) -> dict:
    """Rank r's rows of the batch: [r·B/n, (r+1)·B/n) of each leaf whose
    leading size B is a multiple of n above 1, the whole leaf otherwise
    (the reference's `batch_specs` replicates such a leaf)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0] if v.dim() else 0
        out[k] = (v[r * B // n:(r + 1) * B // n] if B > 1 and B % n == 0
                  else v)
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _bucket_plan(n: int, sync: SyncConfig, total_bytes: float):
    """The reference's `bucket_plan_for`: the bucket plan of one DP axis of
    `n` at the model's bytes in f32 units, its schedule guarded unless
    `sync.guard` is off; or (None, reason) where the reference takes the
    per-leaf path instead (the plan does not lower, or its schedule has
    no canonical shards)."""
    from repro_torch.core.bucketing import BucketConfig
    from repro_torch.core.lower import LoweringError, guard_schedule
    from repro_torch.planner.service import default_service

    svc = default_service()
    try:
        bp = svc.get_bucket_plan(
            [("data", int(n))], total_bytes / 4.0 or 1.0,
            params=sync.params, config=BucketConfig(
                bucket_bytes=sync.bucket_bytes, pipeline=sync.pipeline,
                precision=sync.precision, tolerance=sync.tolerance))
    except LoweringError as e:
        return None, f"the bucket plan does not lower ({e})"
    cs = bp.axis_plans[0].schedule if bp.axis_plans else None
    if cs is None or not cs.blocks_per_shard:
        return None, "the bucket plan's schedule has no canonical shards"
    if sync.guard:
        tele = getattr(svc, "telemetry", None)
        bp = dataclasses.replace(bp, axis_plans=[
            dataclasses.replace(pl, schedule=guard_schedule(
                pl.schedule, telemetry=tele))
            for pl in bp.axis_plans])
    return bp, None


def make_manual_train_step(api: ModelAPI, n: int,
                           opt_cfg: AdamWConfig = AdamWConfig(), *,
                           sync: SyncConfig = SyncConfig(strategy="plan",
                                                         bucket_bytes=0),
                           device: str | torch.device = "cuda",
                           param_dtype: torch.dtype = torch.bfloat16):
    """ZeRO-3 step over a local mesh of `n` data-parallel ranks on
    `device`: `step(state, batch) -> (state, metrics)`.

    `state` is {"params": [(n, shard) per leaf], "opt": {"m", "v":
    lists of the same shapes in f32, "step"}} (`shard_params_zero3`,
    `adamw_init`), in the reference's leaf order, its shards in
    `param_dtype`, and is updated in place (the reference donates it).
    `batch` is {"tokens", "labels"} of the global batch on `device`. Per
    step:

      1. the parameters are gathered with the schedule's AllGather; the
         n gathered rows must be equal (checked, `torch.equal`), so the
         ranks share one copy and the others are dropped;
      2. each rank r runs `api.loss_fn(remat=True)` on its rows of the
         batch, and its gradients, in the parameters' dtype, land in
         row r of the tensors the reduce-scatter runs on;
      3. the gradients are reduce-scattered with the schedule and divided
         by n in their dtype;
      4. AdamW runs per rank on that rank's shards, as inside the
         reference's shard_map: each rank clips by the norm of its own
         shards.

    The sync path is the reference's (`sync.strategy` must be "plan",
    without `compress`):
      * bucketed, when `sync.bucket_bytes` is not 0 (None: GenModel picks
        the bucket; a value pins it): `PlannerService.get_bucket_plan` at
        the model's bytes in `param_dtype` over 4, and ONE all-gather a
        gather bucket (`core.bucketing.zero3_gather_bucketed`, shard cap
        bucket_bytes // n; the gathered rows compared bucket by bucket)
        and ONE in-place reduce-scatter a scatter bucket. Each scatter
        bucket's (n ranks, n·width) tensor is allocated once a step, zero
        only in its padding, and each rank's gradient is written straight
        into its columns (`Zero3Bucket.write`), so there is no
        concatenation copy and no private copy in the reduce-scatter.
        With `sync.backward_overlap` the buckets reduce last first
        (spans `bucket/zero3_rs`). Where the reference falls back to the
        per-leaf path (the bucket plan does not lower, or has no
        canonical shards), so does this step: it logs why, and
        `step.bucket_plan` is None;
      * per leaf, when `sync.bucket_bytes` is 0: one all-gather and one
        reduce-scatter a leaf, the axis plan resolved at the summed
        element count of one rank's shards (`resolve_axis_plans`). A plan
        whose reduce-scattered shard of some leaf would not be that
        leaf's parameter shard (its blocks pad the leaf past the
        multiple of n) is refused here.
    A lossy wire (a `precision` the plan binds, other than f32) raises
    NotImplementedError (ROADMAP §1 item 9): under it each rank's
    gathered copy differs, so the ranks could not share one.

    `step.plans` is the one guarded axis plan the step runs (the bucket
    plan's on the bucketed path), `step.bucket_plan` the
    `PlannerService.BucketPlan` or None, `step.gather_buckets` /
    `step.scatter_buckets` the two halves' `Zero3Bucket`s (empty per
    leaf).

    metrics: "loss", the mean of the ranks' losses; "gnorm", the mean of
    the ranks' shard norms (the reference's `pmean`s); on a card,
    "events", CUDA events at the bounds of `PHASES` (`phase_ms`)."""
    from repro_torch.core.bucketing import (zero3_gather_bucketed,
                                            zero3_layout,
                                            zero3_scatter_bucket)
    from repro_torch.core.sync import check_plan_config

    dev = resolve_device(device)
    cfg = api.cfg
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the trainer takes the dense family; the "
            f"{cfg.family!r} family's training is ROADMAP §1 item 6")
    check_plan_config(sync)
    specs = tree_items(api.params_spec(param_dtype))
    paths = [p for p, _ in specs]
    numels = [math.prod(t.shape) for _, t in specs]
    shapes = [tuple(t.shape) for _, t in specs]
    shard_sizes = [-(-m // n) for m in numels]
    itemsize = torch.empty((), dtype=param_dtype).element_size()
    bplan = None
    if sync.bucket_bytes != 0:
        bplan, why = _bucket_plan(n, sync, sum(numels) * itemsize)
        if bplan is None:
            _log.warning("bucketed ZeRO-3 sync falls back to the per-leaf "
                         "path, as the reference's does: %s", why)
    if bplan is not None:
        plans = list(bplan.axis_plans)
    else:
        plans = resolve_axis_plans([("data", int(n))], sync,
                                   float(sum(shard_sizes)))
        for path, numel, size in zip(paths, numels, shard_sizes):
            padded = numel
            for pl in plans:
                nb = pl.schedule.num_blocks
                padded = -(-padded // nb) * nb
            if padded != size * n:
                raise ValueError(
                    f"leaf {'/'.join(path)}: the plan's reduce-scatter "
                    f"shards hold {padded // n} elements, its parameter "
                    f"shards {size} ({plans[0].schedule.describe()})")
    for pl in plans:
        if pl.schedule.wire is not None:
            raise NotImplementedError(
                f"the {pl.schedule.wire.name} wire in the ZeRO-3 trainer: "
                "under a lossy all-gather each rank's gathered copy "
                "differs, so the ranks cannot share one (ROADMAP §1 "
                "item 9)")
    gather_buckets = scatter_buckets = []
    if bplan is not None:
        k = plans[0].schedule.blocks_per_shard
        dts, its = [param_dtype] * len(numels), [itemsize] * len(numels)
        gather_buckets = zero3_layout(numels, dts, its, max(
            1, bplan.bucket_bytes // n), n, k, by_shard=True)
        scatter_buckets = zero3_layout(numels, dts, its, bplan.bucket_bytes,
                                       n, k)
    slot = {i: (b, j) for b, bk in enumerate(scatter_buckets)
            for j, i in enumerate(bk.indices)}
    tracer = default_tracer()

    def mark() -> torch.cuda.Event | None:
        if dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def gather(shards: list[torch.Tensor]) -> list[torch.Tensor]:
        if bplan is not None:
            return zero3_gather_bucketed(
                shards, [(shape, s.dtype) for shape, s in zip(shapes,
                                                              shards)],
                plans[0], bplan.bucket_bytes, n, shared=True)
        out = []
        for s, numel, shape, path in zip(shards, numels, shapes, paths):
            full = _gather_leaf(s, numel, plans)
            if not torch.equal(full[1:], full[:1].expand(n - 1, -1)):
                raise RuntimeError(f"leaf {'/'.join(path)}: the gathered "
                                   "rows of the ranks differ")
            out.append(full[0].reshape(shape).clone())
            del full
        return out

    def grad_buffers(shards: list[torch.Tensor]) -> tuple[list, Callable]:
        """The tensors rank r's gradients land in, and the function that
        writes rank r's gradient of leaf i there."""
        if bplan is None:
            bufs = [torch.empty((n, m), dtype=s.dtype, device=s.device)
                    for m, s in zip(numels, shards)]
            return bufs, lambda r, i, g: bufs[i][r].copy_(g.reshape(-1))
        bufs = [bk.matrix(n, shards[0].device) for bk in scatter_buckets]

        def put(r, i, g):
            if i in slot:                 # an empty leaf is in no bucket
                b, j = slot[i]
                scatter_buckets[b].write(bufs[b][r], j, g.reshape(-1))
        return bufs, put

    def reduce_scatter(bufs: list) -> list[torch.Tensor]:
        if bplan is None:
            out = []
            for i in range(len(bufs)):
                out.append(_scatter_leaf(bufs[i], plans))
                bufs[i] = None
            return out
        out: list = [torch.zeros((n, 0), dtype=param_dtype, device=dev)
                     ] * len(numels)
        order = range(len(scatter_buckets))
        for b in (reversed(order) if sync.backward_overlap else order):
            bk = scatter_buckets[b]
            for i, s in zip(bk.indices,
                            zero3_scatter_bucket(bufs[b], bk, plans[0])):
                out[i] = s
            bufs[b] = None
        return out

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        shards, opt = state["params"], state["opt"]
        if [tuple(s.shape) for s in shards] != [(n, m) for m in
                                                shard_sizes]:
            raise ValueError(f"state shards {[tuple(s.shape) for s in shards]}"
                             f" are not {cfg.name}'s (n, shard) leaves")
        if bplan is not None and any(s.dtype != param_dtype
                                     for s in shards):
            raise ValueError(f"the bucket plan is priced for {param_dtype} "
                             f"shards; the state holds "
                             f"{sorted({str(s.dtype) for s in shards})}")
        events = [mark()]
        with tracer.span("train/gather", leaves=len(shards)):
            full = gather(shards)
        events.append(mark())
        bufs, put = grad_buffers(shards)
        losses = []
        with tracer.span("train/forward_backward", ranks=n):
            for r in range(n):
                leaves = [f.detach().requires_grad_(True) for f in full]
                params = unstack_layers(tree_from_items(zip(paths, leaves)))
                loss = api.loss_fn(params, _rank_batch(batch, r, n),
                                   remat=True)
                for i, g in enumerate(torch.autograd.grad(loss, leaves)):
                    put(r, i, g)
                losses.append(loss.detach())
                del leaves, params, loss
        del full
        events.append(mark())
        with torch.no_grad():
            g_shards = []
            with tracer.span("train/reduce_scatter", leaves=len(shards)):
                for i, g in enumerate(reduce_scatter(bufs)):
                    if g.shape != (n, shard_sizes[i]):
                        raise RuntimeError(
                            f"leaf {'/'.join(paths[i])}: reduce-scattered "
                            f"to {tuple(g.shape)}, its shards are "
                            f"{(n, shard_sizes[i])}")
                    g_shards.append(g / n)
            del bufs
            events.append(mark())
            with tracer.span("train/adamw", ranks=n):
                gnorms = []
                for r in range(n):
                    rows = [[t[r] for t in ts] for ts in
                            (shards, g_shards, opt["m"], opt["v"])]
                    new_p, new_o, gn = adamw_update(
                        rows[0], rows[1], {"m": rows[2], "v": rows[3],
                                           "step": opt["step"]}, opt_cfg)
                    for dst, src in zip(rows[0] + rows[2] + rows[3],
                                        new_p + new_o["m"] + new_o["v"]):
                        dst.copy_(src)
                    gnorms.append(gn)
                opt["step"] = new_o["step"]
            events.append(mark())
            metrics = {"loss": torch.stack(losses).mean(),
                       "gnorm": torch.stack(gnorms).mean()}
        if dev.type == "cuda":
            metrics["events"] = events
        return state, metrics

    step.plans = plans
    step.bucket_plan = bplan
    step.gather_buckets = gather_buckets
    step.scatter_buckets = scatter_buckets
    return step


def phase_ms(metrics: dict) -> dict[str, float] | None:
    """Device time of each of `PHASES` in one step, in ms, from the CUDA
    events of its metrics (waits for the last); None off the card."""
    ev = metrics.get("events")
    if not ev:
        return None
    ev[-1].synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1])
            for i, name in enumerate(PHASES)}


def observe_sync_probe(*args, **kw):
    """The reference times each axis's schedule alone on its mesh and
    feeds the planner. On the local mesh such a time measures one
    device's launches, not the axis's links: the probe waits for the
    multi-process executor."""
    raise NotImplementedError(
        "observe_sync_probe: timing an axis's schedule needs one device "
        "a rank, the multi-process executor (ROADMAP §1 item 4)")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainConfig:
    arch: str = "stablelm-12b"
    steps: int = 50
    seq_len: int = 128
    global_batch: int = 8
    engine: str = "auto"            # auto (ROADMAP §1 item 4) | manual
    sync: str = "auto"              # plan; the flat labels are item 4
    # backward-overlapped bucket issuance (DESIGN.md §15): the gradient
    # buckets reduce last first; False keeps forward order
    backward_overlap: bool = True
    lr: float = 1e-3
    ckpt_dir: str | None = None     # ROADMAP §1 item 5
    seed: int = 0
    log_every: int = 10
    # the reference probes the schedule after training and feeds the
    # planner; on the local mesh that is item 4, so it is off here and
    # True raises
    observe_sync: bool = False
    # export a Chrome trace of the run's spans / the metrics registry
    trace_path: str | None = None
    metrics_path: str | None = None
    fault_plan: str | None = None   # ROADMAP §1 item 5
    # ranks of the local mesh: the leading axis of every shard tensor
    local_ranks: int = 8
    device: str = "cuda"


def _check_train_scope(tc: TrainConfig) -> None:
    if tc.engine != "manual":
        raise NotImplementedError(
            f"engine={tc.engine!r}: the single-program sharded engine needs "
            "the multi-process executor and DTensor placements (ROADMAP §1 "
            "items 4 and 6); the port runs engine='manual'")
    if tc.sync != "plan":
        raise NotImplementedError(
            f"sync={tc.sync!r}: the flat strategies need the multi-process "
            "executor (ROADMAP §1 item 4); the port runs sync='plan'")
    if tc.ckpt_dir is not None:
        raise NotImplementedError(
            "checkpointing and the fault-tolerant loop (ckpt_dir) are "
            "ROADMAP §1 item 5")
    if tc.fault_plan is not None:
        raise NotImplementedError(
            "the fault injector (fault_plan) is ROADMAP §1 item 5")
    if tc.observe_sync:
        observe_sync_probe()


def run_training(tc: TrainConfig, smoke: bool = True, on_log=print) -> dict:
    """Train `tc.arch` (smoke-shrunk unless `smoke` is False) from random
    bf16 weights for `tc.steps` steps on a local mesh of `tc.local_ranks`
    ranks on `tc.device`, with the reference's planned sync,
    `SyncConfig(strategy=tc.sync, backward_overlap=tc.backward_overlap)`:
    bucketed, GenModel picking the bucket. Returns the state, the
    per-step losses and gnorms, host-clock step times (each ending in the
    loss's copy to the host), per-step device times of `PHASES` on a
    card, the axis plans, the bucket plan and the model config."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.runtime.metrics import default_metrics

    _check_train_scope(tc)
    dev = resolve_device(tc.device)
    cfg = get_config(tc.arch)
    if smoke:
        cfg = smoke_config(cfg)
    api = build(cfg)
    n = int(tc.local_ranks)
    step_fn = make_manual_train_step(
        api, n, AdamWConfig(lr=tc.lr),
        sync=SyncConfig(strategy=tc.sync,
                        backward_overlap=tc.backward_overlap), device=dev)
    bp = step_fn.bucket_plan
    if bp is not None:
        on_log(f"planner: bucket plan {bp.bucket_bytes} bytes, "
               f"{len(step_fn.scatter_buckets)} gradient bucket(s), "
               f"{bp.overlap.get('mode', 'sequential')} issuance, "
               f"{bp.precision}, predicted {bp.predicted_contended * 1e3:.3f}"
               f" ms; {bp.axis_plans[0].schedule.describe()}")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len,
                                  global_batch=tc.global_batch,
                                  seed=tc.seed))
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    shards = shard_params_zero3(api.init_params(gen, torch.bfloat16, dev), n)
    state = {"params": shards, "opt": adamw_init(shards)}

    tracer = default_tracer()
    if tc.trace_path:
        tracer.enabled = True
    step_hist = default_metrics().histogram(
        "train_step_seconds", "wall time per training step",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))

    losses, gnorms, step_s, phases = [], [], [], []
    for s in range(tc.steps):
        t0 = time.perf_counter()
        with tracer.span("train/step", step=s):
            batch = {k: torch.as_tensor(np.asarray(v), device=dev).long()
                     for k, v in data.batch_at(s).items()}
            state, metrics = step_fn(state, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        dt = time.perf_counter() - t0
        step_hist.observe(dt)
        losses.append(loss)
        gnorms.append(gnorm)
        step_s.append(dt)
        phases.append(phase_ms(metrics))
        if s % tc.log_every == 0:
            on_log(f"step {s:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}")

    from repro_torch.planner.service import default_service
    st = default_service().stats()
    cs = st["cache"]
    on_log(f"planner cache: {st['entries']} entries, {cs['hits']} hits / "
           f"{cs['misses']} misses"
           + (f", {cs['disk_loads']} loaded from disk"
              if cs["disk_loads"] else ""))
    if tc.trace_path:
        tracer.export_chrome(tc.trace_path)
        on_log(f"trace: {len(tracer.spans)} spans -> {tc.trace_path}")
    if tc.metrics_path:
        default_metrics().export(tc.metrics_path)
        on_log(f"metrics -> {tc.metrics_path}")
    return {"state": state, "losses": losses, "gnorms": gnorms,
            "step_s": step_s, "phase_ms": phases, "plans": step_fn.plans,
            "bucket_plan": step_fn.bucket_plan, "config": cfg}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--sync", default="auto")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome-trace JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="export a metrics snapshot (JSON + .prom)")
    ap.add_argument("--faults", default=None, metavar="SPEC")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="train the smoke-size config (the reference's "
                    "run_training default)")
    args = ap.parse_args()
    out = run_training(TrainConfig(
        arch=args.arch, steps=args.steps, engine=args.engine,
        sync=args.sync, seq_len=args.seq_len, global_batch=args.batch,
        ckpt_dir=args.ckpt_dir, trace_path=args.trace,
        metrics_path=args.metrics, fault_plan=args.faults,
        device=args.device), smoke=args.smoke)
    print(f"final loss: {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
