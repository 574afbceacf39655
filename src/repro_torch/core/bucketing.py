"""Gradient bucketing and the bucketed plan executor on a local mesh
(DESIGN.md §9).

GenModel's terms pull the gradient bucket size in opposite directions:
the memory-access term (γ/δ) and the per-round launch term (α) penalize
many small reduces, while the incast (ε) and serialization terms
penalize one monolithic transfer whose rounds cannot overlap. So the
cost model picks the bucket size: `PlannerService.get_bucket_plan`
sweeps power-of-two candidates, prices each, and returns the argmin with
one lowered `CompiledSchedule` for the axis.

The pricing half is the reference package's, copied: `BucketConfig`
(its `key()` is part of the bucket-plan cache fingerprint), `Bucket`,
`partition`, and the time models the sweep prices (`serial_time`,
`pipelined_time`, `contended_pipelined_time`).

The executor half runs on the local mesh of `core.lower` and
`core.collectives`: the ranks are the rows of tensors on one device, and
a bucket is the (ranks, Σsize) column concatenation of its member
leaves. On one live axis the bucket is reduce-scattered and
all-gathered by one schedule launch each; on several it runs the
reference's hierarchical chain, one schedule a live axis in the bucket
plan's order (`collectives.reduce_scatter` / `all_gather` /
`allreduce` with `mesh=`), the all-gathers in reverse, each undoing its
axis's schedule padding. Every fold phase is one kernel launch on a
card (on several axes one a group of the other axes,
`collectives._per_group`).

  * `execute_buckets` — every bucket's RS then AG, in the reference's
    four issuance branches (merged, pipelined, sequential halves, whole
    AllReduce) and their spans; merged issuance on one live axis only,
    as the reference's;
  * `sync_bucketed` — the bucketed gradient AllReduce of
    `SyncConfig(strategy="plan")` over the live axes;
  * `zero3_layout`, `zero3_gather_bucketed`, `zero3_scatter_bucketed` —
    the ZeRO-3 trainer's bucketed parameter all-gather and gradient
    reduce-scatter, in the reference's bucket row layout (one axis, as
    the reference's);
  * `invalidate_schedules` — drops every lowered schedule and cached
    bucket plan of a service.

On a process mesh (one process a rank, `core.transport`) `execute_buckets`
and `sync_bucketed` run a rank's own leaves over its process groups, and
`zero3_gather_bucketed` / `zero3_scatter_bucket` (`mesh=`) are the
ZeRO-3 halves for one rank's shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.runtime.metrics import default_metrics
from repro_torch.runtime.trace import default_tracer

from .transport import is_process_mesh


# ---------------------------------------------------------------------------
# Config + bucket structure
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BucketConfig:
    """How gradients are bucketed for plan execution.

    bucket_bytes: None → "auto" (GenModel argmin over the sweep);
    an explicit int fixes the bucket size; 0 disables bucketing entirely
    (legacy per-leaf execution).

    precision pins a wire format by name ("f32"/"bf16"/"fp8"/"int8");
    None lets the sweep argmin over every format `tolerance` allows.
    tolerance is the caller's per-sync relative error budget: None means
    no lossy consent (the sweep stays lossless; a pinned lossy precision
    is trusted as explicit opt-in), a float clamps any format whose
    `Precision.error_budget` exceeds it to full precision
    (DESIGN.md §13). Both are part of `key()` — and therefore of the
    bucket-plan cache fingerprint — so a tolerance change can never be
    served a stale compressed schedule.
    """
    bucket_bytes: int | None = None
    pipeline: bool = True               # overlap AG(k) with RS(k+1)
    min_bucket_bytes: int = 1 << 18     # sweep floor (256 KiB)
    max_bucket_bytes: int = 1 << 28     # sweep ceiling (256 MiB)
    precision: str | None = None        # pinned wire format (None: sweep)
    tolerance: float | None = None      # error budget (None: lossless only)

    def __post_init__(self):
        if self.bucket_bytes is not None and self.bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be None (auto), 0 (off) or positive; "
                f"got {self.bucket_bytes}")
        if not 0 < self.min_bucket_bytes <= self.max_bucket_bytes:
            raise ValueError(
                f"need 0 < min_bucket_bytes <= max_bucket_bytes; got "
                f"{self.min_bucket_bytes}..{self.max_bucket_bytes}")
        if self.precision is not None:
            from .cost_model import PRECISIONS
            if self.precision not in PRECISIONS:
                raise ValueError(
                    f"unknown precision {self.precision!r}; one of "
                    f"{sorted(PRECISIONS)}")

    @property
    def enabled(self) -> bool:
        return self.bucket_bytes != 0

    def key(self) -> tuple:
        return (self.bucket_bytes if self.bucket_bytes is not None else -1,
                int(self.pipeline), self.min_bucket_bytes,
                self.max_bucket_bytes, self.precision or "",
                -1.0 if self.tolerance is None else float(self.tolerance))


@dataclass(frozen=True)
class Bucket:
    """One dtype-homogeneous group of leaf positions, bounded in size."""
    indices: tuple[int, ...]            # leaf positions (flattened order)
    sizes: tuple[int, ...]              # element count per member leaf
    dtype: object                       # shared numpy/jax dtype

    @property
    def size(self) -> int:
        return sum(self.sizes)


def partition(sizes: Sequence[int], dtypes: Sequence[object],
              cap: int | float,
              itemsizes: Sequence[int] | None = None) -> list[Bucket]:
    """Greedy, order-preserving partition of the flattened leaf list into
    dtype-homogeneous buckets. `cap` bounds each bucket's total *elements*
    — or total *bytes* when `itemsizes` (per-leaf element widths) is
    given, so a mixed f32/bf16 pytree honours one byte budget across both
    dtype classes instead of letting the wider dtype carry itemsize× the
    bound.

    Leaves keep their relative order within each dtype class; a leaf larger
    than the bound gets a bucket of its own; empty (size-0) leaves are
    assigned to no bucket (the executor passes them through unchanged).
    Buckets are returned ordered by their first member's leaf index, so the
    output is deterministic for a given leaf list.
    """
    cap = max(1, int(cap))
    weights = [int(s) for s in sizes] if itemsizes is None else \
        [int(s) * int(w) for s, w in zip(sizes, itemsizes)]
    open_by_dtype: dict[object, list[tuple[int, int]]] = {}
    open_weight: dict[object, int] = {}
    closed: list[list[tuple[int, int]]] = []

    def close(key):
        members = open_by_dtype.pop(key, None)
        open_weight.pop(key, None)
        if members:
            closed.append(members)

    for i, (sz, dt) in enumerate(zip(sizes, dtypes)):
        sz = int(sz)
        if sz == 0:
            continue
        key = str(dt)
        cur = open_by_dtype.setdefault(key, [])
        if cur and open_weight.get(key, 0) + weights[i] > cap:
            close(key)
            cur = open_by_dtype.setdefault(key, [])
        cur.append((i, sz))
        open_weight[key] = open_weight.get(key, 0) + weights[i]
        if weights[i] >= cap:
            close(key)
    for key in list(open_by_dtype):
        close(key)

    closed.sort(key=lambda members: members[0][0])
    return [Bucket(indices=tuple(i for i, _ in members),
                   sizes=tuple(s for _, s in members),
                   dtype=dtypes[members[0][0]])
            for members in closed]


# ---------------------------------------------------------------------------
# Pipeline time model (what the sweep prices)
# ---------------------------------------------------------------------------
def serial_time(t_rs: float, t_ag: float, k: int) -> float:
    """K buckets executed back-to-back: no overlap."""
    return max(0, k) * (t_rs + t_ag)


def pipelined_time(t_rs: float, t_ag: float, k: int) -> float:
    """Two-stage software pipeline: bucket k's AG overlaps bucket k+1's RS,
    so the steady state advances one bucket per max(T_RS, T_AG).

    This is the NAIVE model — it assumes the overlapped halves never share
    a link. Kept as the optimistic baseline the contended model is
    benchmarked against (`contended_vs_naive_pipeline_error`); the sweep
    itself ranks on `contended_pipelined_time`."""
    if k <= 0:
        return 0.0
    if k == 1:
        return t_rs + t_ag
    return t_rs + (k - 1) * max(t_rs, t_ag) + t_ag


def contended_pipelined_time(t_rs: float, t_ag: float, k: int,
                             t_joint: float | None = None) -> float:
    """Link-contention-aware pipeline model (DESIGN.md §15): the steady
    state advances one bucket per the CONTENDED concurrent time of the
    RS and AG halves — `t_joint`, priced by merging the halves' per-link
    occupancy vectors (`FastEngine.contended_pair_total` /
    `cost_model.contended_pair_time`) — not their optimistic `max()`.

    On disjoint links t_joint == max(t_rs, t_ag) and this reduces to
    `pipelined_time`; on shared links the serialized β/ε push it toward
    (and past — summed incast fan-in crossing w_t) t_rs + t_ag. The
    planner controls issuance, so the steady state never does worse than
    back-to-back halves: t_joint clamps to [max(t_rs, t_ag), t_rs + t_ag].
    """
    if k <= 0:
        return 0.0
    if k == 1:
        return t_rs + t_ag
    if t_joint is None:
        t_joint = max(t_rs, t_ag)
    t_joint = min(max(t_joint, max(t_rs, t_ag)), t_rs + t_ag)
    return t_rs + (k - 1) * t_joint + t_ag


# ---------------------------------------------------------------------------
# Executors (local mesh: leaves are (n, ...) tensors, row r rank r's)
# ---------------------------------------------------------------------------
def supports_halves(axis_plans) -> bool:
    """True when every axis schedule exposes the canonical RS/AG halves
    the double-buffered pipeline needs; otherwise execute_buckets runs
    each bucket's whole AllReduce in turn."""
    return all(pl.schedule is not None
               and getattr(pl.schedule, "blocks_per_shard", None)
               for pl in axis_plans)


def _lead(mesh) -> list[int]:
    """The leading sizes of a local-mesh tensor on `mesh`; none on a
    process mesh, where a rank's rows are its own (1, size)."""
    return [] if is_process_mesh(mesh) else [s for _, s in mesh]


def _rs_chain(rows: torch.Tensor, axis_plans, mesh
              ) -> tuple[torch.Tensor, list[int]]:
    """Hierarchical ReduceScatter of (R, size) mesh rows, the axes in the
    bucket plan's order: the final (R, shard) rows and each axis's
    pre-RS size a rank (the mirrored AG chain undoes the padding with
    them)."""
    from . import collectives
    lead = _lead(mesh)
    R = rows.shape[0]
    sizes = []
    for pl in axis_plans:
        sizes.append(int(rows.shape[1]))
        rows = collectives.reduce_scatter(
            rows.reshape(*lead, -1), pl.axis, "plan", schedule=pl.schedule,
            mesh=mesh).reshape(R, -1)
    return rows, sizes


def _ag_chain(shard: torch.Tensor, axis_plans, sizes, mesh) -> torch.Tensor:
    from . import collectives
    lead = _lead(mesh)
    R = shard.shape[0]
    for pl, sz in zip(reversed(axis_plans), reversed(sizes)):
        shard = collectives.all_gather(
            shard.reshape(*lead, -1), pl.axis, "plan", schedule=pl.schedule,
            mesh=mesh).reshape(R, -1)[:, :sz]
    return shard


def _allreduce_chain(rows: torch.Tensor, axis_plans, mesh) -> torch.Tensor:
    from . import collectives
    lead = _lead(mesh)
    for pl in axis_plans:
        rows = collectives.allreduce(rows.reshape(*lead, -1), pl.axis,
                                     "plan", schedule=pl.schedule,
                                     mesh=mesh).reshape(rows.shape)
    return rows


def execute_buckets(leaves: Sequence[torch.Tensor],
                    buckets: Sequence[Bucket], axis_plans, *,
                    pipeline: bool = True, merged=None,
                    reverse: bool = False, mesh=None) -> list[torch.Tensor]:
    """AllReduce every bucket over the local mesh's ranks: `leaves[i]` is
    an (n, ...) tensor, row r rank r's leaf, on the one axis of
    `axis_plans`; or, with `mesh` (the local mesh's (axis, size) pairs),
    a tensor leading with the mesh's sizes, reduced over every axis of
    `axis_plans` by the hierarchical chain in their order. Returns the
    reduced leaf list, every rank's copy of a bucketed leaf the sum over
    the axes (leaves outside any bucket, the empty ones, unchanged).

    Issuance as the reference's (DESIGN.md §9): each bucket moves
    QUEUED → RS → SHARD → AG → DONE with at most two in flight; step k
    issues RS(bucket k), then AG(bucket k−1). `reverse=True` issues the
    buckets last first, the order in which backward produces them
    (DESIGN.md §15); results land in leaf order either way. `merged` (a
    `core.overlap.MergedSchedule`, when the bucket plan's
    {sequential, merged} argmin chose it) runs each steady-state RS(k) +
    AG(k−1) pair as one interleaved launch. Without canonical halves
    each bucket runs its whole AllReduce. Spans: `bucket/rs`,
    `bucket/ag`, `bucket/rs_ag`, `bucket/allreduce`.

    On a process mesh (`mesh` a `core.transport.ProcessMesh`) each leaf is
    this rank's own, the chain runs the schedules' process-mesh entry
    points, and a merged issuance posts each step's rounds of both
    halves as one exchange (`MergedSchedule.rs_ag_mesh`)."""
    out = list(leaves)
    if not buckets:
        return out
    pm = is_process_mesh(mesh)
    if pm:
        n = 1
    elif mesh is None:
        if len(axis_plans) != 1:
            raise ValueError(f"{len(axis_plans)} axis plans need the local "
                             "mesh their leaves lie on (mesh=)")
        mesh = [(axis_plans[0].axis, leaves[buckets[0].indices[0]].shape[0])]
    if not pm:
        mesh = [(str(a), int(s)) for a, s in mesh]
        n = math.prod(s for _, s in mesh)
    flats = []
    for bk in buckets:
        parts = [leaves[i].reshape(n, -1) for i in bk.indices]
        flats.append(parts[0] if len(parts) == 1
                     else torch.cat(parts, dim=1))

    k = len(flats)
    order = list(range(k - 1, -1, -1)) if reverse else list(range(k))
    tracer = default_tracer()
    results: list = [None] * k
    halves = supports_halves(axis_plans)
    sizes: list = [None] * k

    def rs(i):
        shard, sizes[i] = _rs_chain(flats[i], axis_plans, mesh)
        return shard

    def gather(i, shard):
        return _ag_chain(shard, axis_plans, sizes[i], mesh)

    if merged is not None and pipeline and k > 1 and halves \
            and len(axis_plans) == 1:
        cs = axis_plans[0].schedule
        if pm:
            ax = axis_plans[0].axis

            def rs1(X):
                return cs.reduce_scatter(X[0], ax, mesh)[None]

            def ag1(S):
                return cs.all_gather(S[0], ax, mesh)[None]

            def pair(X, S):
                sh, full = merged.rs_ag_mesh(X[0], S[0], ax, mesh)
                return sh[None], full[None]
        else:
            rs1, ag1, pair = (cs.run_local_reduce_scatter,
                              cs.run_local_all_gather, merged.rs_ag)
        shards: list = [None] * k
        prev = None
        for i in order:
            if prev is None:
                with tracer.span("bucket/rs", bucket=i,
                                 elements=int(flats[i].shape[1])):
                    shards[i] = rs1(flats[i])
            else:
                with tracer.span("bucket/rs_ag", bucket=i, drains=prev):
                    shards[i], full = pair(flats[i], shards[prev])
                results[prev] = full[:, :flats[prev].shape[1]]
                shards[prev] = None
            prev = i
        with tracer.span("bucket/ag", bucket=prev):
            results[prev] = ag1(shards[prev])[:, :flats[prev].shape[1]]
    elif pipeline and k > 1 and halves:
        shards = [None] * k
        prev = None
        for i in order:
            with tracer.span("bucket/rs", bucket=i,
                             elements=int(flats[i].shape[1])):
                shards[i] = rs(i)
            if prev is not None:
                with tracer.span("bucket/ag", bucket=prev):
                    results[prev] = gather(prev, shards[prev])
                shards[prev] = None
            prev = i
        with tracer.span("bucket/ag", bucket=prev):
            results[prev] = gather(prev, shards[prev])
    elif halves:
        for i in order:
            with tracer.span("bucket/rs", bucket=i,
                             elements=int(flats[i].shape[1])):
                shard = rs(i)
            with tracer.span("bucket/ag", bucket=i):
                results[i] = gather(i, shard)
    else:
        # no canonical shard layout: each bucket's whole AllReduce
        for i in order:
            with tracer.span("bucket/allreduce", bucket=i,
                             elements=int(flats[i].shape[1])):
                results[i] = _allreduce_chain(flats[i], axis_plans, mesh)

    for bk, res in zip(buckets, results):
        off = 0
        for i, sz in zip(bk.indices, bk.sizes):
            out[i] = res[:, off:off + sz].reshape(leaves[i].shape)
            off += sz
    return out


def sync_bucketed(grads: Sequence[torch.Tensor],
                  axes: Sequence[tuple[str, int]], cfg, *, service=None,
                  stats: dict | None = None, mesh=None) -> list[torch.Tensor]:
    """Bucketed, double-buffered gradient AllReduce on the local mesh —
    the reference's `SyncConfig(strategy="plan")` path. `grads[i]` is a
    local-mesh tensor leading with the sizes of `mesh` (default: the live
    axes of `axes`, in their order; on one live axis of n ranks an (n,
    ...) tensor, row r rank r's gradient); returns the list with every
    rank's copy the sum over the live axes. The bucket size, the axis
    schedules (one a live axis, in the order of `axes`: the leaf axis
    first, as the reference's chain runs) and the issuance (merged or
    sequential; merged on one live axis only) come from
    `PlannerService.get_bucket_plan`, priced at one rank's total bytes
    in f32 units, with `cfg.params`, `cfg.bucket_bytes`, `cfg.pipeline`,
    `cfg.precision` and `cfg.tolerance`; a wire the plan binds runs the
    quantize / quant_reduce / dequantize kernels. `cfg.backward_overlap`
    issues the buckets last first; `cfg.guard` wraps the schedules in
    `core.lower.guard_schedule`.

    `stats`, when given, is filled with the plan's identity and modeled
    costs. Metrics: `sync_bucketed_total`, `sync_buckets_per_step`,
    `bucket_pipeline_occupancy`, `sync_bucketed_merged_issue_total`;
    span `sync/bucketed`.

    On a process mesh (`mesh` a `core.transport.ProcessMesh`) `grads` are
    this rank's own leaves and the buckets run over its process groups
    (`execute_buckets`); the sums equal the local mesh's rows bit for
    bit."""
    leaves = list(grads)
    live = [(a, int(n)) for a, n in axes if int(n) > 1]
    if is_process_mesh(mesh):
        pairs = list(mesh.axes)
    else:
        mesh = live if mesh is None else [(str(a), int(s))
                                          for a, s in mesh]
        pairs = mesh
    lead = tuple(_lead(mesh))
    R = math.prod(lead)
    for a, n in live:
        if dict(pairs).get(a) != n:
            raise ValueError(f"axis {a!r} of size {n} is not in the mesh "
                             f"{pairs}")
    for x in leaves:
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(f"sync_bucketed takes per-rank rows leading "
                             f"with the mesh's sizes {lead} "
                             f"({', '.join(a for a, _ in mesh)}); got a "
                             f"leaf of shape {tuple(x.shape)}")
    sizes = [int(x.numel()) // R for x in leaves]
    if not live or sum(sizes) == 0 or not leaves:
        return leaves

    if service is None:
        from repro_torch.planner.service import default_service
        service = default_service()
    bcfg = BucketConfig(bucket_bytes=cfg.bucket_bytes,
                        pipeline=cfg.pipeline,
                        precision=getattr(cfg, "precision", None),
                        tolerance=getattr(cfg, "tolerance", None))
    # price in f32-equivalent units of the total BYTES, so the byte
    # budget does not depend on which dtype flattens first
    itemsizes = [x.element_size() for x in leaves]
    total_bytes = sum(s * w for s, w in zip(sizes, itemsizes))
    bplan = service.get_bucket_plan(axes, total_bytes / 4.0,
                                    dtype="float32", params=cfg.params,
                                    config=bcfg)
    reverse = bool(getattr(cfg, "backward_overlap", True))
    merged = bplan.merged_schedule \
        if bplan.overlap.get("mode") == "merged" else None
    if stats is not None:
        stats.update({
            "key": bplan.key, "source": bplan.source,
            "axes": list(bplan.axes),
            "bucket_floats": bplan.bucket_floats,
            "bucket_bytes": bplan.bucket_bytes,
            "num_buckets": bplan.num_buckets,
            "precision": bplan.precision,
            "predicted_pipelined": bplan.predicted_pipelined,
            "predicted_serial": bplan.predicted_serial,
            "predicted_contended": bplan.predicted_contended,
            "overlap_mode": bplan.overlap.get("mode", "sequential"),
            "backward_overlap": reverse,
        })
    buckets = partition(sizes, [x.dtype for x in leaves],
                        bplan.bucket_bytes, itemsizes=itemsizes)
    m = default_metrics()
    m.counter("sync_bucketed_total",
              "bucketed plan-strategy gradient syncs").inc()
    m.histogram("sync_buckets_per_step",
                "buckets per sync_bucketed call",
                buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
                ).observe(float(len(buckets)))
    # modeled serial/contended speedup, normalized to [0.5, 1]: 0.5 for
    # one bucket (nothing overlaps), toward 1 as the halves balance
    contended = bplan.predicted_contended or bplan.predicted_pipelined
    if contended > 0.0:
        m.gauge("bucket_pipeline_occupancy",
                "modeled serial/contended speedup, normalized to [.5,1]"
                ).set(bplan.predicted_serial / (2.0 * contended))
    if merged is not None:
        m.counter("sync_bucketed_merged_issue_total",
                  "syncs issued with the merged RS/AG schedule "
                  "(planner argmin chose merged)").inc()
    axis_plans = bplan.axis_plans
    if getattr(cfg, "guard", True):
        import dataclasses

        from .lower import guard_schedule
        tele = getattr(service, "telemetry", None)
        axis_plans = [
            dataclasses.replace(pl, schedule=guard_schedule(
                pl.schedule, telemetry=tele))
            if pl.schedule is not None else pl
            for pl in axis_plans]
    with default_tracer().span("sync/bucketed", buckets=len(buckets),
                               bucket_bytes=bplan.bucket_bytes,
                               source=bplan.source,
                               overlap=bplan.overlap.get("mode",
                                                         "sequential"),
                               reverse=reverse):
        return execute_buckets(leaves, buckets, axis_plans,
                               pipeline=bcfg.pipeline, merged=merged,
                               reverse=reverse, mesh=mesh)


# ---------------------------------------------------------------------------
# ZeRO-3 bucketed halves (one DP axis; launch/train.py's manual engine)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Zero3Bucket:
    """One bucket of the reference's ZeRO-3 row layout
    (`zero3_scatter_bucketed` there): member leaf j, zero-padded to a
    multiple of n, gives its (n, chunks[j]) rows as columns
    [offsets[j], offsets[j] + chunks[j]) of an (n, width) matrix, width
    the chunks' sum padded to a multiple of the schedule's
    blocks_per_shard. Flattened row-major that matrix is the bucket's
    vector, and row i of its reduce-scatter is rank i's shard of every
    member. A rank's bucket vector is one row of an (n ranks,
    n·width) tensor (`matrix`)."""
    index: int
    indices: tuple[int, ...]          # member leaf positions
    numels: tuple[int, ...]           # each member's element count
    chunks: tuple[int, ...]           # each member's shard: ⌈numel / n⌉
    offsets: tuple[int, ...]          # each member's first column
    width: int
    dtype: object

    def columns(self, mat: torch.Tensor, j: int) -> torch.Tensor:
        """Member j's (..., n, chunk) view of (..., n·width) bucket rows."""
        rows = mat.unflatten(-1, (-1, self.width))
        return rows[..., self.offsets[j]:self.offsets[j] + self.chunks[j]]

    def write(self, mat: torch.Tensor, j: int, src: torch.Tensor,
              start: int = 0) -> None:
        """Member j's flat leaf (..., numel) into its columns of `mat`,
        row-major; the padding past numel is left as it is. With `start`,
        src is the leaf's elements [start, start + len) alone."""
        dst = self.columns(mat, j)
        c = self.chunks[j]
        pos, end, done = int(start), int(start) + int(src.shape[-1]), 0
        row, col = divmod(pos, c)
        if col and pos < end:              # up to the next row of chunks
            h = min(c - col, end - pos)
            dst[..., row, col:col + h].copy_(src[..., :h])
            pos, done = pos + h, h
        row, full = pos // c, (end - pos) // c
        if full:
            dst[..., row:row + full, :].copy_(
                src[..., done:done + full * c].unflatten(-1, (full, c)))
            pos, done = pos + full * c, done + full * c
        if pos < end:
            dst[..., pos // c, :end - pos].copy_(src[..., done:])

    def read(self, mat: torch.Tensor, j: int) -> torch.Tensor:
        """A new (..., numel) tensor: member j's flat leaf from its
        columns of `mat` (the inverse of `write`)."""
        src = self.columns(mat, j)
        c, numel = self.chunks[j], self.numels[j]
        full, part = divmod(numel, c)
        out = torch.empty((*src.shape[:-2], numel), dtype=src.dtype,
                          device=src.device)
        if full:
            out[..., :full * c].unflatten(-1, (full, c)).copy_(
                src[..., :full, :])
        if part:
            out[..., full * c:].copy_(src[..., full, :part])
        return out

    def matrix(self, n: int, device, rows: int | None = None
               ) -> torch.Tensor:
        """The bucket's (n ranks, n·width) tensor, written zero only where
        padding lies: past each member's numel in its columns, and the
        columns past the chunks' sum. `rows` other than n: that many rows
        (1 for one rank of a process mesh)."""
        mat = torch.empty((n if rows is None else rows, n * self.width),
                          dtype=self.dtype, device=device)
        for j, numel in enumerate(self.numels):
            dst = self.columns(mat, j)
            full, part = divmod(numel, self.chunks[j])
            if full < n:
                dst[..., full, part:].zero_()
                dst[..., full + 1:, :].zero_()
        used = sum(self.chunks)
        if used < self.width:
            mat.unflatten(-1, (-1, self.width))[..., used:].zero_()
        return mat

    def shards(self, shard: torch.Tensor) -> list[torch.Tensor]:
        """The members' (n, chunk) views of the (n, width) reduce-scatter
        result: row i rank i's shard of each (of one rank's (width,)
        shard, its (chunk,) views)."""
        return [shard[..., o:o + c]
                for o, c in zip(self.offsets, self.chunks)]


def zero3_layout(numels: Sequence[int], dtypes: Sequence[object],
                 itemsizes: Sequence[int], cap: int, n: int, k: int, *,
                 by_shard: bool = False) -> list[Zero3Bucket]:
    """The ZeRO-3 buckets of leaves of `numels` elements over `n` ranks
    for a schedule of `k` blocks a shard: `partition` under the byte cap
    `cap`, of the leaf sizes (the gradient reduce-scatter, cap the bucket
    bytes) or, with `by_shard`, of the shard sizes ⌈numel / n⌉ (the
    parameter all-gather, cap the bucket bytes // n), as the reference's
    two halves partition. Empty leaves are in no bucket."""
    chunks = [-(-int(m) // n) for m in numels]
    weights = chunks if by_shard else [int(m) for m in numels]
    out = []
    for bi, bk in enumerate(partition(weights, dtypes, cap,
                                      itemsizes=itemsizes)):
        cs = [chunks[i] for i in bk.indices]
        offsets = [sum(cs[:j]) for j in range(len(cs))]
        width = sum(cs)
        out.append(Zero3Bucket(
            index=bi, indices=bk.indices,
            numels=tuple(int(numels[i]) for i in bk.indices),
            chunks=tuple(cs), offsets=tuple(offsets),
            width=width + (-width) % k, dtype=bk.dtype))
    return out


def zero3_gather_bucketed(shards: Sequence[torch.Tensor], specs, plan,
                          bucket_bytes: int, n: int, *,
                          shared: bool = False, mesh=None
                          ) -> list[torch.Tensor]:
    """Bucketed parameter AllGather for the ZeRO-3 row layout.

    `shards[ℓ]` is leaf ℓ's (n, chunk_ℓ) shards, row i rank i's (the
    leaf flattened, zero-padded to a multiple of n, `shard_params_zero3`);
    `specs[ℓ] = (shape, dtype)` describes the full leaf. The shards of a
    bucket (cap `bucket_bytes // n`: the gather moves n× its input, so
    each launch moves the bucket size the sweep priced) concatenate into
    one row a rank, padded to the schedule's blocks_per_shard, and ONE
    `run_local_all_gather` a bucket reassembles every rank's (n, width)
    matrix, whose columns split back into the leaves. Span
    `bucket/zero3_ag`.

    Returns each leaf as (n, *shape), row r rank r's gathered copy; or,
    with `shared`, one copy of shape `shape`, after checking bucket by
    bucket and rank by rank that the ranks' gathered rows are equal
    (RuntimeError if not), since the ranks may then share it.

    On a process mesh (`mesh` a `ProcessMesh`) `shards[ℓ]` is this
    rank's (chunk_ℓ,) shard, each bucket is ONE `all_gather` over the
    plan's axis of its process group, and the result is this rank's own
    copy of each leaf, of shape `shape` (`shared` aside)."""
    cs = plan.schedule
    k = cs.blocks_per_shard
    pm = mesh is not None
    lead = () if pm else (n,)
    numels = [math.prod(shape) for shape, _ in specs]
    for s, m in zip(shards, numels):
        if tuple(s.shape) != (*lead, -(-m // n)):
            raise ValueError(f"shards of shape {tuple(s.shape)} are not "
                             f"the {(*lead, -(-m // n))} of a leaf of {m}")
    layout = zero3_layout(numels, [s.dtype for s in shards],
                          [s.element_size() for s in shards],
                          max(1, int(bucket_bytes) // max(1, int(n))), n, k,
                          by_shard=True)
    out: list = [None] * len(shards)
    tracer = default_tracer()
    for bk in layout:
        parts = [shards[i] for i in bk.indices]
        used = sum(bk.chunks)
        if used < bk.width:
            parts.append(parts[0].new_zeros((*lead, bk.width - used)))
        row = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        with tracer.span("bucket/zero3_ag", bucket=bk.index,
                         leaves=len(bk.indices)):
            full = (cs.all_gather(row, plan.axis, mesh) if pm
                    else cs.run_local_all_gather(row))
        del row, parts
        if shared and not pm:
            # a meta tensor (the dry run's) holds no values to compare
            for r in range(1, 1 if full.is_meta else n):
                if not torch.equal(full[r], full[0]):
                    raise RuntimeError(
                        f"bucket {bk.index}: the gathered rows of the "
                        f"ranks differ (rank {r} against rank 0)")
            full = full[0]
        for j, i in enumerate(bk.indices):
            shape, dtype = specs[i]
            lead = tuple(full.shape[:-1])
            out[i] = bk.read(full, j).reshape(*lead, *shape).to(dtype)
        del full
    for i, (shape, dtype) in enumerate(specs):
        if out[i] is None:          # empty leaf: nothing was gathered
            lead = () if shared or pm else (n,)
            out[i] = torch.zeros((*lead, *shape), dtype=dtype,
                                 device=shards[i].device)
    return out


def zero3_scatter_bucket(mat: torch.Tensor, bk: Zero3Bucket, plan,
                         mesh=None) -> list[torch.Tensor]:
    """Reduce-scatter one bucket's (n ranks, n·width) tensor IN PLACE (it
    is the schedule's working buffer and is overwritten): one launch,
    span `bucket/zero3_rs`. Returns each member's (n, chunk) shard of the
    ranks' sum, views of one (n, width) tensor. On a process mesh
    (`mesh`) `mat` is this rank's (n·width,) bucket vector, reduced over
    the plan's axis of its process group, and the shards are its
    (chunk,) views."""
    with default_tracer().span("bucket/zero3_rs", bucket=bk.index,
                               leaves=len(bk.indices)):
        shard = (plan.schedule.reduce_scatter(mat, plan.axis, mesh,
                                              overwrite=True)
                 if mesh is not None else
                 plan.schedule.run_local_reduce_scatter(mat, overwrite=True))
    return bk.shards(shard)


def zero3_scatter_bucketed(fulls: Sequence[torch.Tensor], plan,
                           bucket_bytes: int, n: int,
                           reverse: bool = False) -> list[torch.Tensor]:
    """Bucketed gradient ReduceScatter (the inverse layout of
    `zero3_gather_bucketed`): `fulls[ℓ]` is leaf ℓ's (n, ...) per-rank
    gradients. Each bucket's (n ranks, n·width) tensor is written once
    (`Zero3Bucket.matrix`, `write`: no concatenation copy) and ONE
    reduce-scatter a bucket, in place, returns row i: every member's
    shard i of the sum. Returns each leaf's (n, chunk_ℓ) shards.

    `reverse=True` issues the buckets last first, the order in which
    backward produces them (DESIGN.md §15); results are identical."""
    k = plan.schedule.blocks_per_shard
    numels = [int(x.numel()) // n for x in fulls]
    layout = zero3_layout(numels, [x.dtype for x in fulls],
                          [x.element_size() for x in fulls],
                          int(bucket_bytes), n, k)
    out: list = [None] * len(fulls)
    for bk in (reversed(layout) if reverse else layout):
        mat = bk.matrix(n, fulls[bk.indices[0]].device)
        for j, i in enumerate(bk.indices):
            bk.write(mat, j, fulls[i].reshape(n, -1))
        for i, s in zip(bk.indices, zero3_scatter_bucket(mat, bk, plan)):
            out[i] = s
        del mat
    for i, x in enumerate(fulls):
        if out[i] is None:          # empty leaf: empty shards
            out[i] = x.new_zeros((n, 0))
    return out


# ---------------------------------------------------------------------------
# Invalidation (elastic remesh / fault-tolerant resume)
# ---------------------------------------------------------------------------
def invalidate_schedules(service=None) -> int:
    """Drop every lowered `CompiledSchedule` and cached bucket plan
    derived from the service's plan cache (the priced plans survive).
    Returns the number of artifacts dropped. With `service=None` the
    process-wide default service is invalidated if it exists (never
    created just to be emptied). Call after any event that changes the
    executing mesh: a schedule compiled for the old axis size must not
    survive an axis-size change."""
    if service is None:
        from repro_torch.planner.service import peek_default_service
        service = peek_default_service()
        if service is None:
            return 0
    return service.invalidate_executables()
