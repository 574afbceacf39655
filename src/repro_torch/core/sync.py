"""Gradient synchronization strategies on the local mesh: where GenTree
meets the trainer.

From the reference `core/sync.py`: which Table-5 level class prices each
mesh-axis position, the single-switch stand-in topology an axis is
planned on, the per-axis plans (`plan_axes_gentree`,
`resolve_axis_plans`: the flat labels psum, ring, rhd, cps and hcps;
"gentree", the planner's label per axis; "plan", the GenTree plan
lowered to a schedule and bound to the wire the config asks for), the
trainer's `SyncConfig`, the expert-parallel all-to-all context, the
int8 CPS and top-k AllReduces, and `sync_gradients`.

Gradients are local-mesh tensors (`core.collectives`): their leading
dimensions are the mesh axes, row r of an axis rank r's gradient. Every
sum on a CUDA tensor is a `fused_reduce` launch (the top-k AllReduce
scatter-adds its sparse pairs with `index_add_`, as the reference's
scatter-add). The bucketed path is `core.bucketing.sync_bucketed`.
`sync_gradients` and `sync_bucketed` also run on a process mesh (one
process a rank, `core.transport`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.launch import analysis

from . import collectives
from .cost_model import GPU_AXIS_BASIS, GenModelParams, best_flat_plan


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    axis: str
    strategy: str                   # psum | ring | rhd | cps | hcps | plan
    factors: tuple[int, ...] | None = None
    # strategy == "plan": the lowered GenTree schedule to execute
    # (core.lower.CompiledSchedule; compared/hashed by identity)
    schedule: object | None = None
    # modeled cost of this axis's plan at the priced size (seconds) —
    # what the runtime pairs with measured timings when it feeds the
    # online loop (PlannerService.observe, DESIGN.md §10)
    predicted: float | None = None


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """strategy: auto|psum|ring|rhd|cps|hcps|gentree|plan per DP axis.
    "gentree" picks a flat plan-type label per axis; "plan" lowers the
    GenTree Plan IR itself and executes its compiled schedule — bucketed
    and pipelined by default: bucket_bytes=None lets GenModel pick the
    bucket size, an explicit value pins it, and 0 disables bucketing
    (per-leaf execution). pipeline=False runs buckets back-to-back.
    The reference's fields and defaults.
    """
    strategy: str = "auto"
    factors: tuple[int, ...] | None = None   # for explicit hcps
    compress: str | None = None              # None | "int8"
    params: dict[str, GenModelParams] | None = None
    bucket_bytes: int | None = None          # None=auto | 0=off | fixed
    pipeline: bool = True                    # double-buffer RS/AG halves
    # buckets go in reverse-layer readiness order (bucketed path only)
    backward_overlap: bool = True
    # wrap executed schedules in core.lower.GuardedSchedule (counts
    # launches, records and re-raises failures)
    guard: bool = True
    # wire precision name ("f32"|"bf16"|"fp8"|"int8") and the relative
    # gradient error the caller accepts
    precision: str | None = None
    tolerance: float | None = None


# Table-5 class per mesh-axis position: the leaf axis rides the fast
# in-machine fabric ("root_sw" pricing), every outer axis the slower
# between-machine fabric ("cross_dc"). Uncalibrated, "root_sw" prices
# at the GPU testbed's NVLink row (`cost_model.GPU_AXIS_BASIS`).
AXIS_LEVELS = ("root_sw",) + ("cross_dc",) * 8


def axis_level(i: int) -> str:
    return AXIS_LEVELS[min(i, len(AXIS_LEVELS) - 1)]


def level_switch_topo(n: int, params: dict[str, GenModelParams],
                      level: str):
    """Single-switch stand-in for a mesh axis at a Table-5 level class:
    one switch, n servers whose uplink bandwidth realizes the level's β
    (seconds per 4-byte unit → bytes/s), pricing α/γ/δ/ε/w_t coming from
    the params table. The ONE synthesis shared by axis pricing
    (`plan_axes_gentree`) and axis execution
    (`PlannerService.get_axis_executable`) — the executed plan must be
    the plan the model priced."""
    from .topology import single_switch
    p = params.get(level, params["server"])
    bw = 4.0 / p.beta if p.beta > 0 else 1e18
    return single_switch(int(n), bw=bw, lat=0.0, level=level)


def plan_axes_gentree(axes: Sequence[tuple[str, int]], size_floats: float,
                      params: dict[str, GenModelParams] | None = None, *,
                      engine: str | None = None,
                      gentree_kwargs: dict | None = None) -> list[AxisPlan]:
    """Per-level plan selection for a hierarchical mesh.

    axes: [(axis_name, size), ...] ordered leaf-level first. Level 0
    prices with the in-machine parameters, outer levels with the
    between-machine parameters (`axis_level`).

    With default `engine`/`gentree_kwargs` each axis is priced by the
    GenModel closed forms (`best_flat_plan`). When either is configured,
    the axis is priced by running GenTree itself on the equivalent
    single-switch topology with exactly that engine and those kwargs.
    """
    params = params or GPU_AXIS_BASIS
    gkw = dict(gentree_kwargs or {})
    use_gentree = engine is not None or bool(gkw)
    out: list[AxisPlan] = []
    for i, (name, n) in enumerate(axes):
        lvl = axis_level(i)
        p = params[lvl]
        # the γ/δ terms always price at the chip ("server") level
        srv = params["server"]
        p = dataclasses.replace(p, gamma=srv.gamma, delta=srv.delta)
        if n == 1:
            continue
        if use_gentree:
            from .gentree import gentree as run_gentree
            topo = level_switch_topo(n, {lvl: p, "server": srv}, lvl)
            res = run_gentree(topo, size_floats,
                              params={lvl: p, "server": srv},
                              engine=engine, **gkw)
            dec = res.decisions[topo.name]
            kind = "cps" if dec.algo == "acps" else dec.algo
            fac = dec.factors
            cost = dec.cost
        else:
            kind, fac, cost = best_flat_plan(n, size_floats, p)
        out.append(AxisPlan(name, kind, tuple(fac) if fac else None,
                            predicted=float(cost)))
    return out


SYNC_STRATEGIES = ("auto", "psum", "ring", "rhd", "cps", "hcps",
                   "gentree", "plan")


def check_plan_config(cfg: SyncConfig) -> None:
    """A strategy label the reference knows and a `compress` it takes
    (None or "int8"); ValueError otherwise."""
    if cfg.strategy not in SYNC_STRATEGIES:
        raise ValueError(f"unknown sync strategy {cfg.strategy!r}; one of "
                         f"{SYNC_STRATEGIES}")
    if cfg.compress not in (None, "int8"):
        raise ValueError(f"unknown compress {cfg.compress!r}; None or "
                         "'int8'")


def resolve_axis_plans(axes: Sequence[tuple[str, int]], cfg: SyncConfig,
                       size_floats: float) -> list[AxisPlan]:
    """Per-axis plan resolution shared by the gradient-sync and ZeRO-3
    engines, for each axis of size > 1.

    "gentree": the process-wide planner service's `get_axis_plans`
    (`cfg.params` honoured). "plan": the planner's executable
    (`get_axis_executable` at the axis's Table-5 class), bound to the
    wire `cfg.precision` asks for within `cfg.tolerance`
    (`cost_model.resolve_precision`: a precision whose error budget
    exceeds the tolerance clamps to f32), wrapped in the schedule guard
    unless `cfg.guard` is off; the level index counts the original axis
    position (size-1 axes keep their level). A flat label is the axis's
    plan as it is, hcps with `cfg.factors` where they multiply to the
    axis size, else the axis's first factorization, or cps on a prime
    axis."""
    import math
    from .plans import factorizations

    check_plan_config(cfg)
    if cfg.strategy == "gentree":
        from repro_torch.planner.service import default_service
        return default_service().get_axis_plans(axes, size_floats,
                                                params=cfg.params)
    if cfg.strategy != "plan":
        def axis_plan(a: str, n: int) -> AxisPlan:
            if cfg.strategy != "hcps":
                return AxisPlan(a, cfg.strategy, cfg.factors)
            if cfg.factors and math.prod(cfg.factors) == n:
                return AxisPlan(a, "hcps", tuple(cfg.factors))
            facs = factorizations(n)
            if facs:
                return AxisPlan(a, "hcps", tuple(facs[0]))
            return AxisPlan(a, "cps", None)
        return [axis_plan(a, n) for a, n in axes if n > 1]
    from repro_torch.core.lower import guard_schedule
    from repro_torch.planner.service import default_service
    svc = default_service()
    wire = None
    if cfg.precision is not None:
        from .cost_model import resolve_precision
        prec = resolve_precision(cfg.precision, cfg.tolerance)
        wire = prec if prec.name != "f32" else None
    out = []
    for i, (a, n) in enumerate(axes):
        if n <= 1:
            continue
        resp = svc.get_axis_executable(a, n, size_floats,
                                       level=axis_level(i),
                                       params=cfg.params)
        sched = resp.schedule
        if wire is not None:
            # a wire-bound copy: its guard wrapper is memoized apart from
            # the full-precision users of the same cached schedule
            sched = sched.with_wire(wire)
        if cfg.guard:
            sched = guard_schedule(sched,
                                   telemetry=getattr(svc, "telemetry", None))
        out.append(AxisPlan(a, "plan", schedule=sched,
                            predicted=resp.predicted_time))
    return out


# ---------------------------------------------------------------------------
# Expert-parallel AllToAll context: the trainer opens `expert_parallel(...)`
# around the loss so the MoE layer's dispatch/combine exchanges run over
# the right mesh axis — and, under strategy="plan", from the lowered
# all_to_all plan instead of one copy.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EPContext:
    axis: str                       # mesh axis the experts shard over
    size: int                       # axis size (number of expert groups)
    # lowered family="all_to_all" CompiledSchedule (possibly guarded);
    # None ⇒ collectives.all_to_all's one copy
    schedule: object | None = None
    # the process mesh this process is one rank of (each rank runs its
    # own MoE layers and exchanges over the axis's process group); None:
    # the local mesh, every rank at once (`layers.moe_ep`)
    mesh: object | None = None

    def index(self, mesh, r: int) -> int:
        """The index along this axis of rank r, the row-major index on
        the local mesh's (axis, size) pairs `mesh`: the expert group it
        owns. On a process mesh r is its own rank, and the index its
        coordinate on the axis."""
        if collectives.is_process_mesh(mesh):
            if mesh.axis_size(self.axis) != self.size or r != mesh.rank:
                raise ValueError(f"the EP axis ({self.axis!r}, {self.size})"
                                 f" and rank {r} on the process mesh "
                                 f"{list(mesh.axes)} of rank {mesh.rank}")
            return mesh.index(self.axis)
        names = [a for a, _ in mesh]
        sizes = [int(s) for _, s in mesh]
        if self.axis not in names or sizes[names.index(self.axis)] \
                != self.size:
            raise ValueError(f"the EP axis ({self.axis!r}, {self.size}) is "
                             f"not an axis of the local mesh {list(mesh)}")
        stride = math.prod(sizes[names.index(self.axis) + 1:])
        return r // stride % self.size


_EP_CONTEXT: list = [None]


def ep_context() -> EPContext | None:
    """The active expert-parallel context, if any."""
    return _EP_CONTEXT[0]


class expert_parallel:
    """Context manager installing an EPContext for the enclosed calls
    (`mesh`: the process mesh this process is a rank of, or None)."""

    def __init__(self, axis: str, size: int, schedule=None, mesh=None):
        self._ctx = EPContext(axis, int(size), schedule, mesh)
        self._prev = None

    def __enter__(self) -> EPContext:
        self._prev = _EP_CONTEXT[0]
        _EP_CONTEXT[0] = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _EP_CONTEXT[0] = self._prev
        return False


def ep_all_to_all(x: torch.Tensor, axis_name: str, *, mesh=None
                  ) -> torch.Tensor:
    """AllToAll for the MoE dispatch/combine: the active EPContext's
    planned schedule when it matches `axis_name`, the plain exchange
    otherwise."""
    ctx = _EP_CONTEXT[0]
    sched = ctx.schedule if ctx is not None and ctx.axis == axis_name \
        else None
    return collectives.all_to_all(x, axis_name, schedule=sched, mesh=mesh)


# exchanges `ep_exchange` ran, by direction: "forward" counts the forward
# pass and every recompute of it under activation checkpointing,
# "backward" the cotangent exchanges
EP_EXCHANGES = {"forward": 0, "backward": 0}


def _ep_run(x: torch.Tensor, axis_name: str, schedule, mesh) -> torch.Tensor:
    """One exchange of `x` (no autograd): the planned schedule or the flat
    copy program."""
    return collectives.all_to_all(x, axis_name, schedule=schedule, mesh=mesh)


class _EPExchange(torch.autograd.Function):
    """The owner-major AllToAll as an autograd op. Rank d's chunk j goes
    to rank j as chunk d: a permutation that is its own inverse, so the
    transpose of the exchange is the exchange, as the reference's
    `lax.all_to_all` / planned schedule transposes. Both directions run
    the schedule resolved at the forward call (the trainer's EPContext),
    so a backward outside the context still takes the planned path."""

    @staticmethod
    def forward(ctx, x, axis_name, schedule, mesh):
        ctx.axis_name, ctx.schedule, ctx.mesh = axis_name, schedule, mesh
        EP_EXCHANGES["forward"] += 1
        return _ep_run(x, axis_name, schedule, mesh)

    @staticmethod
    def backward(ctx, g):
        EP_EXCHANGES["backward"] += 1
        return (_ep_run(g.contiguous(), ctx.axis_name, ctx.schedule,
                        ctx.mesh), None, None, None)


@analysis.collective("all-to-all", collectives._census_axis)
def ep_exchange(x: torch.Tensor, axis_name: str, *, mesh=None
                ) -> torch.Tensor:
    """`ep_all_to_all`, differentiable: the MoE layer's dispatch and
    combine in a training graph. The forward and the backward each run
    the active EPContext's planned schedule (launching `fused_reduce`)
    when it matches `axis_name`, else the flat copy program; a CUDA
    tensor never takes another path."""
    ctx = _EP_CONTEXT[0]
    sched = ctx.schedule if ctx is not None and ctx.axis == axis_name \
        else None
    return _EPExchange.apply(x.contiguous(), axis_name, sched, mesh)


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of (R, L) f32 rows: scale = max|x| / 127
    + 1e-30 a row, q = clip(round(x / scale), −127, 127) (round half to
    even), as the reference's jnp ops."""
    scale = x.abs().amax(dim=1) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(
        torch.int8)
    return q, scale


@analysis.collective("all-reduce", collectives._census_axis)
def allreduce_int8_cps(x: torch.Tensor, axis_name: str, *, mesh=None
                       ) -> torch.Tensor:
    """CPS AllReduce with the int8 wire (gradient compression): each rank
    quantizes its rows with one f32 scale, rank i's chunk i of every rank
    is decoded (q·scale) and summed by ONE n-ary `fused_reduce` launch over
    all ranks, the shard is quantized again and gathered, and every rank
    decodes it. 4× less β/ε cost per the paper's model, at one extra γ/δ
    quantize pass. Returns x's shape and dtype.

    On a process mesh x is this rank's tensor: it quantizes its own row,
    exchanges its int8 chunks and its f32 scale over the axis's process
    group (`core.transport.exchange`, the bytes as they are), decodes
    each received chunk with its sender's scale, folds the n chunks in
    rank order with ONE `fused_reduce` launch, and gathers the
    re-quantized shard with the "cps" flat program: the local mesh's row
    of this rank, bit for bit."""
    import numpy as np

    from repro_torch.kernels import ops as kops
    if collectives.is_process_mesh(mesh):
        return _dist_int8_cps(x, axis_name, mesh)
    sizes, dim, n, R = collectives._axis(x, axis_name, mesh)
    if n == 1:
        return x
    flat, pad, _ = collectives._flat(x.float(), R, n)
    c = flat.shape[1] // n
    q, scale = _quantize_int8(flat)
    # row Q[i, g] is rank i of group g; its group's rows are Q[:, g]
    Q = collectives.axis_rows(sizes, (dim,))
    G = Q.shape[1]
    rank = np.empty(R, np.int64)
    rank[Q] = np.arange(n)[:, None]
    peers = np.empty((R, n), np.int64)
    peers[Q.reshape(-1)] = np.broadcast_to(Q.T[None], (n, G, n)).reshape(-1, n)
    rank = torch.from_numpy(rank).to(x.device)
    peers = torch.from_numpy(peers).to(x.device)
    # the all-to-all: rank i's operands are chunk i of its group's ranks,
    # each decoded with its sender's scale, then one n-ary fold
    deq = q.view(R, n, c)[peers, rank[:, None]].float() \
        * scale[peers][..., None]
    shard = kops.fused_reduce(deq)                              # (R, c)
    del deq
    qs, sc = _quantize_int8(shard)
    lead = tuple(x.shape[:len(sizes)])
    full = collectives.all_gather(
        (qs.float() * sc[:, None]).reshape(*lead, c), axis_name, "cps",
        mesh=mesh).reshape(R, -1)
    if pad:
        full = full[:, :-pad]
    return full.reshape(x.shape).to(x.dtype)


def _dist_int8_cps(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """`allreduce_int8_cps` as this rank of the process mesh `mesh`."""
    from repro_torch.kernels import ops as kops
    from .transport import exchange

    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    line = mesh.line(axis_name)
    me = line.index
    flat, pad, _ = collectives._flat1(x.float(), n)
    c = flat.numel() // n
    q, scale = _quantize_int8(flat.reshape(1, -1))
    chunks = q.view(n, c)
    got_q = torch.empty_like(chunks)
    got_s = torch.empty(n, dtype=scale.dtype, device=x.device)
    got_q[me] = chunks[me]
    got_s[me] = scale[0]
    peers = [p for p in range(n) if p != me]
    # to each peer its chunk and this rank's scale; from each its chunk
    # of this rank's shard and its scale, in the same order
    exchange(mesh, line,
             [s for p in peers for s in ((p, chunks[p]), (p, scale))],
             [r for p in peers for r in ((p, got_q[p]),
                                         (p, got_s[p:p + 1]))])
    deq = got_q.float() * got_s[:, None]
    shard = kops.fused_reduce(deq[None])                        # (1, c)
    del deq
    qs, sc = _quantize_int8(shard)
    full = collectives.all_gather((qs.float() * sc[:, None]).reshape(c),
                                  axis_name, "cps", mesh=mesh)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape).to(x.dtype)


def allreduce_topk(x: torch.Tensor, axis_name: str, k_frac: float = 0.01,
                   *, mesh=None) -> torch.Tensor:
    """Top-k sparsified AllReduce for the low-bandwidth hop: each rank
    keeps the k·|g| largest-magnitude entries (`torch.topk` on |x|), the
    (values, indices) pairs are gathered and scatter-added into a dense
    zero vector, a rank at a time in rank order (`index_add_`; within a
    rank the indices are distinct, so the sums are deterministic). Every
    rank gets the result. Error feedback is the caller's concern."""
    sizes, dim, n, R = collectives._axis(x, axis_name, mesh)
    flat = x.reshape(R, -1)
    L = flat.shape[1]
    k = max(1, int(L * k_frac))
    _, idx = torch.topk(flat.abs(), k, dim=1)
    vals = flat.gather(1, idx)
    Qn = collectives.axis_rows(sizes, (dim,))
    Q = torch.tensor(Qn, device=x.device)
    G = Q.shape[1]
    off = (torch.arange(G, device=x.device) * L)[:, None]
    acc = torch.zeros(G * L, dtype=flat.dtype, device=x.device)
    for r in range(n):
        acc.index_add_(0, (idx[Q[r]] + off).reshape(-1),
                       vals[Q[r]].reshape(-1))
    group = torch.empty(R, dtype=torch.long, device=x.device)
    group[Q.reshape(-1)] = torch.arange(G, device=x.device).repeat(n)
    return acc.view(G, L).index_select(0, group).reshape(x.shape)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def sync_gradients(grads, axes: Sequence[tuple[str, int]], cfg: SyncConfig,
                   stats: dict | None = None, *, mesh=None):
    """AllReduce every gradient leaf across the DP axes per the config.

    `grads` is a tree (dicts, lists, tuples) of local-mesh tensors on
    `mesh` (default: `axes` in the order given, one leading dimension an
    axis). Hierarchical, as the reference's: leaf-level axis first, then
    the outer axes, each over its own dimension with the other dimensions
    as groups.

      * "auto": one psum over every live axis at once;
      * "plan" with `bucket_bytes` other than 0: the bucketed path,
        `core.bucketing.sync_bucketed` (on several live axes the
        reference's hierarchical bucket chain);
      * otherwise per leaf: `resolve_axis_plans` at the summed per-rank
        size, each axis's collective in turn, with `compress="int8"` the
        int8 CPS AllReduce on cps and hcps axes.

    `stats`, when given, is filled with the resolved plans and their
    modeled costs (bucketed: the bucket plan's identity and quotes).
    Span `sync/gradients` on the per-leaf path.

    On a process mesh (`mesh` a `core.transport.ProcessMesh`, one process a
    rank) `grads` are this rank's own leaves; `axes` are the mesh's axes
    in the order to reduce them (leaf-first, as above), each priced at
    `axis_level` of its position there, and every sum runs over this
    rank's process group of the axis. The results equal the local
    mesh's rows bit for bit, `compress="int8"` included
    (`allreduce_int8_cps` over the axis's process group)."""
    if collectives.is_process_mesh(mesh):
        pm = dict(mesh.axes)
        for a, n in axes:
            if pm.get(a) != int(n):
                raise ValueError(f"axis ({a!r}, {n}) is not an axis of the "
                                 f"process mesh {list(mesh.axes)}")
        R = 1
    else:
        mesh = list(axes) if mesh is None else list(mesh)
        R = math.prod(int(s) for _, s in mesh)
    if cfg.strategy == "auto":
        names = [a for a, n in axes if n > 1]
        return _tree_map(lambda g: collectives.psum(g, names, mesh=mesh),
                         grads)

    if cfg.strategy == "plan" and cfg.bucket_bytes != 0:
        from .bucketing import sync_bucketed
        leaves = _tree_leaves(grads)
        done = {id(g): r for g, r in zip(
            leaves, sync_bucketed(leaves, axes, cfg, stats=stats,
                                  mesh=mesh))}
        return _tree_map(lambda g: done[id(g)], grads)

    plans = resolve_axis_plans(axes, cfg, size_floats=float(
        sum(g.numel() // R for g in _tree_leaves(grads))))
    if stats is not None:
        stats.update({
            "axis_plans": [(p.axis, p.strategy, p.predicted)
                           for p in plans],
            "predicted_total": (sum(p.predicted for p in plans)
                                if all(p.predicted is not None
                                       for p in plans) and plans
                                else None),
        })

    def leaf(g):
        for pl in plans:
            if cfg.compress == "int8" and pl.strategy in ("cps", "hcps"):
                g = allreduce_int8_cps(g, pl.axis, mesh=mesh)
            else:
                g = collectives.allreduce(g, pl.axis, pl.strategy,
                                          factors=pl.factors,
                                          schedule=pl.schedule, mesh=mesh)
        return g

    from repro_torch.runtime.trace import default_tracer
    with default_tracer().span("sync/gradients", strategy=cfg.strategy,
                               axes=len(plans)):
        return _tree_map(leaf, grads)
