"""Roofline terms of a step, and the census that counts them: the
counterpart of the reference's `launch/hlo_analysis.py`.

The reference parses the optimized HLO of a compiled step. The port has
no HLO, so the parser gets no copy; `census()` counts what runs instead.
Copied from the reference, names and fields kept: `ModuleStats`,
`mix_from_stats` (the whole-step planner's collective mix), `Roofline` /
`roofline_from_stats` and `model_flops_train` / `model_flops_forward`.

`census(ranks)` is a context manager that fills a `ModuleStats` for
whatever runs inside it, on the CPU, on the card or on the meta device
(where nothing is computed and every shape is still known):

  * FLOPs — 2·M·N·K a product, as the reference's `_dot_flops`, by
    `torch.utils.flop_counter`'s registry of aten ops (mm, bmm, addmm,
    baddbmm, convolution, attention); elementwise ops count none;
  * HBM bytes — every aten op that touches memory counts its tensor
    operands' and new results' bytes once (an in-place op its operands,
    the written one among them); views, metadata ops and `empty` are
    free, as the reference's `_FREE_OPS` are. Eager torch
    fuses nothing, so this count is the port's own: it is never held
    against XLA's fused count;
  * collectives — one record a logical collective call, by HLO kind
    (`all-reduce`, `reduce-scatter`, `all-gather`, `all-to-all`,
    `collective-permute`), at the choke points of `core.lower`,
    `core.collectives` and `core.sync`: the per-rank payload (the operand
    bytes, padded as the collective pads it; the gathered result bytes
    for an all-gather, the reference's convention), the group size n and
    the wire bytes by `cost_model.family_wire_bytes`. A call that goes
    through several choke points (a flat collective running a planned
    schedule a group at a time, the guard, `allreduce_planned`) is one
    record, of the outermost; inside it op counting is suspended, so the
    executor's copies and folds count once, as the collective (its
    operand and result bytes, as the reference counts a collective's HBM
    traffic);
  * kernel work — each wrapper of `kernels.ops` reports its function's
    work from the shapes alone (`KernelWork`: the FLOPs and the
    input-once / output-once bytes of the kernel table's bound column),
    and op counting is suspended inside it, so the CPU path (the plain
    version's ops) and the card path (one opaque launch) count the same;
  * peak live bytes — the storages the ops inside create (`empty`
    included), tracked until a weakref finalizer sees each freed (on the
    card and on meta alike).

The local mesh runs its n ranks in one process, so `Census.stats()`
divides the process's FLOPs and HBM bytes by the census's `ranks` for a
per-rank `ModuleStats`, as the reference's per-partition stats; the
collective records are per rank already.

When no census is open every hook costs one global load and one test,
as `runtime.trace` does; no kernel's launches change.

Roofline constants: the H100 SXM's data sheet figures, not measured:
989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s NVLink a direction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry as _FLOPS

from repro_torch.core.cost_model import family_wire_bytes

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s a card (H100 SXM data sheet)
HBM_BW = 3.35e12             # HBM3 bytes/s a card (data sheet)
LINK_BW = 450e9              # NVLink bytes/s a card a direction (data sheet)


@dataclasses.dataclass
class ModuleStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # raw payload bytes (the planner's M) — wire bytes live in coll_by_kind
    coll_payload_by_kind: dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add_coll(self, kind: str, b: float, n: int = 1,
                 payload: float | None = None) -> None:
        self.coll_bytes += b
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + b
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + n
        self.coll_payload_by_kind[kind] = \
            self.coll_payload_by_kind.get(kind, 0.0) \
            + (b if payload is None else payload)


# HLO op spelling → plan-IR family name (core.plans.FAMILIES)
_KIND_TO_FAMILY = {
    "all-reduce": "allreduce",
    "reduce-scatter": "reduce_scatter",
    "all-gather": "allgather",
    "all-to-all": "all_to_all",
    "collective-permute": "p2p",
}


def mix_from_stats(stats: ModuleStats, dsize: int = 4) -> dict:
    """Collective mix for `PlannerService.get_step_plan`: per family, the
    call count and the MEAN per-call payload in element units (raw
    payload bytes / count / dsize) — the planner re-prices wire bytes
    itself from the payload, so the wire-convention fix never double
    applies."""
    mix: dict[str, dict[str, float]] = {}
    for kind, cnt in stats.coll_counts.items():
        fam = _KIND_TO_FAMILY.get(kind)
        if fam is None or cnt <= 0:
            continue
        payload = stats.coll_payload_by_kind.get(
            kind, stats.coll_by_kind.get(kind, 0.0))
        mix[fam] = {"count": int(cnt),
                    "size_floats": float(payload) / cnt / dsize}
    return mix


@dataclasses.dataclass
class Roofline:
    flops: float                 # total FLOPs across all chips
    hbm_bytes: float             # total HBM bytes across all chips
    coll_bytes: float            # total collective bytes across all chips
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    coll_by_kind: dict[str, float]
    model_flops: float = 0.0

    @property
    def bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs time at peak vs the dominant-term time (an MFU-style
        score derivable without wall clocks)."""
        if self.bound <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound


def roofline_from_stats(per_device: ModuleStats, chips: int,
                        model_flops: float = 0.0) -> Roofline:
    """per_device: stats of ONE rank; totals are ×chips (so per-chip
    rates divide back out)."""
    flops = per_device.flops * chips
    hbm = per_device.hbm_bytes * chips
    cb = per_device.coll_bytes * chips
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = hbm / (chips * HBM_BW)
    coll_s = cb / (chips * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=cb, chips=chips,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dominant,
                    coll_by_kind={k: v * chips
                                  for k, v in per_device.coll_by_kind.items()},
                    model_flops=model_flops)


def model_flops_train(cfg, tokens: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per the assignment."""
    return 6.0 * cfg.active_params_count() * tokens


def model_flops_forward(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_params_count() * tokens


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CollRecord:
    """One logical collective call: its HLO kind, per-rank payload bytes,
    group size and per-rank wire bytes."""
    kind: str
    payload: float
    n: int
    wire: float


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """A kernel call's work from its shapes: FLOPs and the bytes it must
    move (each input read once, each output written once)."""
    flops: float
    nbytes: float


# ops that allocate and touch nothing, and ops that touch no memory
# (metadata, aliases)
_ALLOC_OPS = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
              torch.ops.aten.empty_like, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided}
_FREE_OPS = {torch.ops.aten.detach, torch.ops.aten.lift_fresh,
             torch.ops.aten.alias, torch.ops.aten._unsafe_view,
             torch.ops.aten.sym_size, torch.ops.aten.sym_stride,
             torch.ops.aten.sym_numel, torch.ops.aten.sym_storage_offset,
             torch.ops.aten.is_same_size, torch.ops.aten.resize_,
             torch.ops.aten.set_}


@functools.lru_cache(maxsize=None)
def _op_kind(func) -> str:
    """"alloc" (new storage, nothing touched), "free" (a view or
    metadata), "inplace" (writes an operand: no new storage; "inplace0"
    where it writes its first argument and returns it alone), or "new"
    (new storage, operands read and results written)."""
    if func.overloadpacket in _ALLOC_OPS:
        return "alloc"
    if func.overloadpacket in _FREE_OPS:
        return "free"
    schema = func._schema
    alias = [r.alias_info for r in schema.returns if r.alias_info is not None]
    if not alias:
        return "new"
    if not any(a.is_write for a in alias):
        return "free"
    first = schema.arguments[0].alias_info if schema.arguments else None
    if (len(schema.returns) == 1 and first is not None and first.is_write
            and set(first.before_set) == set(alias[0].before_set)):
        return "inplace0"
    return "inplace"


def _tensors(x, out: list) -> list:
    """`out` extended by the tensors of an op's arguments or results
    (tuples, lists and dicts of them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def tensor_bytes(x) -> int:
    """Bytes of the tensors in `x` (a tensor, or tuples, lists and dicts
    of them)."""
    n = 0
    for t in _tensors(x, []):
        n += t.numel() * t.element_size()
    return n


class Census:
    """What ran inside one `census()`: `total` (the process's FLOPs and
    HBM bytes), `records` (one `CollRecord` a collective call), `kernels`
    ({name: {"calls", "flops", "bytes"}}), `live_bytes` / `peak_bytes`
    (of the storages the ops inside created) and `ranks`."""

    def __init__(self, ranks: int = 1):
        if ranks < 1:
            raise ValueError(f"a census counts ranks >= 1; got {ranks}")
        self.ranks = int(ranks)
        self.total = ModuleStats()
        self.records: list[CollRecord] = []
        self.kernels: dict[str, dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}
        self._suspend = 0
        self._constants = 0
        self._rep = 1

    # ---- results -----------------------------------------------------------
    def stats(self) -> ModuleStats:
        """Per-rank `ModuleStats`: the process's FLOPs and HBM bytes over
        `ranks`, every collective record as it is (per rank already, its
        operand and result bytes added to the HBM bytes)."""
        s = ModuleStats(flops=self.total.flops / self.ranks,
                        hbm_bytes=self.total.hbm_bytes / self.ranks)
        for r in self.records:
            s.add_coll(r.kind, r.wire, payload=r.payload)
            s.hbm_bytes += _io_bytes(r.kind, r.payload, r.n)
        return s

    def kernel_work(self) -> dict[str, tuple[int, float, float]]:
        """{kernel: (calls, flops, bytes)}."""
        return {k: (int(v["calls"]), v["flops"], v["bytes"])
                for k, v in sorted(self.kernels.items())}

    # ---- hooks -------------------------------------------------------------
    def _count_op(self, func, args, kwargs, out, kind: str) -> None:
        rep = self._rep
        flops = _FLOPS.get(func.overloadpacket)
        if flops is not None:
            self.total.flops += rep * flops(*args, **kwargs, out_val=out)
        nb = tensor_bytes(args) + tensor_bytes(kwargs)
        if kind == "new":
            nb += tensor_bytes(out)
        self.total.hbm_bytes += rep * nb

    def _track(self, out) -> None:
        for t in _tensors(out, []):
            s = t.untyped_storage()
            key = id(s)
            if key in self._storages:
                continue
            nb = s.nbytes()
            self._storages[key] = nb
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def _record(self, kind: str, payload: float, n: int) -> None:
        self.records += [CollRecord(kind, float(payload), int(n),
                                    family_wire_bytes(kind, n, payload))
                         ] * self._rep

    def _kernel(self, name: str, work: KernelWork) -> None:
        rep = self._rep
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += rep
        k["flops"] += rep * work.flops
        k["bytes"] += rep * work.nbytes
        self.total.flops += rep * work.flops
        self.total.hbm_bytes += rep * work.nbytes


def _io_bytes(kind: str, payload: float, n: int) -> float:
    """A collective's per-rank operand and result bytes from its payload:
    a reduce-scatter's result and an all-gather's operand are 1/n of it."""
    if kind in ("reduce-scatter", "all-gather"):
        return payload + payload / n
    return 2.0 * payload


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


class _Uncached(Exception):
    pass


def _meta_key(x):
    """A hashable key of an op argument on the meta device: a tensor by
    its shape, strides and dtype; raises `_Uncached` for a tensor
    elsewhere or an argument of another type."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncached
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _Uncached


def _meta_recipe(out):
    """How to make `out` again (a tensor by its shape, strides and dtype);
    raises `_Uncached` where some result is off the meta device (a
    factory op's on the CPU: its values matter)."""
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            raise _Uncached
        return ("tensor", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_meta_recipe(v) for v in out))
    return ("value", out)


def _meta_build(recipe):
    if recipe[0] == "tensor":
        return torch.empty_strided(recipe[1], recipe[2], dtype=recipe[3],
                                   device="meta")
    if recipe[0] == "value":
        return recipe[1]
    return recipe[0](_meta_build(r) for r in recipe[1])


class _CensusMode(TorchDispatchMode):
    """Counts each op (`Census`). On the meta device an op that makes new
    tensors is a function of its arguments' shapes, strides and dtypes:
    its results' are cached by those and made with `empty_strided` (an
    op that writes its first argument returns it, its checks passed once
    at those shapes), so a dry run pays each meta kernel once, not once a
    layer and a rank."""

    def __init__(self, c: Census):
        super().__init__()
        self.c = c
        self._meta: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _op_kind(func)
        out = None
        if kind in ("new", "alloc", "inplace0"):
            try:
                key = (func, _meta_key(args), _meta_key(kwargs))
            except _Uncached:
                key = None
            if key is not None:
                recipe = self._meta.get(key)
                if recipe is None:
                    out = func(*args, **kwargs)
                    try:
                        self._meta[key] = _meta_recipe(out)
                    except _Uncached:
                        self._meta[key] = False
                elif recipe is False:
                    out = func(*args, **kwargs)
                elif kind != "inplace0":
                    out = _meta_build(recipe)
                else:                      # checked once: it writes args[0]
                    out = args[0]
        if out is None:
            out = func(*args, **kwargs)
        c = self.c
        if kind in ("new", "alloc") and not c._constants:
            c._track(out)
        if not c._suspend and kind not in ("free", "alloc"):
            c._count_op(func, args, kwargs, out, kind)
        return out


_ACTIVE: Census | None = None        # the open census, if any


@contextlib.contextmanager
def census(ranks: int = 1):
    """Count what runs inside (see the module docstring); yields the
    `Census`. `ranks` is the local mesh's rank count that `stats()`
    divides the process's op work by. Censuses do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a census is already open")
    c = Census(ranks)
    _ACTIVE = c
    try:
        with _CensusMode(c):
            yield c
    finally:
        _ACTIVE = None


@contextlib.contextmanager
def repeated(k: int):
    """Count what runs inside `k` times: one of k runs of the same shapes
    that stands for all of them (the local mesh's ranks on the meta
    device). Its storages are tracked once: the k runs would take turns."""
    c = _ACTIVE
    if c is None:
        yield
        return
    c._rep *= k
    try:
        yield
    finally:
        c._rep //= k


@contextlib.contextmanager
def constants():
    """What runs inside builds a cache's constants (a schedule's index
    tables on a device, made at its first run and kept): it is neither
    counted nor tracked, so a census of a step counts the same whether
    or not an earlier run built them."""
    c = _ACTIVE
    if c is None:
        yield
        return
    c._suspend += 1
    c._constants += 1
    try:
        yield
    finally:
        c._suspend -= 1
        c._constants -= 1


def collective(kind: str | None, measure):
    """Decorator of a choke point: a call is one `kind` collective whose
    per-rank (payload bytes, group size) `measure(arguments, out)` gives
    (`arguments`: the call's arguments by parameter name, defaults
    applied); with `kind` None a call is several, and `measure` gives
    their (kind, payload bytes, group size). Inside it op counting is
    suspended and further choke points record nothing; a group of one
    rank records nothing."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def hooked(*args, **kwargs):
            c = _ACTIVE
            if c is None or c._suspend:
                return fn(*args, **kwargs)
            c._suspend += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c._suspend -= 1
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            got = measure(bound.arguments, out)
            for k, payload, n in ([(kind, *got)] if kind is not None
                                  else got):
                if n > 1:
                    c._record(k, payload, n)
            return out
        return hooked
    return deco


def rank_bytes(t: torch.Tensor, ranks: int) -> int:
    """Bytes a rank holds of the local-mesh tensor `t` of `ranks` rows."""
    return t.numel() // ranks * t.element_size()


def note_collective(kind: str, payload: float, n: int) -> None:
    """Record one `kind` collective that the local mesh computes without
    a collective call (the trainer's mean of the ranks' losses, the
    reference's `pmean`)."""
    c = _ACTIVE
    if c is not None and not c._suspend and n > 1:
        c._record(kind, payload, n)


def kernel(name: str, work):
    """Decorator of a kernel wrapper: a call reports `work(*args,
    **kwargs)` (a `KernelWork` from the shapes) once, after it returns;
    op counting is suspended inside. Inside a collective it reports
    nothing: the collective's record is its work."""
    def deco(fn):
        @functools.wraps(fn)
        def hooked(*args, **kwargs):
            c = _ACTIVE
            if c is None:
                return fn(*args, **kwargs)
            inside = c._suspend
            c._suspend += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c._suspend -= 1
            if not inside:
                c._kernel(name, work(*args, **kwargs))
            return out
        return hooked
    return deco
