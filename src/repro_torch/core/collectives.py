"""AllReduce plan types on the local mesh (DESIGN.md §3).

The reference (`core/collectives.py` of the JAX package) runs each of the
paper's plan types as a `shard_map` schedule over one named mesh axis.
Here every rank is a row of one tensor on one device, the *local mesh*:
a tensor whose leading dimensions are the mesh axes, in the order of
`mesh` (a sequence of (axis name, size)), followed by each rank's data.
(8, L) is the mesh [("x", 8)]; (2, 4, L) the mesh [("pod", 2), ("data",
4)]. A collective over one axis acts along that dimension; the other
mesh dimensions are independent groups, batched into the same row
tables, so a fold is one launch whatever the number of groups.

  * ring  — n − 1 folds of fan-in 2, the reference's chained adds in its
            order, then n − 1 copy rounds (all-gather)
  * rhd   — log₂ p halving folds and log₂ p doubling copies over the
            power-of-two core p; at n ≠ p the χ(N) extras fold in first
            (one more fold) and are copied out last (one more round)
  * cps   — ONE N-ary fold (the all-to-all is the fold's row table) and
            one all-gather copy
  * hcps  — one f-ary fold a stage of fan-ins `factors` and one copy a
            stage; the reorder to natural shard holders is the last
            fold's output rows, the un-reorder the first copy's sources
  * psum  — one N-ary fold into rank 0's row and one broadcast copy
  * plan  — a lowered GenTree plan (`core.lower.CompiledSchedule`), run
            by its `run_local*` entry points

On a CUDA tensor every sum is one `kernels.ops.fused_reduce_into` launch
batched over all ranks and groups of the round; a round that feeds a
fold is only a read of another rank's row, so it lies in the fold's row
table and moves nothing. On the CPU the wrapper runs its plain version
(`kernels/ref.py`). Movement-only rounds are one indexed copy each.
Each strategy is compiled once per (mesh shape, axis, factors) into a
`FlatProgram` of fold and copy operations over named buffers
(`flat_program`), whose row tables are placed once per device.

Inputs: f32 or bf16 (the fold kernel's dtypes), any layout (made
contiguous). Padding as the reference's: to a multiple of the axis size,
or for non-power-of-two rhd of lcm(n, p) (`_pad_multiple`).

On a process mesh (`mesh=` a `core.transport.ProcessMesh`, one process a
rank) a tensor is this rank's own and an axis its process group: the
program compiled for one group runs as this rank (`FlatProgram.
run_dist`), each operation an exchange of the rows other ranks hold
(`DistOp`) and then the same fold launch or copy, so the results equal
the local mesh's rows bit for bit; on several axes the rank runs in its
group of each, one group at a time as `_per_group` does.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.launch import analysis
from repro_torch.runtime.trace import default_tracer

from .transport import exchange, is_process_mesh

# ---------------------------------------------------------------------------
# index helpers (copied from the reference)
# ---------------------------------------------------------------------------
def _shift_perm(n: int, k: int) -> list[tuple[int, int]]:
    return [(i, (i + k) % n) for i in range(n)]


def _rhd_pow2(n: int) -> tuple[int, int]:
    pow2 = 1 << (n.bit_length() - 1)
    return pow2, n - pow2


def _digit_shift_perm(n: int, radix: int, f: int, k: int
                      ) -> list[tuple[int, int]]:
    """Permutation advancing mixed-radix digit (radix block f) by k."""
    perm = []
    for i in range(n):
        g = (i // radix) % f
        j = i + ((g + k) % f - g) * radix
        perm.append((i, j))
    return perm


def _sources(perm: list[tuple[int, int]], n: int) -> np.ndarray:
    """The sending device of each receiving device of a permutation."""
    src = np.empty(n, np.int64)
    for s, d in perm:
        src[d] = s
    return src


def hcps_shard_index(factors: Sequence[int]) -> list[int]:
    """Shard index held by each device after reduce_scatter_hcps.

    Stage i keys on mixed-radix digit i (LSB-first) of the device index, so
    device idx ends with shard whose MSB-first digits are (g_0, g_1, ...):
    a digit reversal. Returns shard_of_device[idx]."""
    n = math.prod(factors)
    out = []
    for idx in range(n):
        rem, s = idx, 0
        for f in factors:
            s = s * f + rem % f
            rem //= f
        out.append(s)
    return out


def _pad_multiple(n: int, strategy: str) -> int:
    """Flat size must divide by this for the strategy's schedule: the axis
    size, except non-power-of-two RHD also halves down to the pow2 core."""
    if strategy == "rhd":
        pow2, extra = _rhd_pow2(n)
        if extra:
            return n * pow2 // math.gcd(n, pow2)
    return n


# ---------------------------------------------------------------------------
# the local mesh
# ---------------------------------------------------------------------------
def _mesh_sizes(x: torch.Tensor, axis_names: Sequence[str], mesh
                ) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(names, sizes) of the local mesh of `x`; `mesh` None is the one axis
    of x's leading dimension (`axis_names` must then name one axis)."""
    if mesh is None:
        if len(axis_names) != 1 or x.dim() < 1:
            raise ValueError(f"without a mesh, x's leading dimension is the "
                             f"one axis; got axes {list(axis_names)} and "
                             f"x of shape {tuple(x.shape)}")
        mesh = [(axis_names[0], int(x.shape[0]))]
    names = tuple(str(a) for a, _ in mesh)
    sizes = tuple(int(s) for _, s in mesh)
    for a in axis_names:
        if a not in names:
            raise ValueError(f"axis {a!r} is not in the mesh {list(mesh)}")
    if tuple(x.shape[:len(sizes)]) != sizes:
        raise ValueError(f"a tensor on the mesh {list(mesh)} leads with "
                         f"{sizes}; got shape {tuple(x.shape)}")
    return names, sizes


@functools.lru_cache(maxsize=None)
def axis_rows(sizes: tuple[int, ...], dims: tuple[int, ...]) -> np.ndarray:
    """(n, G) flat row indices of a local mesh of `sizes`: entry [r, g] is
    the row of rank r along mesh dimensions `dims` (their product, the
    first slowest) in group g of the other dimensions (row-major)."""
    idx = np.arange(math.prod(sizes), dtype=np.int64).reshape(sizes)
    moved = np.moveaxis(idx, list(dims), list(range(len(dims))))
    n = math.prod(sizes[d] for d in dims)
    out = moved.reshape(n, -1)
    out.setflags(write=False)
    return out


# ---------------------------------------------------------------------------
# compiled flat programs
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class FlatOp:
    """One fold (one `fused_reduce_into` launch) or one copy round on
    buffers viewed as rows of L // rowdiv lanes (L: one rank's padded
    vector). A fold's rows (B, x) name operand rows of `src` (−1 =
    skipped); own (B,) a partial row of `dst` (−1 = none); out (B,) the
    result rows of `dst`. A copy moves rows src_rows of `src` to rows
    dst_rows of `dst`."""
    kind: str                       # "fold" | "copy"
    src: str
    dst: str
    rowdiv: int
    rows: np.ndarray                # fold: (B, x); copy: (C,) source rows
    out: np.ndarray                 # (B,) / (C,) destination rows
    own: np.ndarray | None = None   # fold only
    _dev: dict = field(default_factory=dict, repr=False)

    def dist(self, q: int, R: int, bufs: dict) -> "DistOp":
        """Rank q's part of this operation among R ranks (cached)."""
        key = ("dist", q, R)
        d = self._dev.get(key)
        if d is None:
            d = self._dev[key] = _compile_dist(self, q, R, bufs)
        return d

    def tables(self, device: torch.device):
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            with analysis.constants():
                if self.kind == "fold":
                    from repro_torch.kernels import ops as kops
                    t = kops.row_table(self.rows, self.out, self.own,
                                       device)
                else:
                    t = (torch.from_numpy(self.rows).to(device),
                         torch.from_numpy(self.out).to(device))
            self._dev[key] = t
        return t


@dataclass(eq=False)
class FlatProgram:
    """A flat collective compiled for one local-mesh shape: buffers
    name → (slots, div), each (slots, R, L // div) (buffer "x" is the
    input, L // div lanes a rank), the operations in order, and the
    (buffer, slot) holding the result. `mutates_input`: a fold writes
    into "x", so the caller's tensor is copied first."""
    name: str
    bufs: dict[str, tuple[int, int]]
    ops: list[FlatOp]
    out: tuple[str, int]
    mutates_input: bool = False

    @property
    def folds(self) -> int:
        return sum(op.kind == "fold" for op in self.ops)

    @property
    def copies(self) -> int:
        return sum(op.kind == "copy" for op in self.ops)

    def nbytes(self, R: int, L: int, elem: int) -> int:
        """Bytes the program must move if every operation's rows cross
        device memory once: a fold reads its live operands and partials
        and writes its results, a copy reads and writes its rows."""
        total = 0
        for op in self.ops:
            row = (L // op.rowdiv) * elem
            if op.kind == "fold":
                live = int((op.rows >= 0).sum()) + int((op.own >= 0).sum())
                total += (live + op.out.size) * row
            else:
                total += 2 * op.out.size * row
        return total

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Run on x (R, L // div_x), contiguous; returns the result
        buffer's slot (R, L // div)."""
        from repro_torch.kernels import ops as kops
        R = x.shape[0]
        L = x.shape[1] * self.bufs["x"][1]
        bufs = {"x": x.reshape(1, R, -1)}
        for name, (slots, div) in self.bufs.items():
            if name != "x":
                bufs[name] = torch.empty((slots, R, L // div),
                                         dtype=x.dtype, device=x.device)
        with default_tracer().span("collective/" + self.name, ranks=R,
                                   lanes=L, folds=self.folds,
                                   copies=self.copies):
            for op in self.ops:
                src = bufs[op.src].view(-1, L // op.rowdiv)
                dst = bufs[op.dst].view(-1, L // op.rowdiv)
                if op.kind == "fold":
                    kops.fused_reduce_into(src, op.tables(x.device), dst)
                else:
                    s_rows, d_rows = op.tables(x.device)
                    dst.index_copy_(0, d_rows, src.index_select(0, s_rows))
        name, slot = self.out
        return bufs[name][slot]

    def run_dist(self, x: torch.Tensor, mesh, line) -> torch.Tensor:
        """Run as rank `line.index` of the program's R = `line.size` ranks
        (a program compiled for one group) on a process mesh: x is this
        rank's flat (L // div_x,) input; returns its result (L // div,).
        Each operation is one exchange in `line` (the rows other ranks
        hold arrive as payloads), then the same fold launch, or copy, on
        this rank's rows, so the result equals row q of `run`."""
        from repro_torch.kernels import ops as kops

        q, R = line.index, line.size
        L = x.numel() * self.bufs["x"][1]
        bufs = {"x": x.reshape(1, -1)}
        for name, (slots, div) in self.bufs.items():
            if name != "x":
                bufs[name] = torch.empty((slots, L // div), dtype=x.dtype,
                                         device=x.device)
        with default_tracer().span("collective/" + self.name, ranks=R,
                                   lanes=L, folds=self.folds,
                                   copies=self.copies, rank=q):
            for op in self.ops:
                d = op.dist(q, R, self.bufs)
                lanes = L // op.rowdiv
                src = bufs[op.src].view(-1, lanes)
                dst = bufs[op.dst].view(-1, lanes)
                idx = d.indices(x.device)
                sends = [(p, (src if which == "src" else dst).index_select(
                    0, idx[f"send{j}"])) for j, (p, which, _) in
                    enumerate(d.sends)]
                stage = torch.empty((d.n_stage, lanes), dtype=x.dtype,
                                    device=x.device)
                local = src.index_select(0, idx["local_src"])
                if op.kind == "fold":
                    stage[:local.shape[0]] = local
                exchange(mesh, line, sends,
                         [(p, stage[off:off + cnt])
                          for p, off, cnt in d.recvs])
                if op.kind == "fold":
                    if d.out_local.size:
                        kops.fused_reduce_into(stage, d.table(x.device),
                                               dst)
                    continue
                dst.index_copy_(0, idx["local_dst"], local)
                dst.index_copy_(0, idx["remote_dst"],
                                stage.index_select(0, idx["remote_stage"]))
        name, slot = self.out
        return bufs[name][slot]


@dataclass(eq=False)
class DistOp:
    """Rank q's part of one `FlatOp` on a process mesh. Its payloads: to
    each peer the rows of `src` ("src") or `dst` ("dst", a partial) the
    peer's results read; from each peer into staging rows [off, off +
    cnt). A fold stages its local operand rows first (`local_src`), then
    per peer its operand rows and the partials it reads there, as extra
    last operands (the kernel adds a partial after the operands, so the
    sum is the same); `out_local` / `own_local` are its result rows and
    its local partials in `dst`. A copy writes its local rows
    (`local_src` → `local_dst`) and its received ones (staging rows
    `remote_stage` → `remote_dst`). Payload rows are sorted and unique,
    so both ends of a payload agree on its order."""
    sends: list                        # (peer, "src" | "dst", local rows)
    recvs: list                        # (peer, staging offset, rows)
    n_stage: int
    local_src: np.ndarray
    local_dst: np.ndarray | None = None
    remote_stage: np.ndarray | None = None
    remote_dst: np.ndarray | None = None
    rows: np.ndarray | None = None     # fold: (B, x') staging rows
    out_local: np.ndarray | None = None
    own_local: np.ndarray | None = None
    _dev: dict = field(default_factory=dict, repr=False)

    def indices(self, device: torch.device) -> dict:
        key = ("idx", str(device))
        t = self._dev.get(key)
        if t is None:
            arrs = {f"send{j}": rows for j, (_, _, rows) in
                    enumerate(self.sends)}
            arrs["local_src"] = self.local_src
            if self.local_dst is not None:
                arrs.update(local_dst=self.local_dst,
                            remote_stage=self.remote_stage,
                            remote_dst=self.remote_dst)
            with analysis.constants():
                t = self._dev[key] = {
                    k: torch.as_tensor(v, dtype=torch.int64, device=device)
                    for k, v in arrs.items()}
        return t

    def table(self, device: torch.device):
        key = ("table", str(device))
        t = self._dev.get(key)
        if t is None:
            from repro_torch.kernels import ops as kops
            with analysis.constants():
                t = self._dev[key] = kops.row_table(
                    self.rows, self.out_local, self.own_local, device)
        return t


def _owner_local(g: np.ndarray, per: int, R: int):
    """(owning rank, local row) of global rows g of a buffer whose rank
    rows hold `per` rows each: row (slot·R + q)·per + p is rank q's local
    row slot·per + p."""
    g = np.asarray(g, np.int64)
    return (g // per) % R, (g // (per * R)) * per + g % per


def _dist_needs(op: FlatOp, r: int, R: int, bufs: dict):
    """The rows rank r's results of `op` read: operand rows by owner and,
    for a fold, the partial rows other ranks hold, by owner (each sorted,
    unique); and r's result positions."""
    per_s = op.rowdiv // bufs[op.src][1]
    per_d = op.rowdiv // bufs[op.dst][1]
    own_d, _ = _owner_local(op.out, per_d, R)
    mine = np.nonzero(own_d == r)[0]
    rows = op.rows[mine] if op.kind == "fold" else op.rows[mine][:, None]
    live = rows[rows >= 0]
    who, _ = _owner_local(live, per_s, R)
    ops_from = {p: np.unique(live[who == p]) for p in range(R)}
    own_from = {p: np.zeros(0, np.int64) for p in range(R)}
    if op.kind == "fold":
        own = op.own[mine]
        live_own = own[own >= 0]
        who_o, _ = _owner_local(live_own, per_d, R)
        for p in range(R):
            if p != r:
                own_from[p] = np.unique(live_own[who_o == p])
    return mine, ops_from, own_from, per_s, per_d


def _compile_dist(op: FlatOp, q: int, R: int, bufs: dict) -> DistOp:
    mine, ops_from, own_from, per_s, per_d = _dist_needs(op, q, R, bufs)
    sends = []
    for p in range(R):
        if p == q:
            continue
        _, ops_p, own_p, _, _ = _dist_needs(op, p, R, bufs)
        for which, rows in (("src", ops_p[q]), ("dst", own_p[q])):
            if rows.size:
                sends.append((p, which, _owner_local(
                    rows, per_s if which == "src" else per_d, R)[1]))
    # staging: local operand rows, then per peer its operands and partials
    pos: dict[tuple[str, int], int] = {}
    recvs = []
    off = 0
    if op.kind == "fold":
        for g in ops_from[q]:
            pos[("src", int(g))] = off
            off += 1
    for p in range(R):
        if p == q:
            continue
        for which, rows in (("src", ops_from[p]), ("dst", own_from[p])):
            if rows.size:
                recvs.append((p, off, int(rows.size)))
                for g in rows:
                    pos[(which, int(g))] = off
                    off += 1
    local_src = _owner_local(ops_from[q], per_s, R)[1]
    _, out_local = _owner_local(op.out[mine], per_d, R)
    if op.kind == "copy":
        src_g = op.rows[mine]
        who, _ = _owner_local(src_g, per_s, R)
        here = who == q
        first = {int(g): j for j, g in enumerate(ops_from[q])}
        order = np.array([first[int(g)] for g in src_g[here]], np.int64)
        return DistOp(sends=sends, recvs=recvs, n_stage=off,
                      local_src=local_src[order] if order.size
                      else np.zeros(0, np.int64),
                      local_dst=out_local[here],
                      remote_stage=np.array([pos[("src", int(g))]
                                             for g in src_g[~here]],
                                            np.int64),
                      remote_dst=out_local[~here])
    rows = np.vectorize(lambda g: pos[("src", int(g))] if g >= 0 else -1,
                        otypes=[np.int64])(op.rows[mine]) \
        if mine.size else np.zeros((0, op.rows.shape[1]), np.int64)
    own = op.own[mine]
    who_o, own_l = _owner_local(own, per_d, R)
    remote = (own >= 0) & (who_o != q)
    if remote.any():
        extra = np.array([pos[("dst", int(g))] if rm else -1
                          for g, rm in zip(own, remote)], np.int64)
        rows = np.concatenate([rows, extra[:, None]], axis=1)
    own_local = np.where((own >= 0) & ~remote, own_l, -1)
    return DistOp(sends=sends, recvs=recvs, n_stage=off,
                  local_src=local_src, rows=rows, out_local=out_local,
                  own_local=own_local)


def _row(R: int, bufdiv: int, rowdiv: int, slot, q, p) -> np.ndarray:
    """Row index of (slot, rank row q, position p) in a buffer of per-rank
    length L // bufdiv viewed as rows of L // rowdiv lanes."""
    per = rowdiv // bufdiv
    return (np.asarray(slot) * R + np.asarray(q)) * per + np.asarray(p)


def _fold(src, dst, rowdiv, rows, out, own=None) -> FlatOp:
    out = np.array(out, np.int64).reshape(-1)
    rows = np.array(rows, np.int64).reshape(out.size, -1)
    own = (np.full(out.size, -1, np.int64) if own is None
           else np.array(own, np.int64).reshape(-1))
    return FlatOp("fold", src, dst, rowdiv, rows, out, own)


def _copy(src, dst, rowdiv, rows, out) -> FlatOp:
    return FlatOp("copy", src, dst, rowdiv,
                  np.array(rows, np.int64).reshape(-1),
                  np.array(out, np.int64).reshape(-1))


def _ring_rs(Q: np.ndarray) -> FlatProgram:
    """Ring reduce-scatter: rank i's partial a_s = a_{s−1}[i−1] + x_i[(i −
    1 − s) mod n] for s = 1..n−1 (a_0[i] = x_i[i − 1] is read in place),
    one 2-operand fold a step; a_{n−1}[i] is the sum of chunk i, added in
    the reference's chain order (from rank i + 1 round to rank i)."""
    n, G = Q.shape
    R = Q.size
    i = np.arange(n)[:, None]
    prev = _sources(_shift_perm(n, 1), n)[:, None]   # i − 1 sends to i
    Qi, Qp = Q, Q[prev[:, 0]]
    ops = []
    for s in range(1, n):
        k = np.broadcast_to((i - 1 - s) % n, Q.shape)
        out = _row(R, n, n, s % 2, Qi, 0)
        mine = _row(R, 1, n, 0, Qi, k)
        if s == 1:
            theirs = _row(R, 1, n, 0, Qp, np.broadcast_to(
                (prev - 1) % n, Q.shape))
            ops.append(_fold("x", "acc", n, np.stack([theirs, mine], -1),
                             out))
        else:
            own = _row(R, n, n, (s - 1) % 2, Qp, 0)
            ops.append(_fold("x", "acc", n, mine[..., None], out, own))
    return FlatProgram("ring/reduce_scatter", {"x": (1, 1), "acc": (2, n)},
                       ops, ("acc", (n - 1) % 2))


def _ring_ag(Q: np.ndarray) -> FlatProgram:
    """Ring all-gather: n − 1 rounds; round s copies chunk (i − 1 − s) mod
    n from rank i − 1 to rank i (round 0 also places rank i's own)."""
    n, G = Q.shape
    R = Q.size
    i = np.arange(n)[:, None]
    Qp = Q[_sources(_shift_perm(n, 1), n)]
    own_k = np.broadcast_to(i, Q.shape)
    prev_k = np.broadcast_to((i - 1) % n, Q.shape)
    ops = [_copy("x", "y", n,
                 np.concatenate([_row(R, n, n, 0, Q, 0).ravel(),
                                 _row(R, n, n, 0, Qp, 0).ravel()]),
                 np.concatenate([_row(R, 1, n, 0, Q, own_k).ravel(),
                                 _row(R, 1, n, 0, Q, prev_k).ravel()]))]
    for s in range(1, n - 1):
        k = np.broadcast_to((i - 1 - s) % n, Q.shape)
        ops.append(_copy("y", "y", n, _row(R, 1, n, 0, Qp, k),
                         _row(R, 1, n, 0, Q, k)))
    return FlatProgram("ring/all_gather", {"x": (1, n), "y": (1, 1)}, ops,
                       ("y", 0))


def _rhd_rs(Q: np.ndarray) -> FlatProgram:
    """RHD halving over the power-of-two core p: at n ≠ p the extras fold
    their whole vector into rank e = idx − p first (in place, one fold);
    then log₂ p steps, each rank keeping the half of its range its bit
    selects and adding its partner's copy of it, one 2-operand fold a
    step (the extras add nothing: the reference's keep + 0). The first
    step reads the input and keeps its half in a buffer of L/2 a rank, the
    middle steps fold in place there, the last writes the (R, L/p)
    result: rank i < p holds block i."""
    n, G = Q.shape
    R = Q.size
    pow2, extra = _rhd_pow2(n)
    T = pow2.bit_length() - 1
    ops = []
    if extra:
        e = np.arange(extra)
        ops.append(_fold("x", "x", 1, _row(R, 1, 1, 0, Q[pow2 + e], 0),
                         _row(R, 1, 1, 0, Q[e], 0),
                         _row(R, 1, 1, 0, Q[e], 0)))
    idx = np.arange(n)
    start = np.zeros(n, np.int64)          # range start, in blocks L/p
    base = None                            # start after step 0
    m = pow2
    for t in range(T):
        d = pow2 >> (t + 1)
        half = m // 2
        start = start + ((idx // d) % 2) * half
        if t == 0:
            base = start.copy()
        partner = np.where(idx < pow2, idx ^ d, -1)
        rowdiv = pow2 // half
        Qi = Q
        Qj = np.where(partner[:, None] >= 0, Q[np.maximum(partner, 0)], 0)
        live = (partner >= 0)[:, None]
        last = t == T - 1
        if t == 0:
            pos = np.broadcast_to((start // half)[:, None], Q.shape)
            keep = _row(R, 1, rowdiv, 0, Qi, pos)
            theirs = np.where(live, _row(R, 1, rowdiv, 0, Qj, pos), -1)
            src = "x"
        else:
            pos = np.broadcast_to(((start - base) // half)[:, None], Q.shape)
            keep = _row(R, 2, rowdiv, 0, Qi, pos)
            theirs = np.where(live, _row(R, 2, rowdiv, 0, Qj, pos), -1)
            src = "h"
        if last:
            ops.append(_fold(src, "out", rowdiv, np.stack([keep, theirs], -1),
                             _row(R, pow2, rowdiv, 0, Qi, 0)))
        elif t == 0:
            ops.append(_fold(src, "h", rowdiv, np.stack([keep, theirs], -1),
                             _row(R, 2, rowdiv, 0, Qi, 0)))
        else:
            ops.append(_fold("h", "h", rowdiv, theirs[..., None], keep, keep))
        m = half
    bufs = {"x": (1, 1), "out": (1, pow2)}
    if T > 1:
        bufs["h"] = (1, 2)
    return FlatProgram("rhd/reduce_scatter", bufs, ops, ("out", 0),
                       mutates_input=bool(extra))


def _rhd_ag(Q: np.ndarray) -> FlatProgram:
    """RHD doubling over the core p: rank i < p places its block i and its
    partner's (round d = 1), then each round d copies the partner's range
    of d blocks; at n ≠ p a last round copies rank e's whole vector to
    rank p + e (the fold-out)."""
    n, G = Q.shape
    R = Q.size
    pow2, extra = _rhd_pow2(n)
    c = np.arange(pow2)
    Qc = Q[:pow2]
    p1 = c ^ 1
    ops = [_copy("x", "y", pow2,
                 np.concatenate([Qc.ravel(), Q[p1].ravel()]),
                 np.concatenate([
                     _row(R, 1, pow2, 0, Qc, np.broadcast_to(
                         c[:, None], Qc.shape)).ravel(),
                     _row(R, 1, pow2, 0, Qc, np.broadcast_to(
                         p1[:, None], Qc.shape)).ravel()]))]
    d = 2
    while d < pow2:
        rowdiv = pow2 // d
        pos = np.broadcast_to(((c ^ d) // d)[:, None], Qc.shape)
        ops.append(_copy("y", "y", rowdiv, _row(R, 1, rowdiv, 0, Q[c ^ d],
                                                pos),
                         _row(R, 1, rowdiv, 0, Qc, pos)))
        d *= 2
    if extra:
        e = np.arange(extra)
        ops.append(_copy("y", "y", 1, Q[e], Q[pow2 + e]))
    return FlatProgram("rhd/all_gather", {"x": (1, pow2), "y": (1, 1)},
                       ops, ("y", 0))


def _cps_rs(Q: np.ndarray) -> FlatProgram:
    """CPS reduce-scatter: ONE n-ary fold; rank i's operands are chunk i
    of ranks 0..n−1 in order (the all-to-all is the row table)."""
    n, G = Q.shape
    R = Q.size
    i = np.arange(n)[:, None, None]
    rows = _row(R, 1, n, 0, Q.T[None, :, :], i)    # (n_i, G, n_k)
    return FlatProgram("cps/reduce_scatter", {"x": (1, 1), "out": (1, n)},
                       [_fold("x", "out", n, rows, _row(R, n, n, 0, Q, 0))],
                       ("out", 0))


def _cps_ag(Q: np.ndarray) -> FlatProgram:
    """The tiled all-gather: one copy, rank i's chunk k from rank k."""
    n, G = Q.shape
    R = Q.size
    k = np.arange(n)
    src = np.broadcast_to(Q[None, :, :], (n, n, G))        # [i, k, g]
    dst = _row(R, 1, n, 0, Q[:, None, :], k[None, :, None])
    return FlatProgram("cps/all_gather", {"x": (1, n), "y": (1, 1)},
                       [_copy("x", "y", n, src, np.broadcast_to(dst,
                                                                (n, n, G)))],
                       ("y", 0))


def _psum(Q: np.ndarray) -> FlatProgram:
    """psum: one n-ary fold of every rank's row, in rank order, into rank
    0's row of the result, then one copy of it to the other ranks."""
    n, G = Q.shape
    ops = [_fold("x", "y", 1, Q.T, Q[0])]
    if n > 1:
        ops.append(_copy("y", "y", 1, np.broadcast_to(Q[0], (n - 1, G)),
                         Q[1:]))
    return FlatProgram("psum/allreduce", {"x": (1, 1), "y": (1, 1)}, ops,
                       ("y", 0))


def _hcps_rs(Q: np.ndarray, factors: tuple[int, ...], reorder: bool
             ) -> FlatProgram:
    """Hierarchical CPS reduce-scatter: stage t (fan-in f, radix r) folds,
    for rank i of digit g, piece g of the f members i + (h − g)·r in the
    reference's order (its own, then digits g − 1, g − 2, ...): one f-ary
    fold a stage. With `reorder` the last fold writes rank i's shard to
    row hcps_shard_index[i] (its natural holder)."""
    n, G = Q.shape
    R = Q.size
    idx = np.arange(n)
    sidx = np.asarray(hcps_shard_index(factors))
    bufs = {"x": (1, 1)}
    ops = []
    radix, div, src = 1, 1, "x"
    for t, f in enumerate(factors):
        g = (idx // radix) % f
        rowdiv = div * f
        # operand k: piece g of the member whose digit is g − k, the
        # sender of the digit shift by +k
        members = np.stack([_sources(_digit_shift_perm(n, radix, f, k), n)
                            for k in range(f)], -1)         # (n, f)
        rows = _row(R, div, rowdiv, 0, Q[members].transpose(0, 2, 1),
                    g[:, None, None])                       # (n, G, f)
        dst = f"s{t}"
        bufs[dst] = (1, rowdiv)
        holder = sidx if reorder and t == len(factors) - 1 else idx
        ops.append(_fold(src, dst, rowdiv, rows,
                         _row(R, rowdiv, rowdiv, 0, Q[holder], 0)))
        radix, div, src = radix * f, rowdiv, dst
    return FlatProgram("hcps/reduce_scatter", bufs, ops, (src, 0))


def _hcps_ag(Q: np.ndarray, factors: tuple[int, ...], unorder: bool
             ) -> FlatProgram:
    """Hierarchical CPS all-gather: over the factors in reverse, rank i of
    digit g gathers piece h from member i + (h − g)·r, one copy a stage.
    With `unorder` the first stage reads rank j's shard from row
    hcps_shard_index[j] (natural holders back to native ones)."""
    n, G = Q.shape
    R = Q.size
    idx = np.arange(n)
    sidx = np.asarray(hcps_shard_index(factors))
    bufs = {"x": (1, n)}
    ops = []
    radix, div, src = n, n, "x"
    for t, f in enumerate(reversed(factors)):
        radix //= f
        g = (idx // radix) % f
        h = np.arange(f)
        # piece h comes from the member of digit h: the sender of the
        # digit shift by g − h
        senders = np.stack([_sources(_digit_shift_perm(n, radix, f, k), n)
                            for k in range(f)], -1)         # (n, k)
        members = senders[idx[:, None], (g[:, None] - h[None, :]) % f]
        if unorder and t == 0:
            members = sidx[members]
        new = div // f
        dst = f"g{t}"
        bufs[dst] = (1, new)
        src_rows = _row(R, div, div, 0, Q[members].transpose(0, 2, 1), 0)
        dst_rows = _row(R, new, div, 0, Q[:, :, None],
                        np.broadcast_to(h, (n, G, f)))
        ops.append(_copy(src, dst, div, src_rows,
                         np.broadcast_to(dst_rows, (n, G, f))))
        div, src = new, dst
    return FlatProgram("hcps/all_gather", bufs, ops, (src, 0))


def _all_to_all(Q: np.ndarray) -> FlatProgram:
    """All-to-all: one copy; rank i's chunk k is rank k's chunk i."""
    n, G = Q.shape
    R = Q.size
    i = np.arange(n)[:, None, None]
    k = np.arange(n)[None, None, :]
    src = _row(R, 1, n, 0, Q.T[None, :, :], i)             # [i, g, k]
    dst = _row(R, 1, n, 0, Q[:, :, None], k)
    return FlatProgram("all_to_all", {"x": (1, 1), "y": (1, 1)},
                       [_copy("x", "y", n, src, np.broadcast_to(
                           dst, src.shape))], ("y", 0))


@functools.lru_cache(maxsize=None)
def flat_program(strategy: str, half: str, sizes: tuple[int, ...],
                 dims: tuple[int, ...],
                 factors: tuple[int, ...] | None = None,
                 order: bool = False) -> FlatProgram:
    """The compiled `strategy` ("psum", "ring", "rhd", "cps", "hcps"; or
    "all_to_all") `half` ("reduce_scatter", "all_gather", or "allreduce"
    for psum) over mesh dimensions `dims` of a local mesh of `sizes`.
    `order`: hcps's reorder to natural holders (reduce-scatter) or the
    un-reorder before its gather (all-gather). Cached."""
    Q = axis_rows(sizes, dims)
    if strategy == "all_to_all":
        return _all_to_all(Q)
    if strategy == "psum" and half == "allreduce":
        return _psum(Q)
    if strategy in ("psum", "auto") and half == "reduce_scatter":
        return _cps_rs(Q)
    if strategy in ("psum", "auto") and half == "all_gather":
        return _cps_ag(Q)
    builders = {("ring", "reduce_scatter"): _ring_rs,
                ("ring", "all_gather"): _ring_ag,
                ("rhd", "reduce_scatter"): _rhd_rs,
                ("rhd", "all_gather"): _rhd_ag,
                ("cps", "reduce_scatter"): _cps_rs,
                ("cps", "all_gather"): _cps_ag}
    if strategy == "hcps":
        if not factors or math.prod(factors) != Q.shape[0]:
            raise ValueError(f"hcps needs fan-in factors multiplying to "
                             f"{Q.shape[0]}; got {factors}")
        if half == "reduce_scatter":
            return _hcps_rs(Q, tuple(factors), order)
        if half == "all_gather":
            return _hcps_ag(Q, tuple(factors), order)
    if (strategy, half) not in builders:
        raise ValueError(f"unknown strategy {strategy!r} ({half})")
    return builders[(strategy, half)](Q)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _flat(x: torch.Tensor, R: int, multiple: int = 1
          ) -> tuple[torch.Tensor, int, bool]:
    """(x as contiguous (R, L) rows zero-padded to a multiple of
    `multiple`, the pad, whether the rows are a new tensor)."""
    flat = x.reshape(R, -1)
    pad = (-flat.shape[1]) % multiple
    if pad:
        return torch.nn.functional.pad(flat, (0, pad)), pad, True
    if not flat.is_contiguous():
        return flat.contiguous(), 0, True
    return flat, 0, x.numel() > 0 and flat.data_ptr() != x.data_ptr()


def _run(prog: FlatProgram, flat: torch.Tensor, owned: bool) -> torch.Tensor:
    if prog.mutates_input and not owned:
        flat = flat.clone()
    return prog.run(flat)


def _natural(Q: np.ndarray) -> bool:
    """The axis is the mesh's only live dimension, in row order."""
    return Q.shape[1] == 1 and np.array_equal(Q[:, 0], np.arange(Q.shape[0]))


def _to_axis(flat: torch.Tensor, Q: np.ndarray) -> torch.Tensor:
    """(R, L) mesh rows → (n, G·L): rank r's rows of every group side by
    side (a view where the axis is the only live dimension)."""
    if _natural(Q):
        return flat
    return flat[torch.tensor(Q, device=flat.device)].reshape(Q.shape[0], -1)


def _from_axis(y: torch.Tensor, Q: np.ndarray) -> torch.Tensor:
    """The inverse of `_to_axis`: (n, G·L) → (R, L) mesh rows."""
    if _natural(Q):
        return y
    n, G = Q.shape
    out = y.new_empty((n * G, y.shape[1] // G))
    out[torch.tensor(Q, device=y.device)] = y.reshape(n, G, -1)
    return out


def _per_group(fn, flat: torch.Tensor, Q: np.ndarray, out_len: int
               ) -> torch.Tensor:
    """Run fn((n, L) rows of one group) for each group of the local mesh;
    the (R, out_len) results in the mesh's row order."""
    if _natural(Q):
        return fn(flat)
    out = flat.new_empty((flat.shape[0], out_len))
    for g in range(Q.shape[1]):
        rows = torch.tensor(Q[:, g], device=flat.device)
        out[rows] = fn(flat.index_select(0, rows))
    return out


def _axis(x, axis_name, mesh):
    names, sizes = _mesh_sizes(x, [axis_name], mesh)
    dim = names.index(axis_name)
    return sizes, dim, sizes[dim], math.prod(sizes)


# ---------------------------------------------------------------------------
# the process mesh: x is this rank's tensor, the axis its process group
# (`is_process_mesh`, `core.transport`)
# ---------------------------------------------------------------------------


def _flat1(x: torch.Tensor, multiple: int = 1
           ) -> tuple[torch.Tensor, int, bool]:
    """`_flat` of one rank's tensor: (x flat, contiguous, zero-padded to
    a multiple of `multiple`; the pad; whether it is a new tensor)."""
    flat, pad, owned = _flat(x.reshape(1, -1), 1, multiple)
    return flat.reshape(-1), pad, owned


def _dist_program(strategy, half, n, factors=None, order=False):
    fac = tuple(factors) if strategy == "hcps" else None
    if strategy == "hcps" and fac is None:
        raise ValueError("hcps needs fan-in factors")
    return flat_program(strategy, half, (n,), (0,), fac, order=order)


def _run_dist(prog: FlatProgram, flat: torch.Tensor, owned: bool, mesh,
              line) -> torch.Tensor:
    if prog.mutates_input and not owned:
        flat = flat.clone()
    return prog.run_dist(flat, mesh, line)


def _dist_allreduce(x, axis_name, strategy, factors, schedule, mesh):
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        return schedule.allreduce(x.reshape(-1), axis_name,
                                  mesh).reshape(x.shape)
    line = mesh.line(axis_name)
    if strategy == "psum":
        flat, _, owned = _flat1(x)
        return _run_dist(_dist_program("psum", "allreduce", n), flat,
                         owned, mesh, line).reshape(x.shape)
    if strategy not in ("ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    flat, pad, owned = _flat1(x, _pad_multiple(n, strategy))
    shard = _run_dist(_dist_program(strategy, "reduce_scatter", n, factors),
                      flat, owned, mesh, line)
    full = _dist_program(strategy, "all_gather", n, factors).run_dist(
        shard, mesh, line)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


def _dist_reduce_scatter(x, axis_name, strategy, factors, schedule, mesh):
    n = mesh.axis_size(axis_name)
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        return schedule.reduce_scatter(x.reshape(-1), axis_name, mesh)
    if strategy not in ("psum", "auto", "ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    flat, _, owned = _flat1(x, _pad_multiple(n, strategy))
    if n == 1:
        return flat
    return _run_dist(_dist_program(strategy, "reduce_scatter", n, factors,
                                   order=True), flat, owned, mesh,
                     mesh.line(axis_name))


def _dist_all_gather(x, axis_name, strategy, factors, schedule, mesh):
    n = mesh.axis_size(axis_name)
    flat, _, _ = _flat1(x)
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        return schedule.all_gather(flat, axis_name, mesh)
    if strategy not in ("psum", "auto", "ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if n == 1:
        return flat
    return _dist_program(strategy, "all_gather", n, factors,
                         order=True).run_dist(flat, mesh,
                                              mesh.line(axis_name))


def _census_axis(a: dict, out, of: str = "x", scale: bool = False):
    """(per-rank bytes, axis size) of a call on axis a["axis_name"]: of
    the input a[of], or of `out` (a reduce-scatter's shard times the
    axis: the padded operand; an all-gather's gathered result)."""
    t = a[of] if of != "out" else out
    if is_process_mesh(a["mesh"]):
        n = a["mesh"].axis_size(a["axis_name"])
        return analysis.rank_bytes(t, 1) * (n if scale else 1), n
    sizes, _, n, R = _axis(a["x"], a["axis_name"], a["mesh"])
    return analysis.rank_bytes(t, R) * (n if scale else 1), n


def _census_psum(a: dict, out):
    if is_process_mesh(a["mesh"]):
        pm = a["mesh"]
        return analysis.rank_bytes(a["x"], 1), math.prod(
            pm.axis_size(ax) for ax in pm.key(a["axis_names"]))
    names, sizes = _mesh_sizes(a["x"], list(a["axis_names"]), a["mesh"])
    n = math.prod(sizes[names.index(ax)] for ax in set(a["axis_names"]))
    return analysis.rank_bytes(a["x"], math.prod(sizes)), n


@analysis.collective("all-reduce", _census_axis)
def allreduce(x: torch.Tensor, axis_name: str, strategy: str = "psum",
              factors: Sequence[int] | None = None, schedule=None, *,
              mesh=None) -> torch.Tensor:
    """AllReduce the ranks' rows over `axis_name` with the selected plan
    type; returns x's shape, every rank's data the sum over the axis.

    strategy ∈ {psum, ring, rhd, cps, hcps, plan}; "plan" runs a
    `core.lower.CompiledSchedule` passed as `schedule` (`run_local`, the
    groups of other mesh axes side by side in its columns). The flat
    strategies pad to `_pad_multiple` and run their reduce-scatter and
    all-gather halves (hcps in its native shard order).

    On a process mesh (`core.transport.ProcessMesh`) x is this rank's
    tensor and the axis its process group: the same programs run as
    that rank (`FlatProgram.run_dist`, "plan" the schedule's
    `allreduce`), and the result equals the local mesh's row bit for
    bit."""
    if is_process_mesh(mesh):
        return _dist_allreduce(x, axis_name, strategy, factors, schedule,
                               mesh)
    sizes, dim, n, R = _axis(x, axis_name, mesh)
    if n == 1:
        return x
    Q = axis_rows(sizes, (dim,))
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        flat, _, _ = _flat(x, R)
        return _from_axis(schedule.run_local(_to_axis(flat, Q)),
                          Q).reshape(x.shape)
    if strategy == "psum":
        flat, _, _ = _flat(x, R)
        return _run(flat_program("psum", "allreduce", sizes, (dim,)), flat,
                    False).reshape(x.shape)
    if strategy not in ("ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "hcps" and factors is None:
        raise ValueError("hcps needs fan-in factors")
    fac = tuple(factors) if strategy == "hcps" else None
    flat, pad, owned = _flat(x, R, _pad_multiple(n, strategy))
    shard = _run(flat_program(strategy, "reduce_scatter", sizes, (dim,),
                              fac), flat, owned)
    full = flat_program(strategy, "all_gather", sizes, (dim,), fac).run(
        shard)
    if pad:
        full = full[:, :-pad]
    return full.reshape(x.shape)


@analysis.collective("reduce-scatter", lambda a, out: _census_axis(
    a, out, "out", scale=True))
def reduce_scatter(x: torch.Tensor, axis_name: str, strategy: str = "psum",
                   factors: Sequence[int] | None = None, schedule=None, *,
                   mesh=None) -> torch.Tensor:
    """ReduceScatter with the selected plan type; x padded to the axis
    multiple. Returns (*mesh, chunk): every strategy gives the FLAT shard,
    rank i slice i of the summed, padded vector (hcps re-ordered to
    natural holders). Non-power-of-two rhd shards over its pow2 core
    (L / p a rank): ranks beyond it hold an UNREDUCED slice of their own
    input, which only `all_gather(..., "rhd")` makes whole. "plan" runs
    `schedule.run_local_reduce_scatter` (a group at a time). On a
    process mesh, this rank's flat shard."""
    if is_process_mesh(mesh):
        return _dist_reduce_scatter(x, axis_name, strategy, factors,
                                    schedule, mesh)
    sizes, dim, n, R = _axis(x, axis_name, mesh)
    lead = x.shape[:len(sizes)]
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        flat, _, _ = _flat(x, R)
        L = flat.shape[1] + (-flat.shape[1]) % schedule.num_blocks
        out = _per_group(schedule.run_local_reduce_scatter, flat,
                         axis_rows(sizes, (dim,)), L // n)
        return out.reshape(*lead, -1)
    if strategy not in ("psum", "auto", "ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "hcps" and factors is None:
        raise ValueError("hcps needs fan-in factors")
    flat, _, owned = _flat(x, R, _pad_multiple(n, strategy))
    if n == 1:
        return flat.reshape(*lead, -1)
    fac = tuple(factors) if strategy == "hcps" else None
    out = _run(flat_program(strategy, "reduce_scatter", sizes, (dim,), fac,
                            order=True), flat, owned)
    return out.reshape(*lead, -1)


@analysis.collective("all-gather", lambda a, out: _census_axis(a, out,
                                                          "out"))
def all_gather(x: torch.Tensor, axis_name: str, strategy: str = "psum",
               factors: Sequence[int] | None = None, schedule=None, *,
               mesh=None) -> torch.Tensor:
    """Inverse of `reduce_scatter` for the same strategy: gathers every
    rank's flat shard (*mesh, chunk) into the full (padded) vector (*mesh,
    n·chunk) on every rank. The shards are in natural order (rank i slice
    i), as `reduce_scatter` returns them; hcps un-reorders to its native
    holders before its doubling stages. rhd at n ≠ p gathers the core's
    shards and copies them out to the extras. On a process mesh, x is
    this rank's flat shard and the result its flat gathered vector."""
    if is_process_mesh(mesh):
        return _dist_all_gather(x, axis_name, strategy, factors, schedule,
                                mesh)
    sizes, dim, n, R = _axis(x, axis_name, mesh)
    lead = x.shape[:len(sizes)]
    flat, _, _ = _flat(x, R)
    if strategy == "plan":
        if schedule is None:
            raise ValueError("strategy='plan' needs a schedule")
        out = _per_group(schedule.run_local_all_gather, flat,
                         axis_rows(sizes, (dim,)), n * flat.shape[1])
        return out.reshape(*lead, -1)
    if strategy not in ("psum", "auto", "ring", "rhd", "cps", "hcps"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if n == 1:
        return flat.reshape(*lead, -1)
    if strategy == "hcps" and factors is None:
        raise ValueError("hcps needs fan-in factors")
    fac = tuple(factors) if strategy == "hcps" else None
    out = flat_program(strategy, "all_gather", sizes, (dim,), fac,
                       order=True).run(flat)
    return out.reshape(*lead, -1)


@analysis.collective("all-to-all", _census_axis)
def all_to_all(x: torch.Tensor, axis_name: str, schedule=None, *,
               mesh=None) -> torch.Tensor:
    """AllToAll over the ranks' chunks: rank d's chunk j goes to rank j as
    chunk d (the expert-parallel dispatch/combine primitive). Each rank's
    size must divide by the axis size. With `schedule` (a lowered
    `CompiledSchedule` of family "all_to_all") the exchange runs the
    plan's rounds (`run_local_all_to_all`, a group at a time); otherwise
    one copy. Returns x's shape. On a process mesh x is this rank's
    tensor."""
    if is_process_mesh(mesh):
        n = mesh.axis_size(axis_name)
        flat, _, _ = _flat1(x)
        if flat.numel() % n:
            raise ValueError(f"all_to_all: {flat.numel()} elements a rank "
                             f"do not split into {n} chunks")
        if schedule is not None:
            return schedule.all_to_all(flat, axis_name, mesh).reshape(
                x.shape)
        return flat_program("all_to_all", "", (n,), (0,)).run_dist(
            flat, mesh, mesh.line(axis_name)).reshape(x.shape)
    sizes, dim, n, R = _axis(x, axis_name, mesh)
    flat, _, _ = _flat(x, R)
    if flat.shape[1] % n:
        raise ValueError(f"all_to_all: {flat.shape[1]} elements a rank do "
                         f"not split into {n} chunks")
    if schedule is not None:
        out = _per_group(schedule.run_local_all_to_all, flat,
                         axis_rows(sizes, (dim,)), flat.shape[1])
    else:
        out = flat_program("all_to_all", "", sizes, (dim,)).run(flat)
    return out.reshape(x.shape)


@analysis.collective("all-reduce", _census_psum)
def psum(x: torch.Tensor, axis_names: Sequence[str], *, mesh=None
         ) -> torch.Tensor:
    """The sum over every axis of `axis_names` at once (the reference's
    `lax.psum(g, names)`): one fold of all their ranks a group. On a
    process mesh the group is this rank's line over those axes, its
    ranks in row-major order."""
    if is_process_mesh(mesh):
        key = mesh.key(axis_names)
        sizes = tuple(mesh.axis_size(a) for a in key)
        if not key or math.prod(sizes) == 1:
            return x
        flat, _, owned = _flat1(x)
        return _run_dist(flat_program("psum", "allreduce", sizes,
                                      tuple(range(len(sizes)))),
                         flat, owned, mesh, mesh.line(key)).reshape(x.shape)
    names, sizes = _mesh_sizes(x, list(axis_names), mesh)
    dims = tuple(sorted(names.index(a) for a in axis_names))
    if not dims or math.prod(sizes[d] for d in dims) == 1:
        return x
    flat, _, _ = _flat(x, math.prod(sizes))
    return flat_program("psum", "allreduce", sizes, dims).run(
        flat).reshape(x.shape)


# one process-wide warning when allreduce_planned degrades to the flat
# plan-type labels (tests reset this to re-assert the warning fires)
_planned_fallback_warned = False


@analysis.collective("all-reduce", _census_axis)
def allreduce_planned(x: torch.Tensor, axis_name: str, *, service=None,
                      bucketing=None, precision: str | None = None,
                      tolerance: float | None = None,
                      stats: dict | None = None, mesh=None) -> torch.Tensor:
    """AllReduce that runs the PlannerService's GenTree plan directly (the
    service's `get_axis_executable` at the per-rank size), bound to the
    wire `precision` asks for within `tolerance`
    (`cost_model.resolve_precision`), or, with a tolerance alone, to the
    precision the planner's priced argmin picks.

    `bucketing` (a `core.bucketing.BucketConfig`) splits each rank's data
    into GenModel-sized buckets run through the bucket executor
    (`core.bucketing.execute_buckets`); `precision` / `tolerance`
    override its own fields. Falls back to the flat plan-type labels
    only if the plan cannot be lowered (`LoweringError`) or the service
    returns no schedule: the fallback ignores any bucketing config and
    any compression, warns once per process, and records its reason in
    `stats` (`{"mode", "fallback_reason", "bucketing_ignored", ...}`).
    Its flat collectives still fold through the kernel; no kernel or
    launch error is caught.

    On a process mesh (`core.transport.ProcessMesh`) x is this rank's
    tensor, the service is priced at its `numel()`, and every branch runs
    over the axis's process group: the plan (and its wire) through the
    schedule's process-mesh `allreduce`, the buckets through
    `execute_buckets(mesh=)`, the fallback through the flat programs.
    Every rank prices alike, so every rank takes the same branch and
    fills the same `stats`; each result equals the local mesh's row of
    that rank bit for bit (on a mesh of several axes, the local mesh run
    a group of the other axes at a time)."""
    from repro_torch.core.lower import LoweringError
    from repro_torch.planner.service import default_service
    svc = service or default_service()
    if stats is None:
        stats = {}
    else:
        stats.clear()   # a reused dict must not mix keys across calls
    pm = is_process_mesh(mesh)
    if pm:
        n, size = mesh.axis_size(axis_name), x.numel()
    else:
        sizes, dim, n, R = _axis(x, axis_name, mesh)
        size = x.numel() // R
    if n < 2:
        stats["mode"] = "noop"
        return x
    if (precision is not None or tolerance is not None) \
            and bucketing is not None:
        import dataclasses as _dc
        bucketing = _dc.replace(
            bucketing,
            precision=precision if precision is not None
            else bucketing.precision,
            tolerance=tolerance if tolerance is not None
            else bucketing.tolerance)
    reason = None
    try:
        if bucketing is not None and bucketing.enabled:
            from repro_torch.core.bucketing import (Bucket, execute_buckets,
                                                    supports_halves)
            bplan = svc.get_bucket_plan([(axis_name, int(n))], float(size),
                                        dtype=str(x.dtype).replace(
                                            "torch.", ""),
                                        config=bucketing)
            # one array has no leaf boundaries: chunk it into bucket-sized
            # pieces, each its own bucket
            bf = max(1, int(bplan.bucket_floats))
            if pm:
                rows = _flat1(x)[0].reshape(1, -1)
            else:
                Q = axis_rows(sizes, (dim,))
                rows = _to_axis(_flat(x, R)[0], Q)
            pieces = [rows[:, off:off + bf]
                      for off in range(0, max(rows.shape[1], 1), bf)]
            buckets = [Bucket(indices=(i,), sizes=(p.shape[1],),
                              dtype=p.dtype)
                       for i, p in enumerate(pieces) if p.shape[1]]
            out = execute_buckets(pieces, buckets, bplan.axis_plans,
                                  pipeline=bucketing.pipeline,
                                  mesh=mesh if pm else None)
            halved = supports_halves(bplan.axis_plans)
            stats.update(mode="bucketed", bucket_floats=bf,
                         num_buckets=len(buckets), halves=halved,
                         precision=bplan.precision,
                         pipeline=bool(bucketing.pipeline and halved
                                       and len(buckets) > 1))
            got = out[0] if len(out) == 1 else torch.cat(out, dim=1)
            return (got if pm else _from_axis(got, Q)).reshape(x.shape)
        resp = svc.get_axis_executable(axis_name, int(n), float(size))
    except LoweringError as e:
        reason = f"plan could not be lowered: {e}"
        resp = None
    if resp is not None and resp.schedule is not None:
        from repro_torch.core.cost_model import resolve_precision
        prec = None
        if precision is not None:
            prec = resolve_precision(precision, tolerance)
        elif tolerance is not None:
            # tolerance without a pin: the planner's priced precision
            # argmin at one monolithic bucket
            from repro_torch.core.bucketing import BucketConfig
            from repro_torch.core.cost_model import PRECISIONS
            mono = BucketConfig(bucket_bytes=int(max(size, 1)) * 4,
                                tolerance=tolerance)
            sel = svc.get_bucket_plan([(axis_name, int(n))], float(size),
                                      dtype=str(x.dtype).replace(
                                          "torch.", ""), config=mono)
            prec = PRECISIONS[sel.precision]
        sched = resp.schedule
        if prec is not None and prec.name != "f32":
            sched = sched.with_wire(prec)
        stats.update(mode="plan", algo=resp.algo, source=resp.source,
                     precision=prec.name if prec is not None else "f32")
        return allreduce(x, axis_name, "plan", schedule=sched, mesh=mesh)
    # ---- flat-label fallback ----------------------------------------------
    reason = reason or "service returned no executable schedule"
    stats.update(mode="flat-label", fallback_reason=reason,
                 bucketing_ignored=bucketing is not None
                 and bucketing.enabled)
    global _planned_fallback_warned
    if not _planned_fallback_warned:
        _planned_fallback_warned = True
        import warnings
        warnings.warn(
            "allreduce_planned fell back to flat plan-type labels "
            f"({reason})"
            + ("; the requested bucketing config is IGNORED on this path"
               if stats["bucketing_ignored"] else ""),
            RuntimeWarning, stacklevel=2)
    plans = svc.get_axis_plans([(axis_name, int(n))], float(size))
    if not plans:
        stats["mode"] = "psum"
        return allreduce(x, axis_name, "psum", mesh=mesh)
    pl = plans[0]
    stats["strategy"] = pl.strategy
    return allreduce(x, axis_name, pl.strategy, factors=pl.factors,
                     mesh=mesh)
