"""The transport of a process mesh: one process a rank over
`torch.distributed`.

A `ProcessMesh` is one process's view of a mesh whose ranks are separate
processes: the axes in the reference's mesh order (e.g. `(("pod", 2),
("data", 4))`), this rank and its coordinates (its rank is their
row-major index), the backend, the device, and this rank's line of the
mesh for every set of axes: the ranks that differ only in those axes,
one `torch.distributed` group (`launch.mesh.init_process_mesh` builds
them, every process in the same order).

`exchange` is the counterpart of one `lax.ppermute` round: one rank's
sends and receives in one group, posted as one `dist.batch_isend_irecv`.
Payloads travel as raw bytes (`uint8` views), so f32, bf16, fp8 and int8
wires and their f32 scales cross any backend. The transport follows the
mesh's backend, which the caller chooses and which is never swapped for
another:

  * "nccl": CUDA tensors go to the wire as they are, one card a rank;
  * "gloo": CPU tensors as they are; CUDA tensors are staged through
    pinned host buffers each round. This is the one-card transport: N
    processes share one card, each with its own buffers and kernels,
    and a round's bytes cross through the host. Its times measure host
    staging, not links (`ProcessMesh.transport`).

The four tensor-parallel operators (`copy_to_line`, `reduce_over_line`,
`gather_over_line`, `slice_for_line`) are differentiable, each the
other's transpose in pairs, over one line (the auto engine's "model"
line, `models.actsharding.TPContext`): a product whose weight the line
shards runs on each rank's slice, and the activations between products
are the same bits on every rank of the line. A sum over the line is
taken in line order from every rank's rows (`line_sum`), so every rank
computes it alike.

Importing this module starts no process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Line:
    """One process group: its global ranks in row-major order of its axes
    and this process's index among them."""
    group: object
    ranks: tuple[int, ...]
    index: int
    # the payload bytes this rank has sent over the line (`exchange`)
    sent: int = 0

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(eq=False)
class ProcessMesh:
    """This process's view of a mesh of one process a rank: the axes in
    the reference's mesh order, this rank and its coordinates, the
    backend, the device, and this rank's line (process group) of every
    set of axes (`line`)."""
    axes: tuple[tuple[str, int], ...]
    rank: int
    coords: tuple[int, ...]
    backend: str
    device: torch.device
    lines: dict = field(default_factory=dict, repr=False)
    _pinned: dict = field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @property
    def transport(self) -> str:
        """How a round's bytes travel: "nccl", "gloo" (CPU tensors) or
        "gloo through the host" (CUDA tensors staged in pinned memory)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo through the host"
        return self.backend

    def axis_size(self, axis: str) -> int:
        return dict(self.axes)[self._known(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[self.axis_names.index(self._known(axis))]

    def _known(self, axis: str) -> str:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not in the mesh "
                             f"{list(self.axes)}")
        return axis

    def key(self, axes) -> tuple[str, ...]:
        """The canonical key of a set of axes: their names in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            self._known(a)
        return tuple(a for a in self.axis_names if a in names)

    def line(self, axes) -> Line:
        """This rank's group over `axes` (a name or several)."""
        return self.lines[self.key(axes)]

    def pinned(self, role: str, nbytes: int) -> torch.Tensor:
        """A pinned host buffer of at least `nbytes` bytes for `role`,
        grown as needed and kept for the next round."""
        buf = self._pinned.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 20) if buf is None else
                              max(nbytes, buf.numel() * 3 // 2),
                              dtype=torch.uint8, pin_memory=True)
            self._pinned[role] = buf
        return buf[:nbytes]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("a payload must be contiguous")
    return t.reshape(-1).view(torch.uint8)


def exchange(mesh: ProcessMesh, line: Line,
             sends: Sequence[tuple[int, torch.Tensor]],
             recvs: Sequence[tuple[int, torch.Tensor]]) -> None:
    """One round of this rank in `line`: send each (peer, tensor) of
    `sends` and receive into each (peer, tensor) of `recvs` (peers are
    indices into `line.ranks`; tensors contiguous, received in place),
    posted together as one `dist.batch_isend_irecv` and waited for.
    Between two ranks, payloads match in the order posted. A rank with
    nothing to move posts nothing; empty payloads are skipped on both
    sides."""
    sends = [(p, _bytes(t)) for p, t in sends if t.numel()]
    recvs = [(p, _bytes(t)) for p, t in recvs if t.numel()]
    if not sends and not recvs:
        return
    line.sent += sum(t.numel() for _, t in sends)
    for p, _ in list(sends) + list(recvs):
        if not 0 <= p < line.size or p == line.index:
            raise ValueError(f"peer {p} of a line of {line.size} (this "
                             f"rank is {line.index})")
    staged = mesh.backend == "gloo" and any(
        t.device.type == "cuda" for _, t in sends + recvs)
    wire_s, wire_r = sends, recvs
    if staged:
        host_s = mesh.pinned("send", sum(t.numel() for _, t in sends))
        host_r = mesh.pinned("recv", sum(t.numel() for _, t in recvs))
        wire_s, off = [], 0
        for p, t in sends:
            h = host_s[off:off + t.numel()]
            h.copy_(t, non_blocking=True)
            wire_s.append((p, h))
            off += t.numel()
        wire_r, off = [], 0
        for p, t in recvs:
            wire_r.append((p, host_r[off:off + t.numel()]))
            off += t.numel()
        torch.cuda.current_stream(sends[0][1].device if sends
                                  else recvs[0][1].device).synchronize()
    ops = ([dist.P2POp(dist.isend, t, line.ranks[p], line.group)
            for p, t in wire_s]
           + [dist.P2POp(dist.irecv, t, line.ranks[p], line.group)
              for p, t in wire_r])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (_, t), (_, h) in zip(recvs, wire_r):
            t.copy_(h, non_blocking=True)
        if recvs:
            # the pinned buffers are reused by the next round
            torch.cuda.current_stream(recvs[0][1].device).synchronize()


def all_gather_rows(mesh: ProcessMesh, line: Line,
                    x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` in `line`, stacked in line order (a small
    all-gather through `exchange`, for scalars and checksums)."""
    x = x.contiguous()
    out = x.new_empty((line.size, *x.shape))
    out[line.index] = x
    peers = [p for p in range(line.size) if p != line.index]
    exchange(mesh, line, [(p, x) for p in peers],
             [(p, out[p]) for p in peers])
    return out


class _GatherRows(torch.autograd.Function):
    """`all_gather_rows` whose backward is its transpose: each rank's
    cotangent of its own rows, summed over the line in line order (a
    reduce-scatter through `exchange`)."""

    @staticmethod
    def forward(ctx, x, mesh, line):
        ctx.mesh, ctx.line = mesh, line
        return all_gather_rows(mesh, line, x)

    @staticmethod
    def backward(ctx, g):
        mesh, line = ctx.mesh, ctx.line
        g = g.contiguous()
        got = g.new_empty(g.shape)
        got[line.index] = g[line.index]
        peers = [p for p in range(line.size) if p != line.index]
        exchange(mesh, line, [(p, g[p]) for p in peers],
                 [(p, got[p]) for p in peers])
        return got.sum(0), None, None


def all_gather_rows_diff(mesh: ProcessMesh, line: Line,
                         x: torch.Tensor) -> torch.Tensor:
    """`all_gather_rows`, differentiable: every rank of `line` calls it
    alike, in the forward and (through autograd) in the backward."""
    return _GatherRows.apply(x.contiguous(), mesh, line)


def line_sum(mesh: ProcessMesh, line: Line, x: torch.Tensor
             ) -> torch.Tensor:
    """Every rank's `x` in `line` summed in line order, the same bits on
    every rank; a half-precision `x` is summed in f32 and rounded once."""
    rows = all_gather_rows(mesh, line, x)
    if x.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    out = rows[0]
    for r in rows[1:]:
        out = out + r
    return out.to(x.dtype)


def _gather_along(mesh: ProcessMesh, line: Line, x: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """Every rank's `x` in `line`, concatenated along `dim` in line order."""
    return torch.cat(all_gather_rows(mesh, line, x.contiguous()).unbind(0),
                     dim=dim)


def _slice_along(line: Line, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's 1/line.size of `x` along `dim`, a contiguous copy."""
    n = x.shape[dim] // line.size
    return x.narrow(dim, line.index * n, n).contiguous()


class _CopyToLine(torch.autograd.Function):
    """Identity forward; the cotangents summed over the line backward."""

    @staticmethod
    def forward(ctx, x, mesh, line):
        ctx.mesh, ctx.line = mesh, line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return line_sum(ctx.mesh, ctx.line, g.contiguous()), None, None


class _ReduceOverLine(torch.autograd.Function):
    """The sum over the line forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, line):
        return line_sum(mesh, line, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOverLine(torch.autograd.Function):
    """Every rank's slice concatenated along `dim` forward; this rank's
    slice of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, mesh, line, dim):
        ctx.line, ctx.dim = line, dim
        return _gather_along(mesh, line, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice_along(ctx.line, g, ctx.dim), None, None, None


class _SliceForLine(torch.autograd.Function):
    """This rank's slice along `dim` forward; the ranks' cotangents
    concatenated backward."""

    @staticmethod
    def forward(ctx, x, mesh, line, dim):
        ctx.mesh, ctx.line, ctx.dim = mesh, line, dim
        return _slice_along(line, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(ctx.mesh, ctx.line, g, ctx.dim), None, None, \
            None


def copy_to_line(mesh: ProcessMesh, line: Line, x: torch.Tensor
                 ) -> torch.Tensor:
    """`x` as it is; backward, its cotangent summed over `line`: the input
    of products on this rank's slice of a weight."""
    return _CopyToLine.apply(x, mesh, line)


def reduce_over_line(mesh: ProcessMesh, line: Line, x: torch.Tensor
                     ) -> torch.Tensor:
    """The ranks' partial `x` summed over `line` (`line_sum`); backward,
    the cotangent as it is on every rank."""
    return _ReduceOverLine.apply(x, mesh, line)


def gather_over_line(mesh: ProcessMesh, line: Line, x: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """The ranks' slices of a tensor concatenated along `dim`, in line
    order; backward, this rank's slice of the cotangent."""
    return _GatherOverLine.apply(x, mesh, line, dim)


def slice_for_line(mesh: ProcessMesh, line: Line, x: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """This rank's 1/line.size of `x` along `dim`; backward, the ranks'
    cotangents concatenated (`x`'s dim must divide evenly)."""
    return _SliceForLine.apply(x, mesh, line, dim)


def is_process_mesh(mesh) -> bool:
    """Whether `mesh` is a `ProcessMesh` (one process a rank), not the
    local mesh's (axis, size) pairs."""
    return isinstance(mesh, ProcessMesh)
