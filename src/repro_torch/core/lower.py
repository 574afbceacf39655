"""Lowering: block-annotated Plan IR → executable schedules on a local
mesh (DESIGN.md §8).

`lower_plan` compiles any block-annotated `Plan` (the flat builders in
`core.plans`, GenTree output, baseline plans) into a `CompiledSchedule`:
a sequence of permutation rounds plus N-ary fold phases. The compile half
is the reference package's, unchanged: the same Plan the simulator prices
is what the ranks run, round for round and fold for fold.

Execution runs on a *local mesh*: `n` ranks whose per-rank buffers are
the leading axis of one `(n, blocks, chunk)` tensor on one device, held
as `n·blocks` rows of `chunk` lanes. Per synchronized step:

  * one round (`PermRound`) is one gather of the sent block rows from
    the working buffer into the receivers' staging rows, over all pairs
    of the round, as plain tensor indexing;
  * one fold phase (`FoldPhase`) is ONE launch of the fused-reduce kernel
    (`kernels.ops.fused_reduce_into`) over every folding rank at once: it
    reads the staged copies through a row table, adds the rank's resident
    partial where the IR says so, and writes the f32 sum straight back
    into the target block row.

A schedule bound to a compressed wire (`with_wire`) quantizes each
round's payload with the `quantize` kernel (fp8/int8, per-tile f32 scales
riding beside it) or casts it (bf16), and folds with the fused
dequant-reduce kernel (`quant_reduce_into`). A fold phase that only lands
copies (one operand a rank, no resident partial: every step of a
movement family, the AllGather half, the shard reorder) is one
`dequantize_into` launch on a scaled wire instead. Masked fold operands
are row −1 in the table and never read, so staging buffers need no
zeroing.

Entry points, each with the reference's family check and canonical-shard
rules: `run_local` (AllReduce), `run_local_reduce_scatter`,
`run_local_all_gather`, `run_local_all_to_all` and `run_local_p2p`. The
reference package's `run_numpy` and its shard_map entry points are what
the equivalence tests hold them against. A collective over
`torch.distributed` process groups (one card per rank) belongs to the
trainer slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.runtime.trace import default_tracer

from .plans import Plan


class LoweringError(ValueError):
    """A Plan that cannot be compiled into an executable schedule."""


# ---------------------------------------------------------------------------
# Compiled structures (numpy constants, indexed by mesh position)
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class PermRound:
    """One partial permutation. Each device sends at most one *payload*
    per round — a stack of up to W block rows to a single peer (all the
    step's moves between one (src, dst) pair coalesce into one payload,
    so e.g. RHD's half-vector exchange is ONE transfer, not size/2 of
    them); -1 entries pad payloads narrower than the round width."""
    perm: tuple[tuple[int, int], ...]   # (src_mesh, dst_mesh) pairs
    send_blks: np.ndarray               # (n, W) block rows sent, -1 = pad
    recv_off: np.ndarray                # (n,) first staging row, -1 = none


@dataclass(eq=False)
class FoldPhase:
    """One fold slot: per device, which staged copies (plus optionally the
    resident partial) collapse into which block row."""
    blk: np.ndarray                     # (n,) target block row, -1 = idle
    ops: np.ndarray                     # (n, K) staging rows, -1 = masked
    include_self: np.ndarray            # (n,) bool: resident partial is an operand


@dataclass(eq=False)
class ExecStep:
    rounds: list[PermRound] = field(default_factory=list)
    n_slots: int = 0
    folds: list[FoldPhase] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Local-mesh index tables: the numpy round/fold tables turned once into
# flat row indices on the executing device, then reused by every launch.
# Rank m's block row b is working-buffer row m·nb + b; its staging row j
# is staging row m·slots + j.
# ---------------------------------------------------------------------------
def _device_tables(obj, device: torch.device, build, kind: str = ""):
    """`build(device)`, made once per (kind, device) and cached on `obj`."""
    cache = obj.__dict__.setdefault("_device_tables", {})
    key = (kind, str(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = build(device)
    return t


def _round_tables(rd: PermRound, nb: int, slots: int,
                  device: torch.device):
    """(working-buffer rows (R,), staging rows (R,)) of the round's R live
    payload rows; padding entries move nothing (no fold reads them)."""
    def build(dev):
        src, dst = [], []
        for s, d in rd.perm:
            for j, b in enumerate(rd.send_blks[s]):
                if b >= 0:
                    src.append(s * nb + b)
                    dst.append(d * slots + rd.recv_off[d] + j)
        return (torch.tensor(src, dtype=torch.int64, device=dev),
                torch.tensor(dst, dtype=torch.int64, device=dev))
    return _device_tables(rd, device, build)


def _fold_table(fd: FoldPhase, nb: int, slots: int, device: torch.device):
    """The fold phase as one gathered reduce (`kernels.ops.RowTable`)
    over its A folding ranks: operand staging rows (A, K), −1 = masked;
    the target working-buffer rows; the resident partial, where the IR
    includes it, read from the target row itself."""
    from repro_torch.kernels import ops as kops

    def build(dev):
        act = np.nonzero(fd.blk >= 0)[0].astype(np.int64)
        ops = fd.ops[act]
        out_rows = act * nb + fd.blk[act]
        return kops.row_table(
            np.where(ops >= 0, act[:, None] * slots + ops, -1), out_rows,
            np.where(fd.include_self[act], out_rows, -1), dev)
    return _device_tables(fd, device, build)


def _landing_table(fd: FoldPhase, nb: int, slots: int,
                   device: torch.device):
    """The fold phase as one gathered dequantize (`kernels.ops.RowTable`
    of one operand a row), or None where it is not a pure landing: some
    folding rank adds a resident partial or has other than one live
    operand."""
    from repro_torch.kernels import ops as kops

    def build(dev):
        act = np.nonzero(fd.blk >= 0)[0].astype(np.int64)
        ops = fd.ops[act]
        if fd.include_self[act].any() or ((ops >= 0).sum(axis=1) != 1).any():
            return None
        return kops.row_table(act[:, None] * slots + ops.max(axis=1)[:, None],
                              act * nb + fd.blk[act], device=dev)
    return _device_tables(fd, device, build, kind="landing")


@dataclass(eq=False)
class CompiledSchedule:
    """An executable AllReduce over a local mesh of `n` ranks."""
    plan_name: str
    n: int
    num_blocks: int
    rs: list[ExecStep]                  # ReduceScatter half
    ag: list[ExecStep]                  # AllGather half
    owner_of_block: np.ndarray          # (num_blocks,) mesh index post-RS
    # canonical-shard support (num_blocks % n == 0): device i's shard is
    # blocks [i*k, (i+1)*k) after the reorder round
    blocks_per_shard: int | None
    reorder: ExecStep | None            # post-RS: owner(b) → b // k
    unorder: ExecStep | None            # pre-AG inverse of `reorder`
    placement: tuple[int, ...]          # server id at each mesh index
    # wire format (cost_model.Precision) for compressed execution: rounds
    # move quantized payloads + per-tile f32 scales and folds run the
    # fused dequant-reduce. None = full precision.
    wire: object | None = None
    # Collective family this schedule computes (plans.FAMILIES). The
    # entry points enforce it: an allgather-family schedule only answers
    # run_local_all_gather(), an all_to_all-family one only
    # run_local_all_to_all(), etc.
    family: str = "allreduce"
    # p2p family only: the (src_mesh, dst_mesh) edges, for introspection.
    perm_pairs: tuple[tuple[int, int], ...] | None = None

    def with_wire(self, precision) -> "CompiledSchedule":
        """A copy of this schedule bound to a wire format (or None to
        strip it). Variants are memoized per wire name: re-resolving the
        same schedule at the same precision returns the SAME object, so
        guard wrappers — memoized per schedule object — keep their stats
        across re-resolves."""
        import dataclasses
        if precision is not None and precision.name == "f32":
            precision = None
        if precision is None and self.wire is None:
            return self
        name = precision.name if precision is not None else ""
        variants = self.__dict__.setdefault("_wire_variants", {})
        v = variants.get(name)
        if v is None:
            # replace() copies declared fields only: the variant starts
            # with a clean __dict__ (no inherited guard wrapper / memo)
            v = dataclasses.replace(self, wire=precision)
            variants[name] = v
        return v

    # ---- stats -------------------------------------------------------------
    def total_rounds(self) -> int:
        return sum(len(st.rounds) for st in self.rs + self.ag)

    def describe(self) -> str:
        w = f" wire={self.wire.name}" if self.wire is not None else ""
        f = f" family={self.family}" if self.family != "allreduce" else ""
        return (f"{self.plan_name}: n={self.n} blocks={self.num_blocks} "
                f"steps={len(self.rs)}+{len(self.ag)} "
                f"ppermute_rounds={self.total_rounds()}{w}{f}")

    def _check_family(self, entry: str, allowed: tuple[str, ...]) -> None:
        if self.family not in allowed:
            raise LoweringError(
                f"schedule {self.plan_name!r} compiles a "
                f"{self.family!r}-family plan — {entry}() only runs "
                f"{'/'.join(allowed)} schedules")

    # ---- local-mesh execution ---------------------------------------------
    def _check_rows(self, entry: str, X: torch.Tensor) -> None:
        if X.dim() != 2 or X.shape[0] != self.n:
            raise LoweringError(f"expected a ({self.n}, size) tensor of "
                                f"per-rank rows; got {tuple(X.shape)}")
        if X.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{entry} takes f32 or bf16; got {X.dtype}")

    def _check_shards(self, entry: str) -> int:
        if self.blocks_per_shard is None:
            raise LoweringError(
                f"plan {self.plan_name!r} shards {self.num_blocks} blocks "
                f"over {self.n} devices — no canonical per-device shard; "
                f"{entry}() needs one")
        return self.blocks_per_shard

    def _padded_buffer(self, X: torch.Tensor) -> torch.Tensor:
        """A private (n·num_blocks, chunk) working copy of X, each rank's
        row zero-padded to a multiple of num_blocks."""
        pad = (-X.shape[1]) % self.num_blocks
        buf = (torch.nn.functional.pad(X, (0, pad)) if pad
               else X.clone(memory_format=torch.contiguous_format))
        return buf.reshape(self.n * self.num_blocks, -1)

    def run_local(self, X: torch.Tensor) -> torch.Tensor:
        """AllReduce on a local mesh: X is the (n, size) tensor of the n
        ranks' contributions (f32 or bf16, on any device); returns the
        (n, size) per-rank results, every row the column sum. Rounds and
        folds run on X's device; on a CUDA device every fold is a kernel
        launch. The working buffer is a private copy, updated in place.

        Tracer spans record the schedule's structure (step, round, fold,
        width, fan); on a CUDA device their durations measure the host's
        enqueue, not the device's execution."""
        self._check_family("run_local", ("allreduce",))
        self._check_rows("run_local", X)
        size = X.shape[1]
        buf = self._padded_buffer(X)
        with default_tracer().span("exec/run_local", plan=self.plan_name,
                                   n=self.n, blocks=self.num_blocks):
            self._run_steps_local(self.rs, buf, phase="rs")
            self._run_steps_local(self.ag, buf, phase="ag")
        out = buf.reshape(self.n, -1)
        return out[:, :size] if out.shape[1] != size else out

    def run_local_reduce_scatter(self, X: torch.Tensor, *,
                                 overwrite: bool = False) -> torch.Tensor:
        """ReduceScatter on a local mesh: X (n, size) as for `run_local`;
        returns (n, size_padded / n), row i rank i's canonical shard —
        blocks [i·k, (i+1)·k) of the column sum of the rows zero-padded to
        a multiple of num_blocks (k = blocks_per_shard).

        With `overwrite`, X itself is the working buffer (no private copy):
        it must be contiguous with size a multiple of num_blocks, and
        holds partial sums afterwards. The result is the same."""
        self._check_family("run_local_reduce_scatter",
                           ("allreduce", "reduce_scatter"))
        k = self._check_shards("run_local_reduce_scatter")
        self._check_rows("run_local_reduce_scatter", X)
        if overwrite:
            if X.shape[1] % self.num_blocks or not X.is_contiguous():
                raise LoweringError(
                    f"an overwritable reduce-scatter operand must be "
                    f"contiguous with a multiple of {self.num_blocks} "
                    f"elements a rank; got {tuple(X.shape)}, contiguous="
                    f"{X.is_contiguous()}")
            buf = X.view(self.n * self.num_blocks, -1)
        else:
            buf = self._padded_buffer(X)
        with default_tracer().span("exec/reduce_scatter",
                                   plan=self.plan_name, n=self.n):
            self._run_steps_local(self.rs, buf, phase="rs")
            if self.reorder is not None:
                self._run_steps_local([self.reorder], buf, phase="reorder")
        n = self.n
        # rank i's rows i·k .. (i+1)·k − 1 of its own num_blocks rows
        return (buf.view(n, n, k, -1).diagonal(dim1=0, dim2=1)
                .permute(2, 0, 1).reshape(n, -1))

    def run_local_all_gather(self, S: torch.Tensor) -> torch.Tensor:
        """AllGather on a local mesh: S (n, shard), row i rank i's
        canonical shard (shard a multiple of blocks_per_shard); returns
        (n, n·shard), every row the concatenation of the shards."""
        self._check_family("run_local_all_gather", ("allreduce", "allgather"))
        k = self._check_shards("run_local_all_gather")
        self._check_rows("run_local_all_gather", S)
        if S.shape[1] % k:
            raise LoweringError(f"a shard of {S.shape[1]} elements does not "
                                f"split into {k} blocks")
        n, chunk = self.n, S.shape[1] // k
        buf = torch.zeros((n * self.num_blocks, chunk), dtype=S.dtype,
                          device=S.device)
        buf.view(n, n, k, chunk).diagonal(dim1=0, dim2=1).copy_(
            S.reshape(n, k, chunk).permute(1, 2, 0))
        with default_tracer().span("exec/all_gather", plan=self.plan_name,
                                   n=self.n):
            if self.unorder is not None:
                self._run_steps_local([self.unorder], buf, phase="unorder")
            self._run_steps_local(self.ag, buf, phase="ag")
        return buf.reshape(n, -1)

    def run_local_all_to_all(self, X: torch.Tensor) -> torch.Tensor:
        """AllToAll on a local mesh: X (n, size), size a multiple of
        num_blocks; returns (n, size) where, with k = num_blocks / n, rank
        d's rows [s·k, (s+1)·k) of chunks are rank s's input chunks
        [d·k, (d+1)·k) — the reference's split-0/concat-0 exchange.
        Diagonal chunks never move."""
        self._check_family("run_local_all_to_all", ("all_to_all",))
        self._check_rows("run_local_all_to_all", X)
        if X.shape[1] % self.num_blocks:
            raise LoweringError(
                f"all_to_all operand of {X.shape[1]} elements does not "
                f"split into {self.num_blocks} equal chunks")
        buf = self._padded_buffer(X)
        with default_tracer().span("exec/all_to_all", plan=self.plan_name,
                                   n=self.n, blocks=self.num_blocks):
            self._run_steps_local(self.ag, buf, phase="a2a")
        return buf.reshape(self.n, -1)

    def run_local_p2p(self, X: torch.Tensor) -> torch.Tensor:
        """Point-to-point exchange on a local mesh: X (n, size); each
        compiled (src, dst) edge replaces row dst with row src, rows with
        no incoming edge keep theirs."""
        self._check_family("run_local_p2p", ("p2p",))
        self._check_rows("run_local_p2p", X)
        buf = self._padded_buffer(X)
        with default_tracer().span("exec/p2p", plan=self.plan_name,
                                   n=self.n):
            self._run_steps_local(self.ag, buf, phase="p2p")
        return buf.reshape(self.n, -1)

    def _run_steps_local(self, steps: Sequence[ExecStep], buf: torch.Tensor,
                         phase: str = "steps") -> None:
        """Run `steps` on the (n·nb, chunk) working buffer, in place."""
        from repro_torch.kernels import ops as kops

        if self.wire is not None:
            return self._run_steps_local_wire(steps, buf, phase)
        tracer = default_tracer()
        nb, chunk = self.num_blocks, buf.shape[1]
        for si, st in enumerate(steps):
            if not st.rounds and not st.folds:
                continue
            with tracer.span(f"exec/{phase}/step", step=si,
                             rounds=len(st.rounds), folds=len(st.folds),
                             plan=self.plan_name):
                slots = max(st.n_slots, 1)
                stage = torch.empty((self.n * slots, chunk),
                                    dtype=buf.dtype, device=buf.device)
                for ri, rd in enumerate(st.rounds):
                    with tracer.span("exec/round", round=ri,
                                     width=int(rd.send_blks.shape[1]),
                                     pairs=len(rd.perm)):
                        if rd.perm:
                            src, dst = _round_tables(rd, nb, slots,
                                                     buf.device)
                            stage[dst] = buf[src]
                for fi, fd in enumerate(st.folds):
                    with tracer.span("exec/fold", fold=fi,
                                     fan=int(fd.ops.shape[1])):
                        kops.fused_reduce_into(
                            stage, _fold_table(fd, nb, slots, buf.device),
                            buf)

    def _run_steps_local_wire(self, steps: Sequence[ExecStep],
                              buf: torch.Tensor,
                              phase: str = "steps") -> None:
        """Compressed mirror of `_run_steps_local` (DESIGN.md §13): each
        round quantizes its payload rows to the wire dtype (one `quantize`
        launch per round, per-tile f32 scales beside them), staging
        buffers hold wire bytes, and each fold runs the fused
        dequant-reduce over every folding rank in one `quant_reduce_into`
        launch — operands decode in registers and accumulate in f32 with
        the resident partial. A fold phase that only lands copies (one
        operand a rank, no partial) decodes them in one `dequantize_into`
        launch instead: the reference computes the same q·scale as a
        one-operand quant_reduce. bf16 (scale-free) wires skip the scale
        plumbing: plain casts, folded by `fused_reduce_into` in f32."""
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.ref import wire_dtype

        tracer = default_tracer()
        nb, chunk = self.num_blocks, buf.shape[1]
        dev = buf.device
        wire = self.wire
        tile = int(wire.scale_block or 0)
        scaled = tile > 0
        if scaled:
            nt = -(-chunk // tile)
            lanes = nt * tile
            qdtype = wire_dtype(wire.wire_dtype)
            store = torch.uint8          # wire bytes, viewed on use
        else:
            lanes = chunk
            store = getattr(torch, wire.wire_dtype)
        for si, st in enumerate(steps):
            if not st.rounds and not st.folds:
                continue
            with tracer.span(f"exec/{phase}/step", step=si,
                             rounds=len(st.rounds), folds=len(st.folds),
                             plan=self.plan_name, wire=wire.name):
                slots = max(st.n_slots, 1)
                stage_q = torch.empty((self.n * slots, lanes), dtype=store,
                                      device=dev)
                stage_s = (torch.empty((self.n * slots, nt),
                                       dtype=torch.float32, device=dev)
                           if scaled else None)
                for ri, rd in enumerate(st.rounds):
                    with tracer.span("exec/round", round=ri,
                                     width=int(rd.send_blks.shape[1]),
                                     pairs=len(rd.perm), wire=wire.name):
                        if not rd.perm:
                            continue
                        src, dst = _round_tables(rd, nb, slots, dev)
                        if scaled:
                            q, s = kops.quantize(buf[src].float(),
                                                 wire.wire_dtype, tile)
                            stage_q[dst] = q.view(torch.uint8)
                            stage_s[dst] = s
                        else:
                            stage_q[dst] = buf[src].to(store)
                for fi, fd in enumerate(st.folds):
                    with tracer.span("exec/fold", fold=fi,
                                     fan=int(fd.ops.shape[1]),
                                     wire=wire.name):
                        if not scaled:
                            kops.fused_reduce_into(
                                stage_q, _fold_table(fd, nb, slots, dev), buf)
                            continue
                        landing = _landing_table(fd, nb, slots, dev)
                        if landing is not None:
                            kops.dequantize_into(stage_q.view(qdtype),
                                                 stage_s, landing, buf, tile)
                        else:
                            kops.quant_reduce_into(
                                stage_q.view(qdtype), stage_s,
                                _fold_table(fd, nb, slots, dev), buf, tile)


# ---------------------------------------------------------------------------
# Compilation helpers
# ---------------------------------------------------------------------------
def _color_rounds(moves: list[tuple[int, int, int]], n: int
                  ) -> tuple[list[PermRound], int, dict[int, int]]:
    """Coalesce the step's moves per (src, dst) pair into one payload
    each, then greedily edge-color the payloads into partial permutations
    (≤1 send and ≤1 receive per device per round). Returns rounds, the
    staging depth, and each move's staging slot keyed by position in
    `moves`. A receiving device reserves the full round width W of
    staging rows (payloads narrower than W pad with zero rows that no
    fold references)."""
    edges: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for mi, (s, d, b) in enumerate(moves):
        edges.setdefault((s, d), []).append((mi, b))
    rounds: list[dict] = []
    for (s, d), items in edges.items():
        for r in rounds:
            if s not in r["senders"] and d not in r["receivers"]:
                break
        else:
            r = {"senders": set(), "receivers": set(), "edges": []}
            rounds.append(r)
        r["senders"].add(s)
        r["receivers"].add(d)
        r["edges"].append((s, d, items))

    slot_of: dict[int, int] = {}
    next_slot = [0] * n
    out = []
    max_w = 0
    for r in rounds:
        w = max(len(items) for _, _, items in r["edges"])
        max_w = max(max_w, w)
        send_blks = np.full((n, w), -1, dtype=np.int64)
        recv_off = np.full(n, -1, dtype=np.int64)
        perm = []
        for s, d, items in sorted(r["edges"]):
            perm.append((s, d))
            for j, (_mi, b) in enumerate(items):
                send_blks[s, j] = b
            recv_off[d] = next_slot[d]
            for j, (mi, _b) in enumerate(items):
                slot_of[mi] = next_slot[d] + j
            next_slot[d] += w
        out.append(PermRound(perm=tuple(perm), send_blks=send_blks,
                             recv_off=recv_off))
    # stage depth must also cover the widest round for devices that
    # receive nothing (their masked dynamic_slice still reads W rows)
    return out, max(max(next_slot, default=0), max_w), slot_of


def _build_folds(groups: dict[tuple[int, int], list[int]],
                 include_self: dict[tuple[int, int], bool],
                 n: int) -> list[FoldPhase]:
    """groups: (dst, blk) → staging slots. Packs each device's fold groups
    into uniform per-device fold phases."""
    per_dev: dict[int, list[tuple[int, list[int], bool]]] = {}
    for (d, b), slots in groups.items():
        per_dev.setdefault(d, []).append((b, slots, include_self[(d, b)]))
    depth = max((len(v) for v in per_dev.values()), default=0)
    width = max((len(slots) for _, slots, _ in
                 (g for v in per_dev.values() for g in v)), default=0)
    folds = []
    for f in range(depth):
        blk = np.full(n, -1, dtype=np.int64)
        ops = np.full((n, max(width, 1)), -1, dtype=np.int64)
        self_mask = np.zeros(n, dtype=bool)
        any_active = False
        for d, gl in per_dev.items():
            if f >= len(gl):
                continue
            b, slots, inc = gl[f]
            blk[d] = b
            ops[d, :len(slots)] = slots
            self_mask[d] = inc
            any_active = True
        if any_active:
            folds.append(FoldPhase(blk=blk, ops=ops,
                                   include_self=self_mask))
    return folds


def _movement_step(moves: list[tuple[int, int, int]], n: int) -> ExecStep:
    """Pure data-movement step (reorder rounds): every receive is a plain
    write of the received block."""
    rounds, n_slots, slot_of = _color_rounds(moves, n)
    groups: dict[tuple[int, int], list[int]] = {}
    inc: dict[tuple[int, int], bool] = {}
    for mi, (s, d, b) in enumerate(moves):
        groups[(d, b)] = [slot_of[mi]]
        inc[(d, b)] = False
    return ExecStep(rounds=rounds, n_slots=n_slots,
                    folds=_build_folds(groups, inc, n))


def _movement_step_remap(moves: list[tuple[int, int, int, int]],
                         n: int) -> ExecStep:
    """Movement step whose writes land at a DIFFERENT block row than the
    one sent: `moves` carries (src, dst, src_block, dst_block). The
    AllToAll lowering uses this — src ships its operand chunk for dst
    (blocks in dst's range), and the copy lands in dst's buffer at src's
    row (the split/concat transpose)."""
    rounds, n_slots, slot_of = _color_rounds(
        [(s, d, sb) for s, d, sb, _ in moves], n)
    groups: dict[tuple[int, int], list[int]] = {}
    inc: dict[tuple[int, int], bool] = {}
    for mi, (s, d, _sb, db) in enumerate(moves):
        groups[(d, db)] = [slot_of[mi]]
        inc[(d, db)] = False
    return ExecStep(rounds=rounds, n_slots=n_slots,
                    folds=_build_folds(groups, inc, n))


def _srv_names(mask: int, inv: Mapping[int, int]) -> list[int]:
    return [inv[m] for m in range(mask.bit_length()) if mask >> m & 1]


def _op_blocks(op, si: int, what: str, nb: int,
               unit: float) -> tuple[int, ...]:
    if op.blocks is None:
        raise LoweringError(
            f"step {si}: {what} {op} is not block-annotated")
    want = len(op.blocks) * unit
    if abs(op.size - want) > 1e-6 * max(1.0, abs(want)):
        raise LoweringError(
            f"step {si}: {what} size {op.size} inconsistent with "
            f"{len(op.blocks)} block(s) of {unit} units")
    for b in op.blocks:
        if not 0 <= b < nb:
            raise LoweringError(
                f"step {si}: {what} names block {b} outside "
                f"0..{nb - 1}")
    return op.blocks


# ---------------------------------------------------------------------------
# lower_plan
# ---------------------------------------------------------------------------
def lower_plan(plan: Plan,
               placement: Sequence[int] | Mapping[int, int] | None = None
               ) -> CompiledSchedule:
    """Compile a block-annotated Plan into an executable CompiledSchedule.

    placement maps server id → mesh index; default: the i-th id of
    sorted(plan.ids()) sits at mesh index i. Raises LoweringError on
    unannotated IR, on structural defects (a server contribution folded
    twice, a fan_in that disagrees with the incoming copies, a block never
    fully reduced, an incomplete final gather) and on placement mismatch.
    """
    if plan.num_blocks is None:
        raise LoweringError(
            f"plan {plan.name!r} carries no block annotations "
            "(Plan.num_blocks is None) — rebuild it with a block-aware "
            "builder before lowering")
    with default_tracer().span("lower/lower_plan", plan=plan.name,
                               n=plan.n, blocks=plan.num_blocks):
        return _lower_plan_inner(plan, placement)


def _lower_plan_inner(plan: Plan,
                      placement: Sequence[int] | Mapping[int, int] | None
                      ) -> CompiledSchedule:
    n = plan.n
    ids = plan.ids()
    if placement is None:
        mesh_of = {sid: i for i, sid in enumerate(sorted(ids))}
    elif isinstance(placement, Mapping):
        mesh_of = {int(k): int(v) for k, v in placement.items()}
    else:
        mesh_of = {int(sid): i for i, sid in enumerate(placement)}
    if sorted(mesh_of.get(sid, -1) for sid in ids) != list(range(n)):
        raise LoweringError(
            f"placement must biject the {n} server ids {sorted(ids)} onto "
            f"mesh indices 0..{n - 1}; got {mesh_of}")
    inv = {m: sid for sid, m in mesh_of.items()}

    if plan.family in ("allgather", "all_to_all", "p2p"):
        return _lower_movement_family(plan, mesh_of, inv)
    if plan.family not in ("allreduce", "reduce_scatter"):
        raise LoweringError(f"unknown plan family {plan.family!r}")

    nb = plan.num_blocks
    unit = plan.size / nb
    full = (1 << n) - 1
    # contrib[mesh][block] = bitmask (over mesh indices) of the server
    # contributions currently summed into that device's copy
    contrib = [[1 << m for _ in range(nb)] for m in range(n)]

    def _blocks_of(op, si: int, what: str) -> tuple[int, ...]:
        return _op_blocks(op, si, what, nb, unit)

    exec_steps: list[ExecStep] = []
    last_fold_step = -1
    for si, st in enumerate(plan.steps):
        moves: list[tuple[int, int, int]] = []
        for t in st.transfers:
            if t.src not in mesh_of or t.dst not in mesh_of:
                raise LoweringError(
                    f"step {si}: transfer {t.src}->{t.dst} uses a server "
                    "id missing from the placement map")
            for b in _blocks_of(t, si, "transfer"):
                moves.append((mesh_of[t.src], mesh_of[t.dst], b))
        fans: dict[tuple[int, int], int] = {}
        for r in st.reduces:
            for b in _blocks_of(r, si, "reduce"):
                key = (mesh_of[r.server], b)
                if key in fans:
                    raise LoweringError(
                        f"step {si}: duplicate reduce of block {b} at "
                        f"server {r.server} — a block may fold at most "
                        "once per server per step")
                fans[key] = r.fan_in

        rounds, n_slots, slot_of = _color_rounds(moves, n)
        groups: dict[tuple[int, int], list[int]] = {}
        opmasks: dict[tuple[int, int], list[int]] = {}
        for mi, (s, d, b) in enumerate(moves):
            groups.setdefault((d, b), []).append(slot_of[mi])
            opmasks.setdefault((d, b), []).append(contrib[s][b])

        include_self: dict[tuple[int, int], bool] = {}
        updates: dict[tuple[int, int], int] = {}
        for key, slots in groups.items():
            d, b = key
            fan = fans.pop(key, None)
            got = len(slots)
            if fan is None:
                if got != 1:
                    raise LoweringError(
                        f"step {si}: server {inv[d]} receives {got} "
                        f"copies of block {b} with no reduce — ambiguous "
                        "write")
                include_self[key] = False
                updates[key] = opmasks[key][0]
                continue
            if fan == got:
                inc = False
            elif fan == got + 1:
                inc = True
            else:
                raise LoweringError(
                    f"step {si}: reduce of block {b} at server {inv[d]} "
                    f"declares fan_in={fan} but {got} copies arrive "
                    f"(expected fan_in of {got} or {got + 1})")
            include_self[key] = inc
            acc = contrib[d][b] if inc else 0
            for om, s_slot in zip(opmasks[key], slots):
                if acc & om:
                    dup = _srv_names(acc & om, inv)
                    raise LoweringError(
                        f"step {si}: duplicate block reduce — "
                        f"contribution(s) of server(s) {dup} to block {b} "
                        f"fold twice at server {inv[d]}")
                acc |= om
            updates[key] = acc
        if fans:
            (d, b), fan = next(iter(fans.items()))
            raise LoweringError(
                f"step {si}: reduce of block {b} at server {inv[d]} "
                f"(fan_in={fan}) has no incoming copies")
        for (d, b), mask in updates.items():
            contrib[d][b] = mask
        if st.reduces:
            last_fold_step = si
        exec_steps.append(ExecStep(
            rounds=rounds, n_slots=n_slots,
            folds=_build_folds(groups, include_self, n)))

        if si == last_fold_step:
            rs_contrib = [row[:] for row in contrib]

    # ---- completeness ------------------------------------------------------
    if last_fold_step < 0:
        raise LoweringError(
            f"plan {plan.name!r} contains no reduces — not "
            f"{'an AllReduce' if plan.family == 'allreduce' else 'a ReduceScatter'}")
    if plan.family == "allreduce":
        for m in range(n):
            for b in range(nb):
                if contrib[m][b] != full:
                    missing = _srv_names(full & ~contrib[m][b], inv)
                    raise LoweringError(
                        f"incomplete gather: server {inv[m]} ends without "
                        f"the contribution(s) of server(s) {missing} for "
                        f"block {b}")
    else:
        # reduce_scatter family: the ownership layout is the END state —
        # trailing movement steps (a builder's own reorder) count.
        rs_contrib = [row[:] for row in contrib]

    # ---- ReduceScatter boundary + canonical shard layout -------------------
    owner = np.full(nb, -1, dtype=np.int64)
    for b in range(nb):
        holders = [m for m in range(n) if rs_contrib[m][b] == full]
        if not holders:
            parts = {m: _srv_names(rs_contrib[m][b], inv)
                     for m in range(n) if rs_contrib[m][b]}
            raise LoweringError(
                f"block {b} is never fully reduced by the end of the "
                f"ReduceScatter phase (step {last_fold_step}); partial "
                f"holders: {parts}")
        owner[b] = holders[0]

    blocks_per_shard = nb // n if nb % n == 0 else None
    reorder = unorder = None
    if blocks_per_shard:
        k = blocks_per_shard
        fwd = [(int(owner[b]), b // k, b) for b in range(nb)
               if int(owner[b]) != b // k]
        if fwd:
            reorder = _movement_step(fwd, n)
            unorder = _movement_step([(d, s, b) for s, d, b in fwd], n)

    if plan.family == "reduce_scatter":
        # every step belongs to the RS half; nothing gathers afterwards
        rs_steps, ag_steps = exec_steps, []
    else:
        rs_steps = exec_steps[:last_fold_step + 1]
        ag_steps = exec_steps[last_fold_step + 1:]
    return CompiledSchedule(
        plan_name=plan.name, n=n, num_blocks=nb,
        rs=rs_steps, ag=ag_steps,
        owner_of_block=owner, blocks_per_shard=blocks_per_shard,
        reorder=reorder, unorder=unorder,
        placement=tuple(inv[m] for m in range(n)),
        family=plan.family)


def _lower_movement_family(plan: Plan, mesh_of: Mapping[int, int],
                           inv: Mapping[int, int]) -> CompiledSchedule:
    """Lower a fold-free family (allgather / all_to_all / p2p).

    allgather: each block's initial holder is INFERRED from the steps — a
    server that sends a block before ever receiving it must have started
    with it. Exactly one initial holder per block is required (the
    `all_gather()` entry seeds the canonical shard and `unorder` ships
    each block to that holder, so a second presumed holder would forward
    garbage), and every server must end holding every block.

    all_to_all: every transfer must ship blocks from the sender's operand
    chunk for the destination (block b of src→dst needs dst·k ≤ b <
    (dst+1)·k, k = num_blocks/n); the copy lands at dst row
    src·k + (b − dst·k) — the split-0/concat-0 transpose. Completeness:
    every off-diagonal row received exactly once. Only direct (single-hop)
    plans lower; a hierarchical AllToAll prices fine but fails the chunk
    check here by construction.

    p2p: arbitrary edges, full buffer each; at most one incoming edge per
    receiver per step. The edge list is kept on the schedule
    (`perm_pairs`) for the guard's flat rung."""
    n, nb, family = plan.n, plan.num_blocks, plan.family
    unit = plan.size / nb
    exec_steps: list[ExecStep] = []

    def _expand(st, si):
        moves: list[tuple[int, int, int]] = []
        if st.reduces:
            raise LoweringError(
                f"step {si}: a {family!r}-family plan cannot fold "
                f"(found {len(st.reduces)} reduce op(s))")
        for t in st.transfers:
            if t.src not in mesh_of or t.dst not in mesh_of:
                raise LoweringError(
                    f"step {si}: transfer {t.src}->{t.dst} uses a server "
                    "id missing from the placement map")
            for b in _op_blocks(t, si, "transfer", nb, unit):
                moves.append((mesh_of[t.src], mesh_of[t.dst], b))
        return moves

    if family == "allgather":
        holds = [[False] * nb for _ in range(n)]
        initial = [[False] * nb for _ in range(n)]
        for si, st in enumerate(plan.steps):
            moves = _expand(st, si)
            seen_writes: set[tuple[int, int]] = set()
            for s, d, b in moves:
                if not holds[s][b]:
                    for m in range(n):
                        if initial[m][b]:
                            raise LoweringError(
                                f"step {si}: block {b} would need to start "
                                f"at both server {inv[m]} and server "
                                f"{inv[s]} — ambiguous initial holder")
                    holds[s][b] = True
                    initial[s][b] = True
                if (d, b) in seen_writes:
                    raise LoweringError(
                        f"step {si}: server {inv[d]} receives block {b} "
                        "twice — ambiguous write")
                seen_writes.add((d, b))
            exec_steps.append(_movement_step(moves, n))
            for _s, d, b in moves:
                holds[d][b] = True
        owner = np.full(nb, -1, dtype=np.int64)
        for b in range(nb):
            src = [m for m in range(n) if initial[m][b]]
            if not src:
                if n == 1:
                    owner[b] = 0
                    continue
                raise LoweringError(
                    f"block {b} is never transferred — no initial holder "
                    "to gather it from")
            owner[b] = src[0]
            for m in range(n):
                if not holds[m][b]:
                    raise LoweringError(
                        f"incomplete gather: server {inv[m]} ends without "
                        f"block {b}")
        blocks_per_shard = nb // n if nb % n == 0 else None
        reorder = unorder = None
        if blocks_per_shard:
            k = blocks_per_shard
            fwd = [(int(owner[b]), b // k, b) for b in range(nb)
                   if int(owner[b]) != b // k]
            if fwd:
                reorder = _movement_step(fwd, n)
                unorder = _movement_step([(d, s, b) for s, d, b in fwd], n)
        return CompiledSchedule(
            plan_name=plan.name, n=n, num_blocks=nb, rs=[], ag=exec_steps,
            owner_of_block=owner, blocks_per_shard=blocks_per_shard,
            reorder=reorder, unorder=unorder,
            placement=tuple(inv[m] for m in range(n)), family=family)

    if family == "all_to_all":
        if nb % n:
            raise LoweringError(
                f"all_to_all plan {plan.name!r} needs num_blocks ({nb}) "
                f"divisible by n ({n})")
        k = nb // n
        received: set[tuple[int, int]] = set()
        for si, st in enumerate(plan.steps):
            moves4: list[tuple[int, int, int, int]] = []
            for s, d, b in _expand(st, si):
                if not d * k <= b < (d + 1) * k:
                    raise LoweringError(
                        f"step {si}: transfer {inv[s]}->{inv[d]} ships "
                        f"block {b} outside the destination chunk "
                        f"[{d * k}, {(d + 1) * k}) — only direct "
                        "(single-hop) all_to_all plans lower")
                row = s * k + (b - d * k)
                if (d, row) in received:
                    raise LoweringError(
                        f"step {si}: server {inv[d]} receives output row "
                        f"{row} twice — ambiguous write")
                received.add((d, row))
                moves4.append((s, d, b, row))
            exec_steps.append(_movement_step_remap(moves4, n))
        for d in range(n):
            for s in range(n):
                if s == d:
                    continue    # diagonal chunk never hits the wire
                for j in range(k):
                    if (d, s * k + j) not in received:
                        raise LoweringError(
                            f"incomplete all_to_all: server {inv[d]} never "
                            f"receives row {s * k + j} (chunk of server "
                            f"{inv[s]})")
        return CompiledSchedule(
            plan_name=plan.name, n=n, num_blocks=nb, rs=[], ag=exec_steps,
            owner_of_block=np.arange(nb, dtype=np.int64) // k,
            blocks_per_shard=None, reorder=None, unorder=None,
            placement=tuple(inv[m] for m in range(n)), family=family)

    # p2p
    pairs: list[tuple[int, int]] = []
    for si, st in enumerate(plan.steps):
        moves = _expand(st, si)
        dsts: set[int] = set()
        for s, d, _b in moves:
            if d in dsts:
                raise LoweringError(
                    f"step {si}: server {inv[d]} receives two p2p "
                    "payloads — ambiguous write")
            dsts.add(d)
            pairs.append((s, d))
        exec_steps.append(_movement_step(moves, n))
    return CompiledSchedule(
        plan_name=plan.name, n=n, num_blocks=nb, rs=[], ag=exec_steps,
        owner_of_block=np.zeros(nb, dtype=np.int64),
        blocks_per_shard=None, reorder=None, unorder=None,
        placement=tuple(inv[m] for m in range(n)), family=family,
        perm_pairs=tuple(pairs))


# ---------------------------------------------------------------------------
# Guarded execution (DESIGN.md §12)
# ---------------------------------------------------------------------------
class GuardedSchedule:
    """Launch guard around a CompiledSchedule, for its local-mesh entry
    points (`run_local`, `run_local_reduce_scatter`,
    `run_local_all_gather`, `run_local_all_to_all`, `run_local_p2p`).

    The guard counts launches (`stats`, `guarded_launches_total`). A
    failed launch is recorded (`stats["failures"]`,
    `guarded_failures_total`, a `guard/failure` trace instant and a
    telemetry re-measure window) and raised. Unlike the reference
    package's ladder it never gives way to a flat sum or to the
    full-precision schedule: either would answer correctly while a kernel
    that failed to build or launch went unseen. So `demotions`, which
    callers assert on, is always 0.

    Everything not guarded (describe, plan_name, …) delegates to the
    wrapped schedule.
    """

    demotions = 0

    def __init__(self, schedule, *, telemetry=None):
        self.inner = schedule
        self.telemetry = telemetry
        self.stats = {"launches": 0, "failures": 0}

    def __getattr__(self, name):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def _note_failure(self, what: str, err: BaseException) -> None:
        from repro_torch.runtime.metrics import default_metrics
        from repro_torch.runtime.telemetry import peek_default_telemetry

        self.stats["failures"] += 1
        default_metrics().counter(
            "guarded_failures_total",
            "guarded launches that raised").inc()
        info = {"plan": self.inner.plan_name, "what": what,
                "error": repr(err)}
        default_tracer().instant("guard/failure", **info)
        tele = self.telemetry
        if tele is None:
            tele = peek_default_telemetry()
        if tele is not None:
            tele.remeasure("guard_failure", info)

    def _guarded(self, what: str, X: torch.Tensor, **kw) -> torch.Tensor:
        from repro_torch.runtime.metrics import default_metrics

        self.stats["launches"] += 1
        default_metrics().counter(
            "guarded_launches_total",
            "collective launches through the schedule guard").inc()
        try:
            return getattr(self.inner, what)(X, **kw)
        except Exception as e:
            self._note_failure(what, e)
            raise

    def run_local(self, X: torch.Tensor) -> torch.Tensor:
        return self._guarded("run_local", X)

    def run_local_reduce_scatter(self, X: torch.Tensor, *,
                                 overwrite: bool = False) -> torch.Tensor:
        return self._guarded("run_local_reduce_scatter", X,
                             overwrite=overwrite)

    def run_local_all_gather(self, S: torch.Tensor) -> torch.Tensor:
        return self._guarded("run_local_all_gather", S)

    def run_local_all_to_all(self, X: torch.Tensor) -> torch.Tensor:
        return self._guarded("run_local_all_to_all", X)

    def run_local_p2p(self, X: torch.Tensor) -> torch.Tensor:
        return self._guarded("run_local_p2p", X)


def guard_schedule(schedule, *, telemetry=None):
    """Memoized GuardedSchedule for `schedule`: repeated calls return the
    SAME wrapper, so guard stats survive across launches instead of being
    reset by every re-wrap. Idempotent on an already-guarded schedule."""
    if schedule is None or isinstance(schedule, GuardedSchedule):
        return schedule
    g = getattr(schedule, "_guard_wrapper", None)
    if g is None:
        g = GuardedSchedule(schedule, telemetry=telemetry)
        try:
            schedule._guard_wrapper = g
        except (AttributeError, TypeError):
            pass                      # unwritable object: unmemoized wrap
    return g
