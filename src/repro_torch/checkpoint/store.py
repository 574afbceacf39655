"""Checkpoints of trees of tensors: atomic, async, step-tagged, resumable,
checksummed.

The reference package's `checkpoint/store.py` over torch tensors, in its
on-disk layout, so that either package reads the other's checkpoints:

    <dir>/step_<k:08d>/arrays.npz      leaf_0, leaf_1, ... (numpy .npz)
                      /tree.json       n_leaves, dtypes, shapes, treedef
                      /checksums.json  {"crc32": {file: CRC32}}
    <dir>/LATEST                       "step_<k:08d>", written last

A tree is nested dicts, lists and tuples whose leaves are tensors (numpy
arrays and Python numbers are taken too). Its leaves are visited as
`jax.tree` visits them: dict keys sorted, depth first, lists and tuples
by index, None holding no leaf. So the trainer's state `{"params": [...],
"opt": {"m": [...], "step": t, "v": [...]}}` lists its leaves in the
order of the reference's ZeRO-3 state. Numpy cannot store bf16 or fp8:
such a leaf is stored as the unsigned integer view of its bits and
tree.json records its dtype by the reference's name ("bfloat16",
"float8_e4m3fn", ...). `treedef` holds the port's structure string
(`tree_flatten`), written as jax writes its treedef for nested dicts,
lists and tuples; neither package reads it back.

A save is written into `.tmp_step_<k>`, checksummed, renamed into place
with `os.replace`, and only then named by LATEST, so a crash mid-save
never leaves a torn restore point.

`CheckpointManager.save` copies the tree to the host before it returns,
so the caller may go on to change the tree's tensors in place (the
trainer's step does); a writer thread then writes that copy and never
reads device memory. A load copies each leaf into the matching tensor
of the tree it restores into, so a restore needs no second copy of the
state on the device. It checks each leaf's shape against that tree and
raises `ValueError` on a mismatch: a checkpoint of an 8-rank local mesh
is not silently loaded into a 4-rank trainer (the reference checks the
leaf count only).

On a process mesh (`CheckpointManager(mesh=)`, one process a rank) a
step is one directory of one member a rank, each in the layout above:

    <dir>/step_<k:08d>/rank_<r:05d>/arrays.npz, tree.json, checksums.json

Each rank writes its own shards and AdamW state (the local mesh's row of
that rank, byte for byte) into `.tmp_step_<k>/rank_<r>`; once every
rank's write and CRC have landed (a barrier through the mesh's
transport), rank 0 renames the step into place, writes LATEST and
collects the old steps, and a second barrier lets every rank go on. A
restore takes the newest step whose member every rank verifies (the
ranks gather their lists of intact steps), so all restore the same one.
Re-sharding a checkpoint onto another rank count is not done (nor by
the reference's manual engine).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

Tree = Any

_NP_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
            "int8", "uint64", "uint32", "uint16", "uint8", "bool"}
# torch dtypes numpy cannot hold: stored as the bits' unsigned view
_RAW_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}

CHECKSUM_FILE = "checksums.json"
_PAYLOAD_FILES = ("arrays.npz", "tree.json")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def tree_flatten(tree: Tree) -> tuple[list, str]:
    """(leaves in jax's tree order, the structure as a string in the form
    of jax's treedef: "*" a leaf, dicts with their sorted keys, lists in
    brackets, tuples in parentheses)."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return f"({inner}{',' if len(node) == 1 else ''})"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like: Tree, leaves) -> Tree:
    """`like`'s structure with `leaves` in place of its own, taken in
    `tree_flatten`'s order (dict keys keep `like`'s order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A host copy of leaf `x` as numpy can store it: the unsigned view of
    its bits for a dtype numpy lacks (the reference's `_to_storable`)."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    t = x.detach()
    if _dtype_name(t) in _NP_SAFE:
        return t.to("cpu", copy=True).numpy()
    as_int, as_np = _RAW_BITS[t.element_size()]
    return t.view(as_int).to("cpu", copy=True).numpy().view(as_np)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The CPU tensor of stored array `a`, whose true dtype is `dtype`."""
    if dtype in _NP_SAFE:
        return torch.from_numpy(np.asarray(a, dtype=dtype))
    as_int, as_np = _RAW_BITS[a.dtype.itemsize]
    return torch.from_numpy(a.view(as_np).view(
        np.dtype(str(as_int).removeprefix("torch.")))).view(
            getattr(torch, dtype))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


class LeafMismatch(ValueError):
    """A checkpoint's leaves do not fit the tree restored into (count or
    shape). Not corruption: restore raises it rather than trying an older
    checkpoint."""


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------
def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def write_checksums(path: str) -> None:
    """Record per-file CRC32s for a saved checkpoint dir (written before
    the atomic rename, so a complete dir always carries its manifest)."""
    sums = {name: _file_crc(os.path.join(path, name))
            for name in _PAYLOAD_FILES
            if os.path.exists(os.path.join(path, name))}
    with open(os.path.join(path, CHECKSUM_FILE), "w") as f:
        json.dump({"crc32": sums}, f)


def verify_checksums(path: str) -> bool:
    """True when the dir's payload files match their recorded CRC32s.
    A checkpoint without a manifest passes when its payload files exist:
    `load_pytree` remains the final arbiter (DESIGN.md §12)."""
    manifest = os.path.join(path, CHECKSUM_FILE)
    if not os.path.exists(manifest):
        return all(os.path.exists(os.path.join(path, n))
                   for n in _PAYLOAD_FILES)
    try:
        with open(manifest) as f:
            sums = json.load(f)["crc32"]
        return all(_file_crc(os.path.join(path, name)) == int(want)
                   for name, want in sums.items())
    except (OSError, ValueError, KeyError, TypeError):
        return False


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
class HostTree:
    """A tree copied to the host now (synchronous): its stored arrays,
    true dtype names and structure string."""

    def __init__(self, tree: Tree):
        leaves, self.treedef = tree_flatten(tree)
        self.dtypes = [_dtype_name(x) for x in leaves]
        self.arrays = [_to_host(x) for x in leaves]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays)


def save_pytree(tree: Tree | HostTree, path: str) -> dict:
    """Write `tree` (or its snapshot) into `path`: arrays.npz, tree.json,
    checksums.json. Returns {"bytes", "seconds"} of the writing, the
    CRC pass included."""
    host = tree if isinstance(tree, HostTree) else HostTree(tree)
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host.arrays)})
    meta = {
        "treedef": host.treedef,
        "n_leaves": len(host.arrays),
        "dtypes": host.dtypes,
        "shapes": [list(a.shape) for a in host.arrays],
    }
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(meta, f)
    write_checksums(path)
    return {"bytes": sum(os.path.getsize(os.path.join(path, n))
                         for n in _PAYLOAD_FILES),
            "seconds": time.perf_counter() - t0}


def load_pytree(path: str, like: Tree, *,
                stats: dict | None = None) -> Tree:
    """Restore into `like`: each tensor leaf of `like` is overwritten in
    place (its dtype and device kept) and the returned tree holds those
    tensors; other leaves are built anew in `like`'s leaf type. Each
    stored leaf must have its `like` leaf's shape (ValueError otherwise,
    and when the leaf counts differ). `stats`, when given, receives the
    bytes read and the seconds spent reading and copying to the device."""
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    like_leaves, _ = tree_flatten(like)
    if len(meta["shapes"]) != len(like_leaves):
        raise LeafMismatch(f"checkpoint has {len(meta['shapes'])} leaves, "
                           f"expected {len(like_leaves)}")
    for i, (shape, want) in enumerate(zip(meta["shapes"], like_leaves)):
        if tuple(shape) != _shape(want):
            raise LeafMismatch(
                f"{path}: leaf {i} has shape {tuple(shape)}, the tree "
                f"restored into has {_shape(want)}")
    read_s = copy_s = 0.0
    nbytes = 0
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        if len(z.files) != len(like_leaves):
            raise ValueError(f"{path}: arrays.npz has {len(z.files)} "
                             f"leaves, tree.json {len(like_leaves)}")
        for i, (dt, want) in enumerate(zip(meta["dtypes"], like_leaves)):
            t0 = time.perf_counter()
            a = z[f"leaf_{i}"]
            t1 = time.perf_counter()
            if tuple(a.shape) != _shape(want):
                raise ValueError(f"{path}: leaf {i} has shape "
                                 f"{tuple(a.shape)}, tree.json "
                                 f"{_shape(want)}")
            t = _from_host(a, dt)
            if isinstance(want, torch.Tensor):
                leaf = want.copy_(t)
                if leaf.device.type == "cuda":
                    torch.cuda.synchronize(leaf.device)
            elif isinstance(want, np.ndarray | np.generic):
                leaf = (t.float() if dt not in _NP_SAFE else t).numpy() \
                    .astype(np.asarray(want).dtype)
            else:
                leaf = type(want)(t.item())
            nbytes += a.nbytes
            read_s += t1 - t0
            copy_s += time.perf_counter() - t1
            out.append(leaf)
    if stats is not None:
        stats.update(bytes=nbytes, read_s=read_s, copy_s=copy_s)
    return tree_unflatten(like, out)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Step-tagged checkpoints under `directory`, the newest `keep` kept.

    With `async_save` a save waits for the previous one to land, copies
    the tree to the host and returns; one writer thread writes it (`wait`
    joins it, and raises what it raised).
    `last_save` / `last_restore` hold the bytes and seconds of the latest
    save (host snapshot, then writing with its CRC) and restore (checksum
    pass, read, copy to the device)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True, mesh=None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        # a process mesh: this process writes its rank's member of each
        # step, and `wait` commits a written step with the other ranks
        self.mesh = mesh
        self._pending: int | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_save: dict = {}
        self.last_restore: dict = {}
        os.makedirs(directory, exist_ok=True)

    def _member(self, step: int, root: str | None = None) -> str:
        """The directory of step `step` this process reads and writes:
        the step's, or on a process mesh this rank's member of it."""
        path = os.path.join(self.dir, root or f"step_{step:08d}")
        if self.mesh is None:
            return path
        return os.path.join(path, f"rank_{self.mesh.rank:05d}")

    def arrays_path(self, step: int) -> str:
        """This process's arrays.npz of step `step`."""
        return os.path.join(self._member(step), "arrays.npz")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree) -> None:
        from repro_torch.runtime.trace import default_tracer
        # at most one in-flight save, and one host copy of the tree
        self.wait()
        t0 = time.perf_counter()
        with default_tracer().span("ckpt/snapshot", step=step):
            host = HostTree(tree)
        self.last_save = {"step": step, "bytes": host.nbytes,
                          "snapshot_s": time.perf_counter() - t0}
        if self.mesh is not None:
            self._pending = step
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
            if self.mesh is not None:
                self.wait()            # commits it with the other ranks

    def _write_caught(self, step: int, host: HostTree) -> None:
        try:
            self._write(step, host)
        except BaseException as e:      # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, host: HostTree) -> None:
        from repro_torch.runtime.trace import default_tracer
        tag = f"step_{step:08d}"
        tmp = self._member(step, f".tmp_{tag}")
        final = os.path.join(self.dir, tag)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        with default_tracer().span("ckpt/write", step=step):
            written = save_pytree(host, tmp)
        if self.mesh is not None:
            # the other ranks' members land too before `wait` commits
            self.last_save.update(file_bytes=written["bytes"],
                                  write_s=written["seconds"])
            return
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # LATEST last: readers never see a partial checkpoint
        latest = os.path.join(self.dir, "LATEST")
        with open(latest + ".tmp", "w") as f:
            f.write(tag)
        os.replace(latest + ".tmp", latest)
        self.last_save.update(file_bytes=written["bytes"],
                              write_s=written["seconds"])
        self._gc()

    def wait(self) -> None:
        """Join the in-flight writer; raise the error it stopped on. On a
        process mesh every rank calls it at the same points (it is a
        collective): a step written since the last call is committed
        here, once every rank's member has landed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._pending is not None:
            step, self._pending = self._pending, None
            try:
                self._commit(step, err is None)
            except RuntimeError as e:
                raise e from err
        if err is not None:
            raise RuntimeError("checkpoint write failed") from err

    def _gather(self, row: list[int]) -> list[list[int]]:
        """Every rank's `row` (int64, one length on every rank) through
        the mesh's transport, in rank order."""
        from repro_torch.core.transport import all_gather_rows
        pm = self.mesh
        got = all_gather_rows(pm, pm.line(pm.axis_names), torch.tensor(
            row, dtype=torch.int64, device=pm.device))
        return got.cpu().tolist()

    def _commit(self, step: int, ok: bool) -> None:
        """Rank 0 renames step `step` into place, names it in LATEST and
        collects the old steps once every rank's member has landed; a
        second barrier holds every rank until it has."""
        from repro_torch.runtime.trace import default_tracer
        t0 = time.perf_counter()
        with default_tracer().span("ckpt/commit", step=step):
            oks = [r[0] for r in self._gather([int(ok)])]
            if not all(oks):
                raise RuntimeError(
                    f"checkpoint step {step}: the write failed on rank(s) "
                    f"{[r for r, v in enumerate(oks) if not v]}")
            if self.mesh.rank == 0:
                tag = f"step_{step:08d}"
                tmp = os.path.join(self.dir, f".tmp_{tag}")
                members = {f"rank_{r:05d}" for r in range(self.mesh.size)}
                for d in set(os.listdir(tmp)) - members:
                    shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
                final = os.path.join(self.dir, tag)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                latest = os.path.join(self.dir, "LATEST")
                with open(latest + ".tmp", "w") as f:
                    f.write(tag)
                os.replace(latest + ".tmp", latest)
                self._gc()
            self._gather([step])
        self.last_save["commit_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            tag = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, tag)):
            return None
        return int(tag.split("_")[1])

    def available_steps(self) -> list[int]:
        """Complete checkpoint steps on disk, newest first."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        steps = []
        for d in names:
            if d.startswith("step_"):
                try:
                    steps.append(int(d.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps, reverse=True)

    def verify(self, step: int) -> bool:
        """Checksum-verify one checkpoint dir (see `verify_checksums`);
        on a process mesh this rank's member of it."""
        return verify_checksums(self._member(step))

    def _load(self, path: str, like: Tree, step: int) -> Tree:
        stats: dict = {}
        out = load_pytree(path, like, stats=stats)
        self.last_restore.update(step=step, **stats)
        return out

    def restore(self, like: Tree, step: int | None = None
                ) -> tuple[Tree, int]:
        """Restore the requested (or newest intact) checkpoint into `like`
        (`load_pytree`: its tensors are overwritten in place), after the
        in-flight save has landed.

        An explicit `step` is authoritative: corruption there raises.
        Without one, candidates are tried newest-first; a checkpoint
        failing its checksum manifest or its actual load falls back to
        the previous step (counted in `ckpt_restore_fallbacks_total`) —
        a torn/bit-flipped latest save costs `ckpt_every` steps of
        replay, not the job (DESIGN.md §12)."""
        from repro_torch.runtime.metrics import default_metrics
        from repro_torch.runtime.trace import default_tracer
        self.wait()
        if step is not None:
            self.last_restore = {}
            return self._load(self._member(step), like, step), step
        if self.mesh is not None:
            return self._restore_agreed(like)
        candidates = self.available_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        errors = []
        for cand in candidates:
            path = os.path.join(self.dir, f"step_{cand:08d}")
            t0 = time.perf_counter()
            try:
                with default_tracer().span("ckpt/restore", step=cand):
                    if not verify_checksums(path):
                        raise ValueError(f"checksum mismatch in {path}")
                    self.last_restore = {
                        "verify_s": time.perf_counter() - t0}
                    return self._load(path, like, cand), cand
            except LeafMismatch:
                raise
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, zlib.error) as e:
                # corrupt or unreadable: try the next older one
                errors.append((cand, repr(e)))
                default_metrics().counter(
                    "ckpt_restore_fallbacks_total",
                    "corrupt checkpoints skipped during restore").inc()
        raise FileNotFoundError(
            f"no intact checkpoint in {self.dir}; tried {errors}")

    # the most steps a rank reports intact to the others
    AGREE_STEPS = 64

    def _restore_agreed(self, like: Tree) -> tuple[Tree, int]:
        """`restore` on a process mesh: every rank checksums its member of
        each step on disk, the ranks gather their lists of intact steps,
        and all load the newest step in every list; a step whose load
        fails on any rank is dropped on every rank and the next one
        tried. A leaf mismatch on any rank raises `LeafMismatch` on
        every rank."""
        from repro_torch.runtime.metrics import default_metrics
        from repro_torch.runtime.trace import default_tracer
        t0 = time.perf_counter()
        candidates = self.available_steps()[:self.AGREE_STEPS]
        mine = [c for c in candidates if verify_checksums(self._member(c))]
        rows = self._gather(mine + [-1] * (self.AGREE_STEPS - len(mine)))
        agreed = sorted(set.intersection(*(set(r) - {-1} for r in rows)),
                        reverse=True)
        skipped = sorted(set(candidates) - set(agreed), reverse=True)
        for _ in skipped:
            default_metrics().counter(
                "ckpt_restore_fallbacks_total",
                "corrupt checkpoints skipped during restore").inc()
        errors = [(c, "a rank's member fails its checksum") for c in skipped]
        verify_s = time.perf_counter() - t0
        for cand in agreed:
            code, out, err = 0, None, None
            try:
                with default_tracer().span("ckpt/restore", step=cand):
                    self.last_restore = {"verify_s": verify_s}
                    out = self._load(self._member(cand), like, cand)
            except LeafMismatch as e:
                code, err = 2, e
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, zlib.error) as e:
                code, err = 1, e
            codes = [r[0] for r in self._gather([code])]
            if 2 in codes:
                if err is not None and code == 2:
                    raise err
                raise LeafMismatch(f"step {cand}: rank(s) "
                                   f"{[r for r, c in enumerate(codes) if c == 2]}"
                                   " hold other leaf shapes")
            if not any(codes):
                return out, cand
            errors.append((cand, repr(err) if err is not None else
                           f"the load failed on rank(s) "
                           f"{[r for r, c in enumerate(codes) if c]}"))
            default_metrics().counter(
                "ckpt_restore_fallbacks_total",
                "corrupt checkpoints skipped during restore").inc()
        raise FileNotFoundError(
            f"no step in {self.dir} intact on every rank; tried {errors}")
