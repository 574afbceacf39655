"""Process meshes: one process a rank over `torch.distributed`.

The counterpart of the reference's `launch/mesh.py` and of the device
mesh its `shard_map` programs run on. A `ProcessMesh` names the mesh
axes in the reference's order (e.g. `(("pod", 2), ("data", 4))`), and
each process is one rank of it: its rank is the row-major index of its
coordinates. For every set of axes (one axis, or several, such as all of
them for a `psum` over the whole mesh) each line of the mesh, the ranks
that differ only in those axes, is one `torch.distributed` group; every
process creates every group in the same order, as `new_group` requires.

`launch(fn, axes, ...)` spawns the processes (the `spawn` start method:
CUDA does not survive `fork`), meets them in a `FileStore` in a fresh
temporary directory (no TCP port, so parallel test workers cannot
collide), runs `fn(mesh, *args)` in each, and returns their results in
rank order. It joins with a deadline and kills every process that is
left when the deadline passes.

The ranks' process groups, the `ProcessMesh` each process gets and the
transport that moves a round's bytes between them are `core.transport`'s;
this module builds the mesh and starts its processes. The backend is the
caller's: "nccl" runs one card a rank, and two ranks on one card raise
`SharedDeviceError` before NCCL would; "gloo" runs every rank on the CPU
or on one card, its rounds staged through the host.

Importing this module starts no process group.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
from itertools import combinations, product
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.transport import Line, ProcessMesh

BACKENDS = ("nccl", "gloo")


class SharedDeviceError(RuntimeError):
    """NCCL asked to run two ranks on one device."""


def _axes(axes) -> tuple[tuple[str, int], ...]:
    out = tuple((str(a), int(s)) for a, s in axes)
    if not out or any(s < 1 for _, s in out) \
            or len({a for a, _ in out}) != len(out):
        raise ValueError(f"a mesh is distinct (axis, size) pairs of sizes "
                         f">= 1; got {axes!r}")
    return out


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a `ProcessMesh` or of (axis, size) pairs."""
    pairs = mesh.axes if isinstance(mesh, ProcessMesh) else _axes(mesh)
    return dict(pairs)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def make_production_mesh(multi_pod: bool = False
                         ) -> tuple[tuple[str, int], ...]:
    """The axes of the reference's production mesh: 16 × 16 as ("data",
    "model"), or 2 × 16 × 16 as ("pod", "data", "model")."""
    if multi_pod:
        return (("pod", 2), ("data", 16), ("model", 16))
    return (("data", 16), ("model", 16))


def make_host_mesh(data: int = 1, model: int = 1
                   ) -> tuple[tuple[str, int], ...]:
    """The axes of a small (data, model) mesh, as the reference's
    `make_host_mesh` names them; `launch(fn, make_host_mesh(4))` runs it
    with one process a rank."""
    return (("data", int(data)), ("model", int(model)))


def rank_devices(world: int, backend: str, device) -> list[torch.device]:
    """Each rank's device: the CPU, or under "gloo" the one card named
    (every rank on it), under "nccl" card r of the visible ones. NCCL
    with fewer cards than ranks, or with one named card for several
    ranks, raises `SharedDeviceError`."""
    dev = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "gloo" or world == 1:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return [dev] * world
    if dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices; got "
                         f"{dev}")
    cards = torch.cuda.device_count()
    if dev.index is not None or cards < world:
        where = (f"the one card {dev}" if dev.index is not None
                 else f"{cards} card(s)")
        raise SharedDeviceError(
            f"nccl needs one card a rank: {world} ranks on {where} would "
            f"put two ranks on one device, which NCCL refuses; pass "
            f"--backend gloo (backend='gloo') to run them on one card "
            f"through the host")
    return [torch.device("cuda", r) for r in range(world)]


def coords_of(rank: int, sizes: Sequence[int]) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def init_process_mesh(axes, backend: str, device) -> ProcessMesh:
    """This process's `ProcessMesh` over an initialized default process
    group of `prod(sizes)` ranks: creates every line of every set of
    axes, all processes in the same order. Under NCCL each group runs
    one small all-reduce at once, so that its first point-to-point
    batch need not include every rank."""
    axes = _axes(axes)
    sizes = [s for _, s in axes]
    world = math.prod(sizes)
    if dist.get_world_size() != world:
        raise ValueError(f"a mesh of {world} ranks {list(axes)} over a "
                         f"process group of {dist.get_world_size()}")
    rank = dist.get_rank()
    coords = coords_of(rank, sizes)
    names = [a for a, _ in axes]
    lines = {}
    for k in range(1, len(axes) + 1):
        for dims in combinations(range(len(axes)), k):
            rest = [d for d in range(len(axes)) if d not in dims]
            for fixed in product(*(range(sizes[d]) for d in rest)):
                ranks = [r for r in range(world)
                         if all(coords_of(r, sizes)[d] == f
                                for d, f in zip(rest, fixed))]
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if rank in ranks:
                    lines[tuple(names[d] for d in dims)] = Line(
                        group, tuple(ranks), ranks.index(rank))
    pm = ProcessMesh(axes=axes, rank=rank, coords=coords, backend=backend,
                     device=torch.device(device), lines=lines)
    if backend == "nccl":
        for key in sorted(lines, key=lambda k: (len(k), k)):
            dist.all_reduce(torch.zeros(1, device=pm.device),
                            group=lines[key].group)
        torch.cuda.synchronize(pm.device)
    return pm


def device_mesh(pm: ProcessMesh):
    """The `torch.distributed` `DeviceMesh` of a `ProcessMesh`: its axes as
    the mesh dimensions, same names, same order, on the mesh's device
    type, over the process groups `init_process_mesh` created (this
    rank's line of each axis). It creates no group, so every process
    may build it at any point."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = [s for _, s in pm.axes]
    return DeviceMesh.from_group(
        [pm.line(a).group for a in pm.axis_names], pm.device.type,
        mesh=torch.arange(pm.size).reshape(sizes),
        mesh_dim_names=pm.axis_names)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _child(fn, args, axes, rank, backend, device, store_path, timeout_s,
           threads, pythonpath, results) -> None:
    os.environ["PYTHONPATH"] = pythonpath
    try:
        if threads:
            torch.set_num_threads(int(threads))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        world = math.prod(s for _, s in axes)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            pm = init_process_mesh(axes, backend, dev)
            out = fn(pm, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, not by the queue: torch's queue reductions would
        # pass tensors through shared memory that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, axes, *, backend: str = "nccl",
           device="cuda", timeout_s: float = 600.0, args: tuple = (),
           threads: int | None = None) -> list:
    """Run `fn(mesh, *args)` in one process a rank of the mesh `axes`
    ((axis, size) pairs, or an int n: ("data", n)) and return the
    results in rank order. `fn` is a module-level function and its
    results are picklable CPU objects.

    `backend` "nccl" (one card a rank: `rank_devices`) or "gloo" (every
    rank on `device`, the CPU or one card, its CUDA payloads staged
    through the host). Each process sets `threads` torch threads when
    given, has the port's source directory lead its PYTHONPATH, and
    initializes its process group from a `FileStore` in a fresh
    temporary directory with `timeout_s` as the group's timeout. A rank that raises fails the launch with its
    traceback; when `timeout_s` passes, every process left is killed and
    TimeoutError is raised."""
    import multiprocessing as mp

    axes = _axes([("data", int(axes))] if isinstance(axes, int) else axes)
    world = math.prod(s for _, s in axes)
    devices = rank_devices(world, backend, device)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pythonpath = os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    results = ctx.Queue()
    procs = []
    deadline = time.monotonic() + float(timeout_s)
    try:
        for r in range(world):
            p = ctx.Process(target=_child, daemon=True, args=(
                fn, tuple(args), axes, r, backend, str(devices[r]),
                os.path.join(tmp, "store"), float(timeout_s), threads,
                pythonpath, results))
            p.start()
            procs.append(p)
        got: dict[int, object] = {}
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"a mesh of {world} processes {list(axes)} did not "
                    f"finish within {timeout_s} s (ranks done: "
                    f"{sorted(got)})")
            try:
                r, ok, out = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} before its result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{out}")
            got[r] = pickle.loads(out)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
