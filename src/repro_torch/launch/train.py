"""Training entry point: the auto engine and the manual ZeRO-3 engine.

Two engines, as the reference's:

* **auto** (the default; `make_train_step`): the baseline. On one device
  the plain step; over a process mesh (`--nproc N`) every parameter and
  AdamW moment is a DTensor at the reference's FSDP × TP placements
  (`launch/sharding.py`; ZeRO-1 with `fsdp=False`), and the all-gathers,
  reduce-scatters and all-reduces a change of placement needs are
  torch.distributed's own, as XLA SPMD inserts them in the reference. It
  never calls the planner, GenTree or `core.lower`. On a "model" axis
  above 1 each rank multiplies its slice of every weight the axis
  shards (tensor parallelism, the Megatron operators of
  `core.transport` over its model line).
* **manual**: GenTree's plans as the step's collectives, below.

The reference's manual engine (`launch/train.py`) shards every parameter
leaf over the data-parallel ranks (ZeRO-3: flat per-rank shards),
gathers them with a planned AllGather and reduces the gradients with a
planned ReduceScatter: GenTree's plan, lowered by `core.lower` and run
round for round, as the collective of a training step, one plan per
level of the data-parallel mesh. Here the ranks are the rows of tensors
on one device (the local mesh of `core.collectives`, whose leading
dimensions are the mesh axes), as the decode AllReduce of
`launch.serve` is, and each fold phase of a schedule is one
`fused_reduce_into` launch on a card.

Scope: the reference's manual engine over the data-parallel axes of a
local mesh, one axis (`("data", n)`) or several (e.g. `[("pod", 2),
("data", 4)]`, the paper's hierarchical structure), for the dense, MoE,
RWKV6 and hybrid families (MoE with the reference's expert-parallel
dispatch over the first live axis, its exchange the planned all-to-all
under "plan"; the recurrent families through their differentiable torch
recurrences, `models.recurrence`; the vlm family on its embeddings and
M-RoPE streams; the encoder-decoder), with every `SyncConfig` strategy of
the reference: "plan" bucketed by default on one axis (GenModel picks
the bucket, `core.bucketing`), per leaf with `bucket_bytes=0` or on
several axes; the flat labels psum, ring, rhd, cps and hcps, "gentree"
(the planner's label for each axis) and "auto" (psum) per leaf, through
`core.collectives`; a wire the plan binds (bf16, fp8, int8). These raise
`NotImplementedError` and are never replaced by another path:
`compress` in the trainer (item 9); on the local mesh, the schedule
probe `observe_sync_probe`.

The same step runs with one process a rank on a process mesh
(`core.transport.ProcessMesh`; `make_manual_train_step(api, mesh)` with
such a mesh, `run_training(tc, mesh=...)`, or the CLI's `--nproc N
--backend nccl|gloo`): each process holds its own shards and AdamW
state and runs its own rank, the collectives go over its process
groups, and its losses, gnorms and shards equal the local mesh's row
of that rank bit for bit. There `observe_sync_probe` times each axis's
schedule and feeds the planner; expert-parallel MoE exchanges over the
EP axis's process group; each rank writes its own member of every
checkpoint, and the fault loop restores the step every rank verifies.

With a checkpoint directory the run goes through the reference's
`FaultTolerantLoop` (`runtime.ft`): a checkpoint every `ckpt_every`
steps, and on a failed step (an injected device loss, a guarded launch
that failed) a restore of the newest intact checkpoint and a replay; a
run resumes from the directory's newest checkpoint. A fault plan
(`runtime.faults`) injects device losses, link sags, delays, corrupted
checkpoints and corrupted collective payloads.

    python -m repro_torch.launch.train --smoke          # the auto engine
    python -m repro_torch.launch.train --smoke --nproc 4 --backend gloo \
        --device cpu                                  # auto, DTensors
    python -m repro_torch.launch.train --engine manual --sync plan --smoke
    python -m repro_torch.launch.train --engine manual --sync ring --smoke
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --steps 30 --ckpt-dir ckpt --faults seed=7,steps=30,device_loss=0.1
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --arch deepseek-moe-16b
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --arch rwkv6-1.6b          # or hymba-1.5b
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --arch qwen2-vl-7b         # or whisper-large-v3, mixtral-8x22b
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --nproc 4 --backend gloo --device cpu   # one process a rank
    python -m repro_torch.launch.train --engine manual --sync plan --smoke \
        --nproc 4 --backend gloo --device cpu --steps 30 --ckpt-dir ckpt \
        --faults seed=7,steps=30,device_loss=0.05

train smoke-size models (stablelm-12b by default) on the card;
`--device cpu` runs them on the CPU. Without `--smoke` the model is the
full configuration.
`run_training(tc, mesh=[("pod", 2), ("data", 4)])` trains over the
two-level mesh.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.sync import (AxisPlan, SyncConfig, expert_parallel,
                                   resolve_axis_plans)
from repro_torch.launch import analysis
from repro_torch.models.registry import ModelAPI
from repro_torch.models.tree import (LAYER_KEYS, stack_layers,
                                     tree_from_items, tree_items,
                                     unstack_layers)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.trace import default_tracer

# the step's parts, timed by CUDA events on a card (`phase_ms`)
PHASES = ("gather", "forward_backward", "reduce_scatter", "adamw")
# the auto step's AdamW: the elements of a leaf's local tensor updated at
# once (`_adamw_sliced`)
ADAMW_SLICE = 1 << 24
# the audio stub's frames a row, as the reference's `run_training` draws
AUDIO_FRAMES = 32
# the CLI's process mesh: the seconds its processes may run (and a
# collective may wait) before they are killed
CLI_MESH_TIMEOUT_S = 3600.0

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# ZeRO-3 layout
# ---------------------------------------------------------------------------
def _mesh_of(mesh) -> list[tuple[str, int]]:
    """The data-parallel local mesh as (axis, size) pairs in mesh order:
    an int n is the one axis ("data", n)."""
    if isinstance(mesh, (int, np.integer)):
        return [("data", int(mesh))]
    out = [(str(a), int(s)) for a, s in mesh]
    if not out or any(s < 1 for _, s in out):
        raise ValueError(f"a local mesh is (axis, size) pairs of sizes >= 1;"
                         f" got {mesh!r}")
    return out


def _split(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    flat = torch.nn.functional.pad(flat, (0, pad)) if pad else flat.clone()
    return flat.reshape(n, -1)


def shard_params_zero3(params: dict, mesh) -> list[torch.Tensor]:
    """The reference's ZeRO-3 shards of `params` over the local mesh
    `mesh` (an int n, or (axis, size) pairs): one (n, shard) tensor a
    leaf, n the product of the sizes, row r the rank whose mesh index is
    r in row-major order (on [("pod", 2), ("data", 4)] rank (p, d) holds
    row 4p + d), in the reference's leaf order. The port's per-layer
    lists under `tree.LAYER_KEYS` ("layers"; the encoder-decoder's
    "encoder" and "decoder") are stacked to (L, ...) leaves first (a
    tree without such a list is taken as stacked already); each leaf is
    flattened and zero-padded to a multiple of n. The tensors are
    copies.

    On a process mesh (`core.transport.ProcessMesh`) the result is this
    rank's row alone, a (shard,) tensor a leaf, made a leaf at a time."""
    pm = collectives.is_process_mesh(mesh)
    n = mesh.size if pm else math.prod(s for _, s in _mesh_of(mesh))
    if any(isinstance(params.get(k), list) for k in LAYER_KEYS):
        params = stack_layers(params)
    if pm:
        return [_split(x, n)[mesh.rank].clone()
                for _, x in tree_items(params)]
    return [_split(x, n) for _, x in tree_items(params)]


def _gather_leaf(shards: torch.Tensor, numel: int,
                 plans: Sequence[AxisPlan], mesh=None) -> torch.Tensor:
    """(n, shard) → (n, numel): every rank's gathered copy of the leaf,
    trimmed of its padding. `collectives.all_gather` inverts
    `_scatter_leaf`'s reduce-scatter per strategy, the hcps un-reorder
    included. On several axes (`mesh`, the live (axis, size) pairs) the
    plans gather in mesh order, as the reference's do, so rank (p, d)'s
    shard lands at chunk d·P + p of the gathered vector, not 4p + d.
    On a process mesh (`mesh` a `ProcessMesh`) this rank's (shard,) →
    its (numel,) copy, gathered over its process groups."""
    pm = collectives.is_process_mesh(mesh)
    full = shards if mesh is None or pm else shards.reshape(
        *(s for _, s in mesh), -1)
    for pl in plans:
        full = collectives.all_gather(full, pl.axis, pl.strategy,
                                      factors=pl.factors,
                                      schedule=pl.schedule, mesh=mesh)
    return full[:numel] if pm else full.reshape(shards.shape[0],
                                                -1)[:, :numel]


def _scatter_leaf(grads: torch.Tensor, plans: Sequence[AxisPlan],
                  mesh=None) -> torch.Tensor:
    """(n, numel) per-rank gradients → (n, shard): row i rank i's shard
    of their sum, zero-padded to the plans' multiples; on several axes
    (`mesh`) the plans reduce-scatter in reverse mesh order, the exact
    inverse of `_gather_leaf`. On a process mesh this rank's (numel,)
    gradient → its (shard,) of the sum."""
    pm = collectives.is_process_mesh(mesh)
    out = grads if mesh is None or pm else grads.reshape(
        *(s for _, s in mesh), -1)
    for pl in reversed(plans):
        out = collectives.reduce_scatter(out, pl.axis, pl.strategy,
                                         factors=pl.factors,
                                         schedule=pl.schedule, mesh=mesh)
    return out if pm else out.reshape(grads.shape[0], -1)


def _shard_of(numel: int, mesh, plans: Sequence[AxisPlan]) -> int:
    """The per-rank elements of a leaf of `numel` after `plans`'
    reduce-scatter on `mesh` (an int n, or (axis, size) pairs), axis by
    axis in reverse: the shard left by the axis before, padded to this
    axis's multiple (a schedule's block count, a flat label's
    `_pad_multiple`), over its size, or over the power-of-two core for
    rhd on other axis sizes."""
    sizes = dict(_mesh_of(mesh))
    cur = numel
    for pl in reversed(plans):
        n = sizes[pl.axis]
        mult = (pl.schedule.num_blocks if pl.strategy == "plan"
                else collectives._pad_multiple(n, pl.strategy))
        padded = -(-cur // mult) * mult
        cur = padded // (collectives._rhd_pow2(n)[0] if pl.strategy == "rhd"
                         else n)
    return cur


def _rank_batch(batch: dict, r: int, n: int) -> dict:
    """Rank r's rows of the batch, as the reference's `batch_specs` splits
    it: [r·B/n, (r+1)·B/n) of each leaf whose leading size B is a
    multiple of n above 1, the whole leaf otherwise (replicated);
    "mrope_positions" (3, B, T) on its batch axis 1 where B is a multiple
    of n. On several axes r is the row-major mesh index, as the
    reference's batch spec over all data-parallel axes splits it."""
    out = {}
    for k, v in batch.items():
        if k == "mrope_positions":
            B = v.shape[1]
            out[k] = v[:, r * B // n:(r + 1) * B // n] if B % n == 0 else v
            continue
        B = v.shape[0] if v.dim() else 0
        out[k] = (v[r * B // n:(r + 1) * B // n] if B > 1 and B % n == 0
                  else v)
    return out


def data_config(cfg, seq_len: int, global_batch: int, seed: int = 0):
    """The `DataConfig` of the reference's `run_training` for `cfg`: its
    stub embeddings as wide as the model where it takes embeddings, and
    AUDIO_FRAMES frames a row for the audio family."""
    from repro_torch.data import DataConfig
    return DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      embed_dim=cfg.d_model if cfg.embeds_input else 0,
                      frames=AUDIO_FRAMES if cfg.family == "audio" else 0)


def batch_tensors(batch: dict, device) -> dict:
    """A `SyntheticLM` batch of numpy arrays as tensors on `device`: the
    integer arrays (tokens, labels, M-RoPE positions) as int64, the
    stub embeddings and frames in their f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


# ---------------------------------------------------------------------------
# the auto engine
# ---------------------------------------------------------------------------
def _auto_mesh(mesh):
    """The auto engine's mesh: None (one device) or a `ProcessMesh`, whose
    "model" axis, if any, may be above 1 (tensor parallelism)."""
    if mesh is None:
        return None
    if not collectives.is_process_mesh(mesh):
        raise ValueError(
            f"the auto engine runs on one device (mesh=None) or with one "
            f"process a rank (a core.transport.ProcessMesh); the local mesh "
            f"{mesh!r} holds its ranks as rows of one device's tensors, "
            f"which is the manual engine's layout")
    return mesh


def place_state(params: dict, mesh, placements: dict) -> dict:
    """The auto engine's state from the whole parameters (the port's tree,
    the same on every rank; its per-layer lists stacked here):
    {"params": [...], "opt": {"m", "v": f32 zeros, "step"}} in the
    reference's leaf order. On one device (`mesh` None) the leaves as
    they are; on a `ProcessMesh` each leaf and moment a DTensor at
    `placements` (`make_train_step`'s `state_placements`) holding this
    rank's slice, cut locally, with no collective."""
    from torch.distributed.tensor import DTensor, Shard

    if any(isinstance(params.get(k), list) for k in LAYER_KEYS):
        params = stack_layers(params)
    params = [x for _, x in tree_items(params)]
    if mesh is None:
        leaves = list(params)
        return {"params": leaves, "opt": adamw_init(leaves)}
    from repro_torch.launch.mesh import device_mesh
    dmesh = device_mesh(mesh)
    sizes = [s for _, s in mesh.axes]

    def local(x: torch.Tensor, pl) -> torch.Tensor:
        for p, n, c in zip(pl, sizes, mesh.coords):
            if isinstance(p, Shard):
                size = x.shape[p.dim] // n
                x = x.narrow(p.dim, c * size, size)
        return x

    def place(xs, pls, zeros: bool = False) -> list:
        out = []
        for x, pl in zip(xs, pls):
            t = local(x, pl)
            t = (torch.zeros(t.shape, dtype=torch.float32, device=x.device)
                 if zeros else t.clone())
            out.append(DTensor.from_local(
                t, dmesh, pl, run_check=False, shape=x.shape,
                stride=torch.empty(x.shape, device="meta").stride()))
        return out

    return {"params": place(params, placements["params"]), "opt": {
        "m": place(params, placements["opt"]["m"], zeros=True),
        "v": place(params, placements["opt"]["v"], zeros=True),
        "step": torch.zeros((), dtype=torch.int32, device=mesh.device)}}


def local_state(state: dict) -> dict:
    """The auto engine's state with each DTensor replaced by its local
    tensor, which shares its storage: what a rank checkpoints, and what a
    restore overwrites in place."""
    from repro_torch.optim.adamw import _local
    opt = state["opt"]
    return {"params": [_local(p) for p in state["params"]],
            "opt": {"m": [_local(t) for t in opt["m"]],
                    "v": [_local(t) for t in opt["v"]],
                    "step": opt["step"]}}


def gather_c10d(p, mesh, axes=None) -> torch.Tensor:
    """The whole value of the DTensor `p` on this rank of the process mesh
    `mesh`: for each mesh dimension on which `p` is `Shard(d)`, innermost
    first, `torch.distributed.all_gather_into_tensor` over that axis's
    process group and a concatenation along d. With `axes` (names) only
    over those: the local tensor of `p` at `Replicate` there (the auto
    engine gathers over the data-parallel axes, never "model").

    Why it exists: DTensor's own Shard → Replicate issues the functional
    collective (`_c10d_functional.all_gather_into_tensor`), which killed
    the process (SIGSEGV) on a gloo group with CUDA tensors, every rank
    on one H100 (torch 2.11); the c10d collective on the same group and
    tensors ran. So the auto engine's gather on "gloo through the host"
    issues that one; over NCCL and on the CPU the redistribution is
    DTensor's own. Its reduce-scatter and all-reduce ran through
    DTensor there and stay DTensor's."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    x = p.to_local()
    for i in reversed(range(len(mesh.axes))):
        pl = p.placements[i]
        if not isinstance(pl, Shard) or (
                axes is not None and mesh.axes[i][0] not in axes):
            continue
        line = mesh.line(mesh.axes[i][0])
        x = x.contiguous()
        out = x.new_empty((line.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=line.group)
        x = torch.cat(out.chunk(line.size), dim=pl.dim)
    return x


def _adamw_sliced(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, step: torch.Tensor, out: torch.Tensor,
                  cfg: AdamWConfig) -> None:
    """`adamw_update` of one leaf's local tensors (`cfg` without clipping)
    in slices of ADAMW_SLICE elements: the moments `m` and `v` updated
    in place, the new parameters written to `out` (which may be `p`).
    The update is elementwise, so each slice's result is the whole
    leaf's, bit for bit, and its f32 temporaries are a slice's, not a
    leaf's (a 257 M-element local embedding takes ≈ 8 GB of them whole)."""
    src, grad = p.reshape(-1), g.reshape(-1)
    mf, vf, dst = m.view(-1), v.view(-1), out.view(-1)
    for a in range(0, src.numel(), ADAMW_SLICE):
        s = slice(a, a + ADAMW_SLICE)
        new_p, new_o, _ = adamw_update(
            [src[s]], [grad[s]], {"m": [mf[s]], "v": [vf[s]], "step": step},
            cfg)
        mf[s].copy_(new_o["m"][0])
        vf[s].copy_(new_o["v"][0])
        dst[s].copy_(new_p[0])


def make_train_step(api: ModelAPI, mesh=None,
                    opt_cfg: AdamWConfig = AdamWConfig(), *,
                    fsdp: bool = True, act_hook: Callable | None = None,
                    device: str | torch.device | None = None):
    """The auto engine, the reference's `make_train_step`: returns (step,
    state_placements, batch_placements). It is the baseline: no planner,
    no GenTree, no `core.lower` schedule; the collectives a change of
    placement needs are issued by `torch.distributed` itself (DTensor's
    redistributions), as XLA SPMD inserts them in the reference.

    `mesh` None is one device (`device`, default the card): every
    placement there is `Replicate`, so the step is the plain step, the
    reference's on a one-device mesh. `mesh` a `core.transport.
    ProcessMesh` (one process a rank, on its device; the local mesh
    raises ValueError) holds every parameter and AdamW moment as a
    DTensor over `launch.mesh.
    device_mesh(mesh)` at the reference's placements
    (`launch.sharding`: the FSDP spec of each stacked leaf, or with
    `fsdp=False` ZeRO-1, parameters `Replicate` over the DP axes and the
    moments sharded). `state_placements(leaves)` gives {"params", "opt":
    {"m", "v", "step"}} of the reference-ordered leaves,
    `batch_placements(batch)` the batch's; `place_state` builds the
    state.

    `step(state, batch) -> (state, metrics)` updates `state` in place.
    `batch` is the global batch (`batch_tensors`). Per step:

      1. each parameter goes from its placement to `Replicate` over the
         DP axes (the FSDP all-gather; a no-op for a replicated leaf),
         never over "model": a leaf the "model" axis shards stays this
         rank's slice of it;
      2. the model's training loss (`api.loss_fn(remat=True)`) runs on
         the rank's rows of the batch (`_rank_batch` at its index on the
         DP axes, the reference's `batch_specs` split; the ranks of a
         model line share them) as local tensors, under the activation
         check `actsharding.batch_dp_hook` (or `act_hook`) and the mesh
         context the MoE layer reads. On a "model" axis above 1 it runs
         under `actsharding.TPContext` (`TPContext.for_tree`): each
         product whose weight the axis shards runs on this rank's slice
         (`layers.tp_dot` / `tp_ffn`: column and row products, the
         Megatron MLP; the embedding's local columns; the logits'
         vocabulary slice and a vocabulary-parallel loss), through the
         four operators of `core.transport` over the model line, and a
         leaf used outside a product (a norm's weight, an SSM's decays)
         is gathered over the line where it is used. Every activation
         between products is the same bits on every rank of the line
         (partials summed in line order). The loss
         is the reference's global masked mean: the rank's masked sum
         over the global mask count (all-reduced over the DP ranks), so
         the ranks' losses and gradients sum to the one-device ones; the
         gathered copies are released after the backward;
      3. each gradient is marked `Partial("sum")` over the DP axes and,
         on "model", at its leaf's placement (`Shard(d)`: the gradient
         of this rank's slice; `Replicate`), and redistributed to its
         moments' placement (the leaf's under FSDP):
         a reduce-scatter for a sharded leaf, an all-reduce for a
         replicated one;
      4. AdamW runs on the local shards, clipped by the global norm of
         the whole tree (`optim.adamw.global_norm` over DTensors, each
         element counted once). Under ZeRO-1 a replicated parameter is
         updated on its moments' shard and gathered back (within the
         "adamw" part of `PHASES`).

    metrics: "loss" (the global masked mean), "gnorm" (the global
    norm), and on a card "events", CUDA events at the bounds of `PHASES`
    (`phase_ms`). The step launches no kernel wrapper: the training
    forward runs `layers.train_rmsnorm` / `train_attention` and the
    recurrences' torch ops."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.transport import all_gather_rows
    from repro_torch.launch import sharding as shr
    from repro_torch.models import actsharding
    from repro_torch.optim.adamw import (_local, clip_by_global_norm,
                                         global_norm)

    pm = _auto_mesh(mesh)
    if pm is None:
        dev = resolve_device("cuda" if device is None else device)
        axes = (("data", 1), ("model", 1))
        dmesh = line = tp_line = None
        dp = ()
        dpn = 1
    else:
        from repro_torch.launch.mesh import device_mesh
        dev = pm.device
        axes = pm.axes
        dmesh = device_mesh(pm)
        dp = shr._dp_axes(axes)
        dpn = shr._dp_size(axes)
        line = pm.line(dp) if dp else None
        tp_line = (pm.line("model") if dict(axes).get("model", 1) > 1
                   else None)
    specs = tree_items(api.params_spec())
    paths = [p for p, _ in specs]
    tracer = default_tracer()

    def state_placements(leaves: Sequence[torch.Tensor]) -> dict:
        p_spec = shr.params_specs(list(leaves), axes, fsdp=fsdp)
        return shr.to_placements(
            {"params": p_spec,
             "opt": shr.opt_specs({"m": list(leaves)}, p_spec, axes)},
            axes)

    def batch_placements(batch: dict) -> dict:
        return shr.to_placements(shr.batch_specs(batch, axes), axes)

    placements = state_placements([t for _, t in specs])
    # each leaf's dim on the "model" axis, or None where it replicates
    model_dim = [next((q.dim for (a, _), q in zip(axes, pl)
                       if a == "model" and isinstance(q, Shard)), None)
                 for pl in placements["params"]]
    tp_dims = dict(zip(paths, model_dim))
    # the update of one leaf's local shard, its gradient clipped already
    leaf_cfg = dataclasses.replace(opt_cfg, grad_clip=0.0)
    # a rank's gradient: a partial sum over the DP ranks, and on "model"
    # the leaf's own placement (the layers leave each rank the gradient
    # of its slice, or the whole gradient on every rank of the line)
    grad_from = [None if dmesh is None else
                 [Partial() if a != "model" else
                  Replicate() if d is None else Shard(d) for a, _ in axes]
                 for d in model_dim]

    def mark() -> torch.cuda.Event | None:
        if dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def whole(p: torch.Tensor) -> torch.Tensor:
        """The leaf gathered over the DP axes on this rank (the FSDP
        all-gather): its whole value, or where "model" shards it this
        rank's slice of it, never gathered over "model"."""
        if dmesh is None:
            return p
        if pm.transport == "gloo through the host":
            return gather_c10d(p, pm, dp)
        return p.redistribute(dmesh, [
            q if a == "model" else Replicate()
            for (a, _), q in zip(axes, p.placements)]).to_local()

    def moved(x: torch.Tensor, pl) -> torch.Tensor:
        """The DTensor `x` at `pl` (ZeRO-1: a parameter's shard at its
        moments' placement, a local slice; the updated shard back to the
        parameter's placement, an all-gather over the DP axes)."""
        if dmesh is None or tuple(x.placements) == tuple(pl):
            return x
        if all(isinstance(q, Replicate) or a == "model"
               for (a, _), q in zip(axes, pl)):
            return DTensor.from_local(whole(x), dmesh, pl, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return x.redistribute(dmesh, pl)

    def reduce(g: torch.Tensor, leaf: torch.Tensor, src, pl
               ) -> torch.Tensor:
        """This rank's gradient of `leaf`, at `src` (`grad_from`), summed
        over the DP ranks, at `pl`."""
        if dmesh is None:
            return g
        return DTensor.from_local(
            g, dmesh, src, run_check=False, shape=leaf.shape,
            stride=leaf.stride()).redistribute(dmesh, pl)

    def dp_sum(x: torch.Tensor) -> torch.Tensor:
        """The sum over the DP ranks, in rank order, on every rank."""
        if line is None or dpn == 1:
            return x
        return all_gather_rows(pm, line, x.reshape(1)).sum()

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        if len(params) != len(paths):
            raise ValueError(f"the state holds {len(params)} leaves, "
                             f"{api.cfg.name} has {len(paths)}")
        B = batch["labels"].shape[0]
        split = dpn > 1
        if split and (B % dpn or B == 1):
            raise ValueError(f"the auto engine over processes splits the "
                             f"batch's {B} rows over its {dpn} "
                             "data-parallel ranks")
        rows = _rank_batch(batch, line.index, dpn) if split else batch
        metrics = {}
        events = [mark()]
        with torch.no_grad(), tracer.span("train/gather",
                                          leaves=len(params)):
            full = [whole(p) for p in params]
        events.append(mark())
        with tracer.span("train/forward_backward", rows=B // dpn):
            mask = rows.get("mask")
            count = (mask.float().sum() if mask is not None else
                     torch.tensor(float(rows["labels"].numel()),
                                  device=dev))
            total = dp_sum(count)
            leaves = [f.detach().requires_grad_(True) for f in full]
            del full
            tree = unstack_layers(tree_from_items(zip(paths, leaves)))
            actsharding.set_hook(
                act_hook or (actsharding.batch_dp_hook(axes, B)
                             if split else None), pm if split else None)
            if tp_line is not None:
                actsharding.set_tp(actsharding.TPContext.for_tree(
                    pm, tp_line, api.cfg.vocab, tree, tp_dims))
            try:
                loss = api.loss_fn(tree, rows, remat=True)
                if split:
                    loss = loss * (torch.clamp(count, min=1.0)
                                   / torch.clamp(total, min=1.0))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                actsharding.set_hook(None)
                actsharding.set_tp(None)
            grads = [t.new_zeros(t.shape) if g is None else g
                     for t, g in zip(leaves, grads)]
            del tree, leaves
        events.append(mark())
        with torch.no_grad():
            with tracer.span("train/reduce_scatter", leaves=len(grads)):
                # to the moments' placement: the parameters' under FSDP,
                # sharded under ZeRO-1 too
                grads = [reduce(g, p, src, pl) for g, p, src, pl in
                         zip(grads, params, grad_from,
                             placements["opt"]["m"])]
            events.append(mark())
            with tracer.span("train/adamw", leaves=len(grads)):
                if opt_cfg.grad_clip > 0:
                    grads, gnorm = clip_by_global_norm(grads,
                                                       opt_cfg.grad_clip)
                else:
                    gnorm = global_norm(grads)
                # then leaf by leaf on the local shards (elementwise), a
                # slice of a leaf at a time (`_adamw_sliced`)
                for i, (g, mpl, ppl) in enumerate(zip(
                        grads, placements["opt"]["m"],
                        placements["params"])):
                    p = moved(params[i], mpl)
                    new = (_local(p) if p is params[i]
                           else torch.empty_like(_local(p)))
                    _adamw_sliced(_local(p), _local(g),
                                  _local(opt["m"][i]), _local(opt["v"][i]),
                                  opt["step"], new, leaf_cfg)
                    if p is not params[i]:            # ZeRO-1
                        _local(params[i]).copy_(_local(moved(
                            DTensor.from_local(
                                new, dmesh, mpl, run_check=False,
                                shape=p.shape, stride=p.stride()), ppl)))
                    grads[i] = None
                    del new
                opt["step"].copy_(opt["step"] + 1)
                del grads
            events.append(mark())
            metrics["loss"] = dp_sum(loss.detach())
            metrics["gnorm"] = gnorm
        if dev.type == "cuda":
            metrics["events"] = events
        return state, metrics

    step.placements = placements
    step.device = dev
    return step, state_placements, batch_placements


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


def _ep_schedule(axis: str, n: int, sync: SyncConfig, total_bytes: float):
    """The reference's `ep_sched`: the lowered family="all_to_all"
    schedule of the EP axis from `PlannerService.get_family_executable`
    at the model's bytes in f32 units, guarded unless `sync.guard` is
    off; None (the flat exchange, as the reference's `lax.all_to_all`)
    where it does not lower, which is logged."""
    from repro_torch.core.lower import LoweringError, guard_schedule
    from repro_torch.planner.service import default_service

    svc = default_service()
    try:
        sched = svc.get_family_executable("all_to_all", axis, n,
                                          total_bytes / 4.0 or 1.0,
                                          params=sync.params).schedule
    except LoweringError as e:
        _log.warning("the EP all-to-all plan does not lower (%s): the "
                     "exchange runs the flat copy, as the reference's "
                     "lax.all_to_all", e)
        return None
    if sched is not None and sync.guard:
        sched = guard_schedule(sched,
                               telemetry=getattr(svc, "telemetry", None))
    return sched


# the routed experts' leaves: a rank reads its EP slice of each
EXPERT_LEAVES = (("layers", "moe", "wg"), ("layers", "moe", "wi"),
                 ("layers", "moe", "wo"))


def ep_loss_and_grads(api: ModelAPI, full: Sequence[torch.Tensor],
                      batch: dict, mesh, put: Callable, *,
                      lossy: bool = False
                      ) -> tuple[list[torch.Tensor], dict[str, int]]:
    """The expert-parallel forward and backward of every rank of the
    local mesh `mesh` (the live (axis, size) pairs, or an int n) in one
    graph, under the active `expert_parallel` context: the reference's
    `value_and_grad(loss_fn(moe_dispatch="ep"))` on each device, which
    runs each MoE layer's exchange over all devices at once.

    `full` is the gathered leaves in the reference's order, stacked (L,
    ...) layer leaves (one shared copy, or under a lossy wire (n, ...)
    rows, row r rank r's). Each rank reads its own detached leaves, one
    a layer for the layer leaves, and of the routed experts only its EP
    slice [i·E/size, (i+1)·E/size) (i its index along the context's
    axis), so no rank's graph holds a gradient of the others' experts.
    `transformer.loss_fn_ep` runs the ranks layer by layer (each layer
    checkpointed over all ranks), and one backward of the sum of their
    losses gives each rank's leaves the cotangent of the reference's
    per-device `value_and_grad`. Each gradient lands where autograd
    accumulates it: a post-accumulate hook calls `put(r, i, g, off)`
    (rank r, leaf i, the flat gradient g of its elements [off, off +
    len)) and frees it, so at most the gradients in flight are live, not
    the n ranks' whole sets. The rows of the other experts are written
    zero (the transpose of the reference's `dynamic_slice`), and so is
    a part the loss does not reach (the reference's `value_and_grad`
    gives it zeros). Returns the ranks' detached losses and the exchanges
    this call ran: {"forward", "recompute", "backward"}.

    On a process mesh (`mesh` a `ProcessMesh`, the context's `mesh`) the
    same for this rank alone: its own leaves and experts, its own
    `api.loss_fn(moe_dispatch="ep")` (each layer checkpointed with early
    stop off), each exchange over the EP axis's process group, so every
    rank issues its exchanges in the same order (forward, recompute,
    backward) and lands its gradients in its own buffers."""
    from repro_torch.core import sync

    cfg = api.cfg
    ctx = sync.ep_context()
    if ctx is None:
        raise ValueError("ep_loss_and_grads runs under expert_parallel")
    pm = collectives.is_process_mesh(mesh)
    if pm:
        pairs, n, ranks = mesh, mesh.size, [mesh.rank]
    else:
        pairs = _mesh_of(mesh)
        n = math.prod(s for _, s in pairs)
        ranks = range(n)
    E, L = cfg.n_experts, cfg.n_layers
    el = E // ctx.size
    paths = [p for p, _ in tree_items(api.params_spec())]
    pending: dict = {}         # (r, i, off) of each part not landed: numel

    def hook(r: int, i: int, off: int):
        def land(t: torch.Tensor) -> None:
            put(r, i, t.grad.reshape(-1), off)
            t.grad = None
            pending.pop((r, i, off))
        return land

    def leaf(r: int, i: int, off: int, v: torch.Tensor) -> torch.Tensor:
        t = v.detach().requires_grad_(True)
        t.register_post_accumulate_grad_hook(hook(r, i, off))
        pending[(r, i, off)] = t.numel()
        return t

    params, leaves = [], []
    for r in ranks:
        e0 = ctx.index(pairs, r) * el
        top, per_layer = [], [[] for _ in range(L)]
        for i, (path, f) in enumerate(zip(paths, full)):
            src = f[r] if lossy else f
            if path[0] != "layers":
                top.append((path, leaf(r, i, 0, src)))
                continue
            per = src[0].numel()
            for l in range(L):
                v, off = src[l], l * per
                if path in EXPERT_LEAVES:
                    row = per // E
                    v, off = v[e0:e0 + el], off + e0 * row
                    for a, b in ((l * per, off),
                                 (off + el * row, (l + 1) * per)):
                        if b > a:
                            put(r, i, src.new_zeros(()).expand(b - a), a)
                per_layer[l].append((path[1:], leaf(r, i, off, v)))
        leaves += [t for _, t in top] + [t for items in per_layer
                                         for _, t in items]
        params.append({**tree_from_items(top), "layers": [
            tree_from_items(items) for items in per_layer]})
    batches = [_rank_batch(batch, r, n) for r in ranks]
    ex = sync.EP_EXCHANGES
    f0, b0 = ex["forward"], ex["backward"]
    if pm:
        losses = [api.loss_fn(params[0], batches[0], remat=True,
                              moe_dispatch="ep")]
    else:
        losses = api.loss_fn_ep(params, batches, mesh=pairs, remat=True)
    f1 = ex["forward"]
    torch.autograd.backward(torch.stack(losses).sum(), inputs=leaves)
    for (r, i, off), numel in pending.items():
        put(r, i, full[i].new_zeros(()).expand(numel), off)
    return [x.detach() for x in losses], {
        "forward": f1 - f0, "recompute": ex["forward"] - f1,
        "backward": ex["backward"] - b0}


def rank_loss_and_grads(api: ModelAPI, full: Sequence[torch.Tensor],
                        batch: dict, n: int, put: Callable, *,
                        lossy: bool = False,
                        ranks: Sequence[int] | None = None
                        ) -> list[torch.Tensor]:
    """Each rank's forward and backward in turn, the reference's
    per-device `value_and_grad(loss_fn(remat=True))`: rank r reads its
    own detached copy of the gathered leaves `full` (the reference's
    order, stacked (L, ...) layer leaves; under a lossy wire (n, ...)
    rows, row r its copy) and its rows of the batch (`_rank_batch`), and
    `put(r, i, g)` lands its gradient of leaf i, zeros for a leaf the
    loss does not reach (a vlm's `embed`, where the reference's
    `value_and_grad` gives zeros). Returns the ranks' detached losses.

    On the meta device (the dry run, `launch.dryrun`) the ranks run the
    same shapes and compute no values, so rank 0's forward and backward
    stand for all n: the census counts them n times
    (`analysis.repeated`).

    `ranks` runs those ranks alone (a process mesh's own rank, whose
    `full` is its own copy); their losses are returned."""
    paths = [p for p, _ in tree_items(api.params_spec())]
    same = bool(full) and full[0].is_meta and ranks is None
    losses = []
    with analysis.repeated(n if same else 1):
        for r in (ranks if ranks is not None else range(1 if same else n)):
            leaves = [(f[r] if lossy else f).detach().requires_grad_(True)
                      for f in full]
            params = unstack_layers(tree_from_items(zip(paths, leaves)))
            loss = api.loss_fn(params, _rank_batch(batch, r, n), remat=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for i, (t, g) in enumerate(zip(leaves, grads)):
                put(r, i,
                    t.new_zeros(()).expand(t.numel()) if g is None else g)
            losses.append(loss.detach())
            del leaves, params, loss, grads
    return losses * n if same else losses


def make_manual_train_step(api: ModelAPI, mesh,
                           opt_cfg: AdamWConfig = AdamWConfig(), *,
                           sync: SyncConfig = SyncConfig(strategy="plan",
                                                         bucket_bytes=0),
                           device: str | torch.device = "cuda",
                           param_dtype: torch.dtype = torch.bfloat16):
    """ZeRO-3 step over a local mesh of data-parallel ranks on `device`:
    `step(state, batch) -> (state, metrics)`. `mesh` is an int n (one
    axis, ("data", n)) or the mesh's (axis, size) pairs in the reference
    mesh's order, e.g. [("pod", 2), ("data", 4)]; n is the product of the
    sizes, and the live axes (size > 1) are the reference's `axes`.

    `state` is {"params": [(n, shard) per leaf], "opt": {"m", "v":
    lists of the same shapes in f32, "step"}} (`shard_params_zero3`,
    `adamw_init`), in the reference's leaf order, its shards in
    `param_dtype`, and is updated in place (the reference donates it).
    `batch` is the global batch on `device` (`batch_tensors`): "tokens"
    and "labels"; a vlm's "embeds" and "mrope_positions" in place of the
    tokens; an audio model's "frames" beside them. Per step:

      1. the parameters are gathered with the plans' AllGathers, in mesh
         order; at full precision the n gathered rows must be equal
         (checked, `torch.equal`), so the ranks share one copy and the
         others are dropped. Under a lossy wire each rank's copy differs
         (its own shard exact, the others decoded), so the (n, numel)
         rows are kept and rank r's forward reads row r;
      2. each rank r (row-major mesh index) runs `api.loss_fn(remat=True)`
         on its rows of the batch, and its gradients, in the parameters'
         dtype, land in row r of the tensors the reduce-scatter runs on
         (`rank_loss_and_grads`; zeros for a leaf the loss does not
         reach).
         A MoE model whose E experts split over the first live axis (size
         > 1 dividing E: the reference's `use_ep`) runs every rank at once
         instead, under `expert_parallel` over that axis with
         `moe_dispatch="ep"` (`ep_loss_and_grads`): the exchange is the
         guarded, lowered family="all_to_all" schedule of
         `PlannerService.get_family_executable` under "plan" (a wire
         leaves it in the parameters' dtype, as the reference's), the
         flat copy program under the other labels; otherwise MoE runs
         the per-rank loop with its sorted (grouped) dispatch;
      3. the gradients are reduce-scattered with the plans in reverse
         mesh order and divided by n in their dtype;
      4. AdamW runs per rank on that rank's shards, as inside the
         reference's shard_map: each rank clips by the norm of its own
         shards.

    The sync path is the reference's, for every `sync.strategy` it takes
    (`compress` raises):
      * bucketed, for "plan" on one live axis when `sync.bucket_bytes` is
        not 0 (None: GenModel picks the bucket; a value pins it):
        `PlannerService.get_bucket_plan` at
        the model's bytes in `param_dtype` over 4, and ONE all-gather a
        gather bucket (`core.bucketing.zero3_gather_bucketed`, shard cap
        bucket_bytes // n; at full precision the gathered rows compared
        bucket by bucket) and ONE in-place reduce-scatter a scatter
        bucket. Each scatter
        bucket's (n ranks, n·width) tensor is allocated once a step, zero
        only in its padding, and each rank's gradient is written straight
        into its columns (`Zero3Bucket.write`), so there is no
        concatenation copy and no private copy in the reduce-scatter.
        With `sync.backward_overlap` the buckets reduce last first
        (spans `bucket/zero3_rs`). Where the reference falls back to the
        per-leaf path (more than one live axis: the bucket row layout is
        one axis's; the bucket plan does not lower, or has no canonical
        shards), so does this step: it logs why, and `step.bucket_plan`
        is None;
      * per leaf otherwise: one all-gather and one reduce-scatter a leaf
        and a live axis (`collectives.all_gather` / `reduce_scatter`,
        `mesh=` on several axes), the axis plans resolved at the summed
        element count of one rank's shards, each axis priced at
        `axis_level` of its position among the live axes (on [("pod",
        2), ("data", 4)] "pod" is level 0, as in the reference): "auto"
        is psum, "gentree" the planner's label for each axis
        (`PlannerService.get_axis_plans`), "plan" its lowered schedule,
        bound to the wire `sync.precision` asks for within
        `sync.tolerance`, a flat label itself (`resolve_axis_plans`). A
        plan whose reduce-scattered shard of some leaf would not be that
        leaf's parameter shard (its blocks pad the leaf past the multiple
        of n, or rhd shards over the power-of-two core) is refused here.

    `step.plans` is the axis plans the step runs, in mesh order (the
    bucket plan's on the bucketed path; a "plan" schedule guarded unless
    `sync.guard` is off), `step.mesh` the live (axis, size) pairs,
    `step.wire` the wire's name or None, `step.bucket_plan` the
    `PlannerService.BucketPlan` or None, `step.gather_buckets` /
    `step.scatter_buckets` the two halves' `Zero3Bucket`s (empty per
    leaf), `step.ep` the EP (axis, size) or None, `step.ep_schedule` its
    exchange's schedule (None: the flat copy).

    metrics: "loss", the mean of the ranks' losses; "gnorm", the mean of
    the ranks' shard norms (the reference's `pmean`s); on a card,
    "events", CUDA events at the bounds of `PHASES` (`phase_ms`); on the
    EP path "ep_exchanges", the step's exchanges {"forward", "recompute",
    "backward"}.

    On a process mesh (`mesh` a `core.transport.ProcessMesh`, one process
    a rank; `device` is the mesh's) the step is rank r's row of the
    above, with rank r's shards alone in `state` ((shard,) a leaf,
    `shard_params_zero3(params, mesh)`): the gathers and reduce-scatters
    run over its process groups in the same orders, it runs its own
    forward and backward, its copy is its own under any wire, and
    "loss" and "gnorm" are the means of the ranks' values in rank order,
    gathered through the transport. A MoE model whose experts split over
    the first live axis runs its own rank's expert-parallel forward and
    backward (`ep_loss_and_grads` on the process mesh), each exchange
    over that axis's process group.

    With `step.digest` set, metrics "digest" is `params_digest` of the
    gathered copy, for comparing the ranks' copies."""
    from repro_torch.core.bucketing import (zero3_gather_bucketed,
                                            zero3_layout,
                                            zero3_scatter_bucket)
    from repro_torch.core.sync import check_plan_config
    from repro_torch.core.transport import all_gather_rows

    pm = mesh if collectives.is_process_mesh(mesh) else None
    cfg = api.cfg
    check_plan_config(sync)
    if sync.compress is not None:
        raise NotImplementedError(
            f"compress={sync.compress!r} in the ZeRO-3 trainer: the "
            "reference compresses only in sync_gradients, and a lossy "
            "wire in the trainer is ROADMAP §1 item 9")
    if pm is None:
        dev = resolve_device(device)
        live = [(a, s) for a, s in _mesh_of(mesh) if s > 1]
        n = math.prod(s for _, s in live)
        # the ranks this process runs, and the leading size of its
        # tensors: every rank's row of the local mesh
        ranks, lead, where = range(n), (n,), {}
        # one live axis: (n, ...) rows as they are; several: the mesh
        kw = {"mesh": live} if len(live) > 1 else {}
    else:
        dev, n = pm.device, pm.size
        live = [(a, s) for a, s in pm.axes if s > 1]
        # this rank's own shards, flat
        ranks, lead, where = [pm.rank], (), {"rank": pm.rank}
        kw = {"mesh": pm}

    def row(t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's row of one of this process's tensors."""
        return t if pm is not None else t[r]

    specs = tree_items(api.params_spec(param_dtype))
    paths = [p for p, _ in specs]
    numels = [math.prod(t.shape) for _, t in specs]
    shapes = [tuple(t.shape) for _, t in specs]
    # a MoE router stays f32 in any parameter dtype
    dtypes = [t.dtype for _, t in specs]
    itemsizes = [t.element_size() for _, t in specs]
    shard_sizes = [-(-m // n) for m in numels]
    total_bytes = sum(m * i for m, i in zip(numels, itemsizes))
    # the reference's use_ep: experts over the first live axis
    ep_axis, ep_n = live[0] if live else (None, 1)
    use_ep = (cfg.n_experts > 1 and ep_n > 1
              and cfg.n_experts % ep_n == 0)
    ep_sched = (_ep_schedule(ep_axis, ep_n, sync, total_bytes)
                if use_ep and sync.strategy == "plan" else None)
    bplan, plans = _sync_setup(api, live, n, sync, param_dtype)
    wires = {pl.schedule.wire.name for pl in plans
             if pl.schedule is not None and pl.schedule.wire is not None}
    # under a lossy wire each rank's gathered copy differs from the
    # others': the local mesh keeps the (n, ...) rows; a process holds
    # its own copy alone
    lossy = bool(wires) and pm is None
    gather_buckets = scatter_buckets = []
    if bplan is not None:
        k = plans[0].schedule.blocks_per_shard
        gather_buckets = zero3_layout(numels, dtypes, itemsizes, max(
            1, bplan.bucket_bytes // n), n, k, by_shard=True)
        scatter_buckets = zero3_layout(numels, dtypes, itemsizes,
                                       bplan.bucket_bytes, n, k)
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
        """Each leaf's one shared copy (a process's own), or under a
        lossy wire on the local mesh its (n, *shape) rows, row r rank r's
        copy."""
        if bplan is not None:
            return zero3_gather_bucketed(
                shards, [(shape, s.dtype) for shape, s in zip(shapes,
                                                              shards)],
                plans[0], bplan.bucket_bytes, n, shared=not lossy,
                mesh=pm)
        out = []
        for s, numel, shape, path in zip(shards, numels, shapes, paths):
            full = _gather_leaf(s, numel, plans, **kw)
            if pm is not None:
                out.append(full.reshape(shape))
                continue
            if lossy:
                out.append(full.reshape(n, *shape))
                continue
            if not full.is_meta and not torch.equal(
                    full[1:], full[:1].expand(n - 1, -1)):
                raise RuntimeError(f"leaf {'/'.join(path)}: the gathered "
                                   "rows of the ranks differ")
            out.append(full[0].reshape(shape).clone())
            del full
        return out

    def grad_buffers(shards: list[torch.Tensor]) -> tuple[list, Callable]:
        """The tensors this process's gradients land in, and the function
        that writes rank r's gradient of leaf i there (of its elements
        [off, off + len) alone where `off` is given)."""
        if bplan is None:
            bufs = [torch.empty((*lead, m), dtype=s.dtype, device=s.device)
                    for m, s in zip(numels, shards)]

            def put(r, i, g, off=0):
                g = g.reshape(-1)
                row(bufs[i], r)[off:off + g.numel()].copy_(g)
            return bufs, put
        bufs = [bk.matrix(n, shards[0].device) if pm is None
                else bk.matrix(n, shards[0].device, rows=1)[0]
                for bk in scatter_buckets]

        def put(r, i, g, off=0):
            if i in slot:                 # an empty leaf is in no bucket
                b, j = slot[i]
                scatter_buckets[b].write(row(bufs[b], r), j, g.reshape(-1),
                                         off)
        return bufs, put

    def reduce_scatter(bufs: list) -> list[torch.Tensor]:
        if bplan is None:
            out = []
            for i in range(len(bufs)):
                out.append(_scatter_leaf(bufs[i], plans, **kw))
                bufs[i] = None
            return out
        out: list = [torch.zeros((*lead, 0), dtype=param_dtype, device=dev)
                     ] * len(numels)
        order = range(len(scatter_buckets))
        for b in (reversed(order) if sync.backward_overlap else order):
            bk = scatter_buckets[b]
            for i, s in zip(bk.indices, zero3_scatter_bucket(
                    bufs[b], bk, plans[0], mesh=pm)):
                out[i] = s
            bufs[b] = None
        return out

    def mean(xs: list[torch.Tensor]) -> torch.Tensor:
        """The mean over every rank of the mesh (the reference's pmean)
        of this process's ranks' values."""
        x = torch.stack(xs)
        return (x if pm is None else all_gather_rows(
            pm, pm.line(pm.axis_names), x[0])).mean()

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        shards, opt = state["params"], state["opt"]
        if [tuple(s.shape) for s in shards] != [(*lead, m) for m in
                                                shard_sizes]:
            raise ValueError(f"state shards {[tuple(s.shape) for s in shards]}"
                             f" are not {cfg.name}'s {(*lead, 'shard')} "
                             f"leaves" + (f" of rank {pm.rank} of {n}"
                                          if pm is not None else ""))
        if bplan is not None and [s.dtype for s in shards] != dtypes:
            raise ValueError(f"the bucket plan is priced for "
                             f"{sorted({str(d) for d in dtypes})} shards; "
                             f"the state holds "
                             f"{sorted({str(s.dtype) for s in shards})}")
        metrics = {}
        events = [mark()]
        with tracer.span("train/gather", leaves=len(shards), **where):
            full = gather(shards)
        if step.digest:
            metrics["digest"] = params_digest(full)
        events.append(mark())
        bufs, put = grad_buffers(shards)
        exchanges = None
        with tracer.span("train/forward_backward", ranks=len(ranks),
                         ep=use_ep, **where):
            if use_ep:
                with expert_parallel(ep_axis, ep_n, ep_sched, mesh=pm):
                    losses, exchanges = ep_loss_and_grads(
                        api, full, batch, live if pm is None else pm, put,
                        lossy=lossy)
            else:
                losses = rank_loss_and_grads(
                    api, full, batch, n, put, lossy=lossy,
                    ranks=None if pm is None else ranks)
        del full
        events.append(mark())
        with torch.no_grad():
            with tracer.span("train/reduce_scatter", leaves=len(shards),
                             **where):
                # a reduce-scattered shard may be a view of its leaf's
                # whole working buffer: none outlives its division
                g_shards = [g / n for g in reduce_scatter(bufs)]
            del bufs
            for i, g in enumerate(g_shards):
                if g.shape != (*lead, shard_sizes[i]):
                    raise RuntimeError(
                        f"leaf {'/'.join(paths[i])}: reduce-scattered "
                        f"to {tuple(g.shape)}, its shards are "
                        f"{(*lead, shard_sizes[i])}")
            events.append(mark())
            with tracer.span("train/adamw", ranks=len(ranks), **where):
                gnorms = []
                for r in ranks:
                    rows = [[row(t, r) for t in ts] for ts in
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
            metrics["loss"] = mean(losses)
            metrics["gnorm"] = mean(gnorms)
            # the two means are the reference's pmeans over the ranks
            for m in (metrics["loss"], metrics["gnorm"]):
                analysis.note_collective("all-reduce", m.element_size(), n)
        if dev.type == "cuda":
            metrics["events"] = events
        if exchanges is not None:
            metrics["ep_exchanges"] = exchanges
        return state, metrics

    step.plans = plans
    step.mesh = live
    step.wire = next(iter(wires)) if wires else None
    step.bucket_plan = bplan
    step.gather_buckets = gather_buckets
    step.scatter_buckets = scatter_buckets
    step.ep = (ep_axis, ep_n) if use_ep else None
    step.ep_schedule = ep_sched
    step.digest = False
    return step


def _sync_setup(api: ModelAPI, live, n: int, sync: SyncConfig,
                param_dtype: torch.dtype):
    """The bucket plan (or None, logged where the reference falls back to
    the per-leaf path) and the axis plans of a ZeRO-3 step over the live
    (axis, size) pairs of n ranks, the plans' shards checked against the
    parameter shards."""
    specs = tree_items(api.params_spec(param_dtype))
    paths = [p for p, _ in specs]
    numels = [math.prod(t.shape) for _, t in specs]
    shard_sizes = [-(-m // n) for m in numels]
    total_bytes = sum(m * t.element_size() for m, (_, t) in
                      zip(numels, specs))
    bplan = None
    if sync.strategy == "plan" and sync.bucket_bytes != 0:
        if len(live) == 1:
            bplan, why = _bucket_plan(n, sync, total_bytes)
        else:
            why = (f"{len(live)} live mesh axes: the bucket row layout is "
                   "one axis's")
        if bplan is None:
            _log.warning("bucketed ZeRO-3 sync falls back to the per-leaf "
                         "path, as the reference's does: %s", why)
    if bplan is not None:
        plans = list(bplan.axis_plans)
    else:
        plans = ([AxisPlan(a, "psum") for a, _ in live]
                 if sync.strategy == "auto"
                 else resolve_axis_plans(live, sync,
                                         float(sum(shard_sizes))))
        for path, numel, size in zip(paths, numels, shard_sizes):
            got = _shard_of(numel, live or n, plans)
            if got != size:
                what = "; ".join(pl.schedule.describe()
                                 if pl.strategy == "plan" else pl.strategy
                                 for pl in plans)
                raise ValueError(
                    f"leaf {'/'.join(path)}: the plan's reduce-scatter "
                    f"shards hold {got} elements, its parameter "
                    f"shards {size} ({what})")
    return bplan, plans


def params_digest(tensors: Sequence[torch.Tensor]) -> int:
    """A checksum of the tensors' bytes in order: their 32-bit words (the
    bytes zero-padded to a multiple of 4), each weighted by its position
    modulo 65521 plus 1, summed in int64 and taken modulo 2^61 − 1."""
    total, pos = 0, 0
    step = 1 << 24
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 4
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        w = b.view(torch.int32)
        for off in range(0, w.numel(), step):
            c = w[off:off + step].to(torch.int64)
            idx = torch.arange(pos + off, pos + off + c.numel(),
                               device=c.device) % 65521 + 1
            total = (total + int((c * idx).sum())) % ((1 << 61) - 1)
        pos += w.numel()
    return total


def phase_ms(metrics: dict) -> dict[str, float] | None:
    """Device time of each of `PHASES` in one step, in ms, from the CUDA
    events of its metrics (waits for the last); None off the card."""
    ev = metrics.get("events")
    if not ev:
        return None
    ev[-1].synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1])
            for i, name in enumerate(PHASES)}


def observe_sync_probe(svc, mesh, axes=None, size_floats=None, on_log=print,
                       *, repeats: int = 3) -> list[dict]:
    """Time each live axis's compiled schedule alone on a process mesh
    and feed the planner's online loop (the reference's probe): for the
    live (axis, size) pairs `axes` (default the mesh's live axes), at
    `size_floats` and at a quarter of it, the axis's executable
    (`get_axis_executable` at `axis_level` of its position) runs its
    `allreduce` on a probe of ones over the rank's process group: one
    warm-up, then `repeats` runs, each started together (a small
    exchange over the mesh) and timed on the host clock to a
    synchronize. The slowest rank's median is the measurement, the same
    on every rank, so every rank's planner takes the same observation
    (`svc.observe`, default `default_service()`) and replans alike. The
    gloo transport through the host (`ProcessMesh.transport`) measures
    host staging, not links: its times are observed as
    `source="host_staged"` (tracked apart, never fitted). Returns the
    observations; unlike the reference's no error is swallowed.

    On the local mesh (`mesh` not a `ProcessMesh`) a time measures one
    device's launches, not the axis's links, so the probe raises."""
    from repro_torch.core.sync import axis_level
    from repro_torch.core.transport import all_gather_rows
    from repro_torch.planner.service import default_service

    if not collectives.is_process_mesh(mesh):
        raise NotImplementedError(
            "observe_sync_probe: timing an axis's schedule needs one "
            "process a rank (a core.transport.ProcessMesh, the process "
            "mesh of ROADMAP §1 item 8), not the local mesh, whose time "
            "measures one device's launches")
    svc = svc or default_service()
    axes = [(a, s) for a, s in (mesh.axes if axes is None else axes)
            if int(s) > 1]
    everyone = mesh.line(mesh.axis_names)
    dev = mesh.device
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    staged = mesh.transport != mesh.backend
    source = "host_staged" if staged else "mesh"
    big = max(float(size_floats or 65536.0), 4.0)
    out = []
    for i, (a, n) in enumerate(axes):
        for size in (big, big / 4.0):
            resp = svc.get_axis_executable(a, int(n), size,
                                           level=axis_level(i))
            sched = resp.schedule
            probe = torch.ones(max(int(size), 1), dtype=torch.float32,
                               device=dev)
            sched.allreduce(probe, a, mesh)
            sync()
            ts = []
            for _ in range(repeats):
                all_gather_rows(mesh, everyone, probe[:1])
                t0 = time.perf_counter()
                sched.allreduce(probe, a, mesh)
                sync()
                ts.append(time.perf_counter() - t0)
            mine = torch.tensor(sorted(ts)[len(ts) // 2],
                                dtype=torch.float64, device=dev)
            measured = float(all_gather_rows(mesh, everyone, mine).max())
            obs = svc.observe(axis_level(i), int(n), size, measured,
                              key=resp.key, source=source)
            out.append(obs)
            on_log(f"planner: axis {a} sync probe ({int(size)} floats, "
                   f"{mesh.transport}) {measured * 1e3:.3f} ms (predicted "
                   f"{obs['predicted'] * 1e3:.3f} ms, drift "
                   f"{obs['drift']:.2f}" + (", refit" if obs["refit"]
                                            else "") + ")")
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainConfig:
    arch: str = "stablelm-12b"
    steps: int = 50
    seq_len: int = 128
    global_batch: int = 8
    engine: str = "auto"            # auto (the reference's default) | manual
    sync: str = "auto"         # auto|psum|ring|rhd|cps|hcps|gentree|plan
    # backward-overlapped bucket issuance (DESIGN.md §15): the gradient
    # buckets reduce last first; False keeps forward order
    backward_overlap: bool = True
    lr: float = 1e-3
    # checkpoint directory: the run goes through FaultTolerantLoop,
    # saving every ckpt_every steps and resuming from the newest
    ckpt_dir: str | None = None
    ckpt_every: int = 25
    seed: int = 0
    log_every: int = 10
    # the reference probes the schedule after training and feeds the
    # planner; on a process mesh the probe runs (observe_sync_probe), on
    # the local mesh a time measures one card, so it is off here and True
    # raises
    observe_sync: bool = False
    # export a Chrome trace of the run's spans / the metrics registry
    trace_path: str | None = None
    metrics_path: str | None = None
    # chaos mode (DESIGN.md §12): a `FaultPlan.parse` spec string (e.g.
    # "seed=7,steps=200,link_degrade=0.01,payload_corrupt=0.05") arms a
    # deterministic fault injector for the run; None defers to any
    # $REPRO_FAULT_PLAN / surrounding FaultInjector context
    fault_plan: str | None = None
    # ranks of the local mesh: the leading axis of every shard tensor
    local_ranks: int = 8
    device: str = "cuda"
    # the model's depth, cut from the configuration's (None: as it is);
    # the widths stay
    n_layers: int | None = None
    # the "plan" sync's bucket (SyncConfig.bucket_bytes): None lets
    # GenModel pick it, 0 runs the per-leaf path
    bucket_bytes: int | None = None


ENGINES = ("auto", "manual")


def _check_train_scope(tc: TrainConfig, mesh=None) -> None:
    if tc.engine not in ENGINES:
        raise ValueError(f"unknown engine {tc.engine!r}; one of {ENGINES}")
    from repro_torch.core.sync import SYNC_STRATEGIES
    if tc.sync not in SYNC_STRATEGIES:
        raise ValueError(f"unknown sync strategy {tc.sync!r}; one of "
                         f"{SYNC_STRATEGIES}")
    if tc.engine == "auto":
        # the auto engine syncs by torch.distributed alone: no probe
        _auto_mesh(mesh)
        return
    pm = collectives.is_process_mesh(mesh)
    if tc.observe_sync and not pm:
        observe_sync_probe(None, mesh)


def run_training(tc: TrainConfig, smoke: bool = True, on_log=print,
                 mesh=None) -> dict:
    """Train `tc.arch` (smoke-shrunk unless `smoke` is False; its depth cut
    to `tc.n_layers` when set) from random bf16 weights for `tc.steps`
    steps with the engine `tc.engine`.

    "auto" (the reference's default): `make_train_step` on one device,
    `tc.device`, where `mesh` is None; or with `mesh` this rank's
    `core.transport.ProcessMesh` (one process a rank, on the mesh's
    device), its parameters and moments DTensors at the reference's
    FSDP placements. A local mesh (an int or (axis, size) pairs) raises
    ValueError: the auto engine's ranks are processes.

    "manual": the ZeRO-3 engine on the local mesh `mesh` on `tc.device`
    (the reference's `mesh=`: (axis, size) pairs such as [("pod", 2),
    ("data", 4)], or an int; None is one axis of `tc.local_ranks`
    ranks; or this rank's `ProcessMesh`, its state this rank's shards
    and with `tc.observe_sync` probing each axis after training), with
    the reference's sync, `SyncConfig(strategy=tc.sync, bucket_bytes=
    tc.bucket_bytes, backward_overlap=tc.backward_overlap)`: for "plan"
    bucketed on one live axis, GenModel picking the bucket unless
    `tc.bucket_bytes` is set, per leaf on several; per leaf for the
    other labels.

    With `tc.ckpt_dir` the steps run in a `FaultTolerantLoop` (the
    reference's `run_training`): a checkpoint (`keep=2`) every
    `tc.ckpt_every` steps and at the end, restore-and-replay on a failed
    step, resumption from the directory's newest checkpoint. On a
    process mesh each rank writes its own member of every checkpoint
    (the auto engine's: its DTensors' local tensors). The restore
    overwrites the state's tensors in place, so it allocates no second
    state on the device. `tc.fault_plan` arms a `FaultInjector` over the
    run (else an injector the caller entered, or $REPRO_FAULT_PLAN, is
    the one consulted). Without a checkpoint directory an injected or
    real failure ends the run with its error.

    Returns the state; per `one_step` call, replays included (the
    reference's meaning), the loss, gnorm, host-clock step time (ending
    in the loss's copy to the host), device times of `PHASES` on a card,
    and the step index it ran (`steps`); the axis plans and the bucket
    plan (the manual engine's; none under "auto"), the step function,
    the model config, and with a checkpoint directory the loop and its
    `CheckpointManager` (`ckpt`: `last_save` / `last_restore`; else both
    None)."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.runtime.metrics import default_metrics

    _check_train_scope(tc, mesh)
    pm = collectives.is_process_mesh(mesh)
    dev = mesh.device if pm else resolve_device(tc.device)
    cfg = get_config(tc.arch)
    if smoke:
        cfg = smoke_config(cfg)
    if tc.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(tc.n_layers))
    api = build(cfg)
    auto = tc.engine == "auto"
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    if auto:
        step_fn, _, _ = make_train_step(api, mesh, AdamWConfig(lr=tc.lr),
                                        device=dev)
        on_log(_auto_line(step_fn, mesh))
        state = place_state(api.init_params(gen, torch.bfloat16, dev), mesh,
                            step_fn.placements)
    else:
        mesh = int(tc.local_ranks) if mesh is None else mesh
        step_fn = _manual_step(tc, api, mesh, dev, on_log)
        shards = shard_params_zero3(api.init_params(gen, torch.bfloat16,
                                                    dev), mesh)
        state = {"params": shards, "opt": adamw_init(shards)}
    # what the loop steps, checkpoints and restores in place: over
    # processes the auto engine's DTensors' local tensors
    loop_state = local_state(state) if auto and pm else state
    data = SyntheticLM(data_config(cfg, tc.seq_len, tc.global_batch,
                                   tc.seed))

    tracer = default_tracer()
    if tc.trace_path:
        tracer.enabled = True
    step_hist = default_metrics().histogram(
        "train_step_seconds", "wall time per training step",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))

    losses, gnorms, step_s, phases, steps = [], [], [], [], []

    def one_step(st: dict, s: int) -> dict:
        t0 = time.perf_counter()
        with tracer.span("train/step", step=s):
            # the auto engine steps `state`, whose tensors `st` holds
            # (over processes its DTensors' local tensors)
            _, metrics = step_fn(state if auto else st,
                                 batch_tensors(data.batch_at(s), dev))
            loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        dt = time.perf_counter() - t0
        step_hist.observe(dt)
        losses.append(loss)
        gnorms.append(gnorm)
        step_s.append(dt)
        phases.append(phase_ms(metrics))
        steps.append(s)
        if s % tc.log_every == 0:
            on_log(f"step {s:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}")
        return st

    injector = None
    inj_scope = contextlib.nullcontext()
    if tc.fault_plan:
        from repro_torch.runtime.faults import FaultInjector, FaultPlan
        injector = FaultInjector(FaultPlan.parse(tc.fault_plan))
        # entering the scope arms the process-global injector, so the
        # guarded launches see the payload-corruption events too
        inj_scope = injector
        on_log(f"chaos: armed fault plan {injector.plan.key()} "
               f"({len(injector.plan.events)} events)")
    from repro_torch.planner.service import default_service
    loop = mgr = None
    if tc.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.runtime.ft import FaultTolerantLoop

        def on_event(kind: str, info: dict) -> None:
            if kind in ("failure", "resume", "ckpt_corrupt", "degrade",
                        "restore", "budget_reset"):
                on_log(f"ft: {kind} {info}")

        mgr = CheckpointManager(tc.ckpt_dir, keep=2,
                                mesh=mesh if pm else None)
        # the planner takes the injected link faults into its health map
        loop = FaultTolerantLoop(
            one_step, loop_state, mgr, ckpt_every=tc.ckpt_every,
            planner=default_service() if not auto
            and tc.sync in ("gentree", "plan") else None,
            injector=injector, on_event=on_event)
        with inj_scope:
            final = loop.run(tc.steps)
        if not (auto and pm):
            # a restore gives the loop a new tree of the same tensors
            # (the manual step replaces its "step" leaf each step)
            state = final
        on_log(f"checkpoint: {_ckpt_line(mgr)}")
    else:
        with inj_scope:
            for s in range(tc.steps):
                one_step(loop_state, s)
    if injector is not None:
        on_log(f"chaos: injector fired {injector.stats()['fired']}")
    if not auto:
        if pm and tc.observe_sync and tc.sync == "plan" and step_fn.mesh:
            observe_sync_probe(default_service(), mesh, step_fn.mesh, min(
                sum(float(x.numel()) for x in state["params"]) or 1.0,
                65536.0), on_log)
        st = default_service().stats()
        cs = st["cache"]
        on_log(f"planner cache: {st['entries']} entries, {cs['hits']} hits"
               f" / {cs['misses']} misses"
               + (f", {cs['disk_loads']} loaded from disk"
                  if cs["disk_loads"] else ""))
    if tc.trace_path:
        tracer.export_chrome(tc.trace_path)
        on_log(f"trace: {len(tracer.spans)} spans -> {tc.trace_path}")
    if tc.metrics_path:
        default_metrics().export(tc.metrics_path)
        on_log(f"metrics -> {tc.metrics_path}")
    return {"state": state, "losses": losses, "gnorms": gnorms,
            "step_s": step_s, "phase_ms": phases, "steps": steps,
            "plans": [] if auto else step_fn.plans,
            "bucket_plan": None if auto else step_fn.bucket_plan,
            "step": step_fn, "config": cfg, "loop": loop, "ckpt": mgr}


def _manual_step(tc: TrainConfig, api: ModelAPI, mesh, dev, on_log):
    """The manual engine's step of `run_training`, its plans logged."""
    step_fn = make_manual_train_step(
        api, mesh, AdamWConfig(lr=tc.lr),
        sync=SyncConfig(strategy=tc.sync, bucket_bytes=tc.bucket_bytes,
                        backward_overlap=tc.backward_overlap), device=dev)
    bp = step_fn.bucket_plan
    if bp is not None:
        on_log(f"planner: bucket plan {bp.bucket_bytes} bytes, "
               f"{len(step_fn.scatter_buckets)} gradient bucket(s), "
               f"{bp.overlap.get('mode', 'sequential')} issuance, "
               f"{bp.precision}, predicted {bp.predicted_contended * 1e3:.3f}"
               f" ms; {bp.axis_plans[0].schedule.describe()}")
    else:
        on_log("planner: per-leaf sync, " + "; ".join(
            pl.schedule.describe() if pl.strategy == "plan"
            else f"axis {pl.axis} {pl.strategy}"
            + (f" factors {pl.factors}" if pl.factors else "")
            for pl in step_fn.plans))
    if step_fn.ep is not None:
        cs = step_fn.ep_schedule
        on_log(f"planner: expert-parallel over axis {step_fn.ep[0]} "
               f"({step_fn.ep[1]} ranks, "
               f"{api.cfg.n_experts // step_fn.ep[1]} "
               "routed experts a rank), exchange "
               + (cs.describe() if cs is not None else "flat copy"))
    return step_fn


def _auto_line(step_fn, mesh) -> str:
    """The log line of the auto engine's layout."""
    from torch.distributed.tensor import Shard
    if mesh is None:
        return (f"auto engine: one device ({step_fn.device}), every "
                "placement Replicate")
    pls = step_fn.placements
    sharded = sum(any(isinstance(p, Shard) for p in pl)
                  for pl in pls["params"])
    moments = sum(any(isinstance(p, Shard) for p in pl)
                  for pl in pls["opt"]["m"])
    line = (f"auto engine: DTensor placements over {list(mesh.axes)} "
            f"({mesh.transport}): {sharded} of {len(pls['params'])} "
            f"parameter leaves and {moments} moment leaves sharded; "
            "collectives by torch.distributed")
    names = [a for a, _ in mesh.axes]
    if dict(mesh.axes).get("model", 1) > 1:
        tp = sum(isinstance(pl[names.index("model")], Shard)
                 for pl in pls["params"])
        line += (f"; {tp} leaves tensor-parallel on 'model', its line's "
                 "exchanges by core.transport")
    return line


def _ckpt_line(mgr) -> str:
    """The latest save's and restore's bytes and times, for the log."""
    sv, rs = mgr.last_save, mgr.last_restore
    gb = sv.get("bytes", 0) / 1e9
    line = (f"step {sv.get('step')} {gb:.3f} GB, host snapshot "
            f"{sv.get('snapshot_s', 0.0):.3f} s, write + CRC "
            f"{sv.get('write_s', 0.0):.3f} s")
    if rs:
        line += (f"; last restore step {rs['step']}: checksums "
                 f"{rs.get('verify_s', 0.0):.3f} s, read "
                 f"{rs['read_s']:.3f} s, to the device {rs['copy_s']:.3f} s")
    return line


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--engine", default="auto", choices=ENGINES)
    ap.add_argument("--sync", default="auto",
                    choices=["auto", "psum", "ring", "rhd", "cps", "hcps",
                             "gentree", "plan"])
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and run the fault-tolerant loop "
                    "(resumes from the newest checkpoint in it)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome-trace JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="export a metrics snapshot (JSON + .prom)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm a fault plan, e.g. seed=7,steps=12,"
                    "device_loss=0.1 (runtime.faults.FaultPlan.parse)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="train the smoke-size config (the reference's "
                    "run_training default)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="train with one process a rank over this many "
                    "ranks (a process mesh, axis 'data') instead of the "
                    "local mesh")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the process mesh's backend: nccl (one card a "
                    "rank), or gloo (on the CPU, or every rank on one "
                    "card, its rounds staged through the host)")
    args = ap.parse_args()
    tc = TrainConfig(
        arch=args.arch, steps=args.steps, engine=args.engine,
        sync=args.sync, seq_len=args.seq_len, global_batch=args.batch,
        ckpt_dir=args.ckpt_dir, trace_path=args.trace,
        metrics_path=args.metrics, fault_plan=args.faults,
        device=args.device)
    if args.nproc is not None:
        from repro_torch.launch.mesh import launch
        print(f"process mesh: {args.nproc} processes, backend "
              f"{args.backend}, device {args.device}", flush=True)
        losses = launch(_train_rank, [("data", args.nproc)],
                        backend=args.backend, device=args.device,
                        timeout_s=CLI_MESH_TIMEOUT_S,
                        args=(tc, args.smoke))[0]
    else:
        losses = run_training(tc, smoke=args.smoke)["losses"]
    print(f"final loss: {losses[-1]:.4f}")


def _train_rank(mesh, tc: TrainConfig, smoke: bool) -> list[float]:
    """One rank of `main`'s process mesh: `run_training` on it, rank 0
    logging; returns the losses."""
    def quiet(_msg):
        pass
    out = run_training(tc, smoke=smoke, mesh=mesh,
                       on_log=(lambda m: print(m, flush=True))
                       if mesh.rank == 0 else quiet)
    return out["losses"]


if __name__ == "__main__":
    main()
