"""AdamW with decoupled weight decay and global-norm clipping.

The reference's `optim/adamw.py` over lists of tensors, the leaves of a
parameter tree in one fixed order (the trainer's: the reference's
`jax.tree` order). Optimizer state (m, v) is kept in f32 whatever the
parameters' dtype, and the update runs the reference's f32 operations
in its order, so the same inputs give the same result to f32 rounding.
The list order fixes the order of the global norm's sum. ZeRO
partitioning is the caller's concern: the manual trainer calls
`adamw_update` once per rank on that rank's shards.

`global_norm` and `clip_by_global_norm` also take `torch.distributed`
DTensor leaves (the auto engine's gradients, `launch.train.
make_train_step`): the norm is the whole tree's, each element counted
once, and the clipped leaves keep their placements. The update itself is
elementwise; the auto engine runs it on each leaf's local shard.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

Leaves = Sequence[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Leaves) -> dict:
    """{"m", "v": f32 zeros like each leaf, "step": int32 0}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": [zeros(p) for p in params],
            "v": [zeros(p) for p in params],
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device)}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (sharing its storage); a tensor as it is."""
    return x.to_local() if _is_dtensor(x) else x


def _like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t`, a local tensor, at `ref`'s placements where `ref` is a
    DTensor."""
    if not _is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _owned(x) -> bool:
    """Whether this rank counts a DTensor's local elements in a sum over
    the mesh: it does unless it is not the first of the ranks a
    `Replicate` mesh dimension copies them to."""
    from torch.distributed.tensor import Replicate
    coords = x.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coords, x.placements)
               if isinstance(pl, Replicate))


def global_norm(grads: Leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.

    DTensor leaves (one device mesh) count each element once: a rank
    sums the squares of its local elements of the leaves it owns
    (`_owned`: a leaf `Replicate` over a mesh dimension is counted on
    that dimension's first rank alone, not once a copy), and the ranks'
    sums are all-reduced over the mesh by DTensor (a `Partial` scalar
    made `Replicate`). The result, a plain tensor, is the norm of the
    whole tree on every rank."""
    total = None
    for g in grads:
        g_ = _local(g)
        sq = torch.sum(torch.square(g_.float()))
        if _is_dtensor(g) and not _owned(g):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if grads and _is_dtensor(grads[0]):
        from torch.distributed.tensor import DTensor, Partial
        mesh = grads[0].device_mesh
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def clip_by_global_norm(grads: Leaves, max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return [_like(g, (_local(g).float() * scale).to(g.dtype))
            for g in grads], gn


def adamw_update(params: Leaves, grads: Leaves, opt_state: dict,
                 cfg: AdamWConfig, lr: torch.Tensor | float | None = None
                 ) -> tuple[list[torch.Tensor], dict, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm); the inputs are left as
    they are."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = opt_state["step"] + 1
    lr = cfg.lr if lr is None else lr
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        gf = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        return pf.to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, opt_state["m"], opt_state["v"],
                          strict=True):
        a, b, c = upd(p, g, m, v)
        new_p.append(a)
        new_m.append(b)
        new_v.append(c)
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
