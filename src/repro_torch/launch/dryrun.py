"""Dry run on the meta device: the counterpart of the reference's
`launch/dryrun.py`.

The reference lowers and compiles every (architecture × input shape) cell
on a production mesh of placeholder devices and reads the roofline terms
off the compiled HLO. The port runs each cell's own engine on the meta
device instead, where every tensor has its shape and dtype and no values,
under `launch.analysis.census`, which counts the work as it runs:

  * a train shape: one `make_manual_train_step` step (the ZeRO-3 engine,
    `SyncConfig(strategy="plan")`) on a local mesh of `--ranks` ranks at
    the shape's global batch;
  * a prefill shape: `prefill` of the global batch, on one device;
  * a decode shape: one `decode_step` of the global batch against a cache
    of the shape's sequence length, on one device.

No parameter, cache or activation is allocated, and no card is needed:
the meta device is this entry point's own, by design. There is no
`XLA_FLAGS` and no production mesh: the train cells' mesh is the local
mesh of `--ranks` ranks, the serve cells' one device.

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all --json out.json

Each cell's result has the reference's keys (`hlo_flops`, `hlo_bytes`,
`coll_bytes`, `coll_by_kind`, `coll_counts`, `compute_s`, `memory_s`,
`collective_s`, `dominant`, `model_flops`, `useful_ratio`,
`roofline_fraction`, `bytes_per_device`), read from the census: FLOPs,
HBM bytes and collective bytes totalled over the cell's chips (the train
mesh's ranks, or 1), the roofline terms at the H100's data-sheet rates
(`launch.analysis`). `bytes_per_device` is the arguments a rank holds
(its ZeRO-3 shards and AdamW moments and its rows of the batch; a serve
cell's parameters, cache and batch) plus the census's peak live bytes
over the chips. Cells `configs.supported_shapes` leaves out are recorded
as documented skips unless `--include-skips` runs them too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs import ARCHS, canon, get_config, supported_shapes
from repro_torch.launch import analysis as ha
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import build

# the knobs of the reference's `lower_cell` that need its single-program
# sharded engine on the dry run's train cells, which run the manual
# engine on the meta device here
NEEDS_AUTO_ENGINE = ("zero1", "seqpar")


def apply_variants(cfg, variants):
    """The reference's dry-run knobs on `cfg`: kvblock=N (the KV-block
    attention scan), moegroups=N, moelocal. zero1 and seqpar raise:
    they need the auto engine's train cells on the meta device (ROADMAP
    §1 item 8f)."""
    for v in variants:
        if v.startswith("kvblock="):
            cfg = dataclasses.replace(cfg, attn_kv_block=int(v.split("=")[1]))
        elif v.startswith("moegroups="):
            cfg = dataclasses.replace(cfg, moe_groups=int(v.split("=")[1]))
        elif v == "moelocal":
            cfg = dataclasses.replace(cfg, moe_local=True)
        elif v in NEEDS_AUTO_ENGINE:
            raise NotImplementedError(
                f"variant {v!r} needs the auto engine's train cells on the "
                "meta device, where the dry run runs the manual engine "
                "(ROADMAP §1 item 8f)")
        elif v:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


def run_cell(arch: str, shape_name: str, *, ranks: int = 8,
             variants: tuple[str, ...] = ()) -> dict:
    """Run one cell on the meta device under a census; its result dict
    (the module docstring's keys, and `arch`, `shape`, `kind`, `chips`,
    `run_s`, `kernels`: {kernel: [calls, flops, bytes]})."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch.train import (make_manual_train_step,
                                          shard_params_zero3)
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = apply_variants(get_config(arch), variants)
    api = build(cfg)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    if shape.kind == "train":
        chips = int(ranks)
        step = make_manual_train_step(api, chips, AdamWConfig(),
                                      sync=SyncConfig(strategy="plan"),
                                      device="meta")
        shards = shard_params_zero3(api.params_spec(), chips)
        state = {"params": shards, "opt": adamw_init(shards)}
        batch = api.train_specs(shape)
        args = ha.tensor_bytes((state, batch))
        with ha.census(chips) as c:
            step(state, batch)
        mf = ha.model_flops_train(cfg, shape.global_batch * shape.seq_len)
    else:
        chips = 1
        params = api.meta_params()
        if shape.kind == "prefill":
            batch = api.prefill_specs(shape)
            args = ha.tensor_bytes((params, batch))
            with ha.census(1) as c:
                api.prefill(params, batch, cache_len=shape.seq_len)
            mf = ha.model_flops_forward(cfg,
                                        shape.global_batch * shape.seq_len)
        else:
            spec = api.decode_specs(shape)
            args = ha.tensor_bytes((params, spec))
            with ha.census(1) as c:
                api.decode_step(params, spec["cache"], spec["batch"])
            mf = ha.model_flops_forward(cfg, shape.global_batch)
    stats = c.stats()
    rl = ha.roofline_from_stats(stats, chips, model_flops=mf)
    return {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "chips": chips, "run_s": time.perf_counter() - t0,
            "hlo_flops": rl.flops, "hlo_bytes": rl.hbm_bytes,
            "coll_bytes": rl.coll_bytes, "coll_by_kind": rl.coll_by_kind,
            "coll_counts": stats.coll_counts,
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "model_flops": mf, "useful_ratio": rl.useful_ratio,
            "roofline_fraction": rl.roofline_fraction,
            "bytes_per_device": (args + c.peak_bytes) / chips,
            "kernels": {k: list(v) for k, v in c.kernel_work().items()}}


def cell_line(r: dict) -> str:
    return (f"[ ok ] {r['arch']} × {r['shape']}: "
            f"flops={r['hlo_flops']:.3e} bytes={r['hlo_bytes']:.3e} "
            f"coll={r['coll_bytes']:.3e} dom={r['dominant']} "
            f"t_comp={r['compute_s'] * 1e3:.2f}ms "
            f"t_mem={r['memory_s'] * 1e3:.2f}ms "
            f"t_coll={r['collective_s'] * 1e3:.2f}ms "
            f"roofline={r['roofline_fraction']:.3f} "
            f"mem/dev={r['bytes_per_device'] / 2**30:.1f}GiB "
            f"(run {r['run_s']:.1f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run each (arch × shape) cell on the meta device (by "
        "design: shapes and dtypes, no values, no card) under the census "
        "and print its roofline terms.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--include-skips", action="store_true",
                    help="also run the cells the configuration does not "
                    "support (recorded with unsupported: true)")
    ap.add_argument("--variants", default="",
                    help="comma-separated knobs: kvblock=N, moegroups=N, "
                    "moelocal (zero1 and seqpar need the auto engine)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of the train cells' local mesh")
    args = ap.parse_args(argv)
    variants = tuple(v for v in args.variants.split(",") if v)
    print(f"device: meta; train mesh: ('data', {args.ranks})")

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(canon(args.arch), args.shape)]

    results = []
    failed = 0
    for arch, shape in cells:
        supported = shape in supported_shapes(arch)
        if not supported and not args.include_skips:
            results.append({"arch": arch, "shape": shape,
                            "skipped": "unsupported (DESIGN.md "
                            "§Arch-applicability)"})
            print(f"[skip] {arch} × {shape} — documented skip")
            continue
        try:
            r = run_cell(arch, shape, ranks=args.ranks, variants=variants)
            if not supported:
                r["unsupported"] = True
            results.append(r)
            print(cell_line(r), flush=True)
        except Exception as e:
            failed += 1
            results.append({"arch": arch, "shape": shape, "error": repr(e)})
            print(f"[FAIL] {arch} × {shape}: {e!r}", flush=True)
            traceback.print_exc()

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": "meta", "ranks": args.ranks,
                       "variants": list(variants), "results": results}, f,
                      indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
