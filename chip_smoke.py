#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --attention [--src OTHER/src]
    python3 chip_smoke.py --recurrence [--src OTHER/src]

The second and third forms build the kernels and run the attention rows
or the recurrence rows of phase 2 alone (of another source tree with
--src: two commits timed on one card in turn), and print no result line.
Phases, each of which fails the run (non-zero exit, no result line) on
any error:

  1. build    — compile every CUDA kernel from `src/repro_torch/kernels/
                csrc` (one nvcc per source, all at once);
  2. kernels  — each kernel against its plain PyTorch version on the card,
                over a grid of shapes, in the dense form (the TPU
                kernel's shape) and the gathered form the executor folds
                with, with its time (CUDA events), its bound (bytes over
                the memory rate or operations over the peak rate of
                their type, the larger) and one PyTorch yardstick call
                where one computes the same function. The reduce,
                quantize and dequantize kernels (fused_reduce and
                grouped_reduce — the tree of fan_in-ary adds — over
                KERNEL_LANES; quantize, dequantize, quant_reduce and
                quant_reduce_requant over KERNEL_LANES; the gathered
                fused_reduce, quant_reduce and dequantize over
                INTO_LANES) must agree bit for bit; the others
                (wkv, ssm_scan, rmsnorm, flash_attention), whose plain
                versions reduce in another order, within TOLERANCE of
                the largest |value| of each output (of each query row's
                output for attention): 1e-5 for an f32 output, 2^-8 (one
                bf16 rounding) for a bf16 one, held against the plain
                version on the same inputs widened to f32; two
                recurrence calls over a sequence cut in two (halves of
                32 tokens; 17 and 23), the state handed over, must equal
                one call. The recurrences run at the served prefill and
                decode shapes and at their kernels' edges (batch 1; T
                1, 7, 33, 40, 65; V off a warp's column slice; K 32,
                33; Di off the channel block; N 1, 3, 32, 64; widths off
                the 16-byte path). Attention runs
                at the four models' prefill and decode shapes (ragged
                per-row key counts at decode), the smoke widths in f32,
                and gemma2-27b's long request (prefill of 4,352 tokens,
                decode against 4,360 of 4,416 cache slots, the 4096
                window masking), the decode kernel at long context
                (stablelm-12b's heads without a softcap, so SDPA times
                the same function; a batch of four rows of 4,360, 0,
                300 and 4,416 keys; four queries a head in f32 and
                bf16), the f32 prefill kernel past one block of query
                rows, and the bf16 prefill kernel's edges (Tq 5, 17, 33,
                129, 130; head dims 64 to 256; groups 1, 4, 5; a row
                that sees no key; windows narrower than a key tile);
                rmsnorm at 4·32 rows of every model's width, both
                offsets, every dtype pair, over the long prefill's 4,352
                rows, at widths on and off its 16-byte path (1000, 1001)
                and on misaligned last-token rows;
  3. executor — GenTree plans from the planner, lowered and run with
                `run_local` on an 8-rank local mesh (a single switch and
                the two-level tree), decode-sized and gradient-sized, in
                f32 and every compressed wire, checked against the column
                sum (f32 at 1e-6, wires within their error budget), with
                device time (CUDA events), wall time (host clock to a
                synchronize) and two bounds: the schedule's (every
                round's and fold's rows crossing memory once) and the
                function's (input read and output written once); folds
                launch fused_reduce (f32, bf16 wire) or quant_reduce
                (fp8/int8), the AllGather half's landings on fp8/int8
                dequantize, the rounds quantize;
  3b. families — the planner's reduce-scatter, all-gather, all-to-all and
                p2p schedules (`get_family_executable` on the same two
                topologies, the same sizes a rank) through `with_wire`,
                `guard_schedule` and the `run_local_*` entry points, in
                f32 and every wire, checked against the exact answer
                (the shard of the column sum at 1e-6, the concatenation,
                the chunk transpose and the edges exactly in f32; wires
                within their budget), with device time, wall time and
                the schedule's byte bound; every landing on fp8/int8
                launches dequantize;
  4. serve    — `repro_torch.launch.serve` on stablelm-12b, rwkv6-1.6b,
                hymba-1.5b and gemma2-27b in turn, each at full size
                (random bf16 weights), batch 4, prompt 32, 32 new tokens,
                cache 128, 8 local ranks; after each, a few decode steps
                of the same model under torch.profiler (device busy
                share, kernels per step, weight-read bound); then one
                long gemma2-27b request (batch 1, prompt 4,352, 8 new
                tokens, cache 4,416), so the local layers' 4096 window
                masks in prefill and decode; each model is freed before
                the next; then each model's smoke-size version in f32 on
                the card against the same code on the CPU (gemma2-27b on
                a 48-token prompt, longer than its smoke window);
  5. train    — the ZeRO-3 trainer (`repro_torch.launch.train.
                make_manual_train_step`, 8 local ranks) on stablelm-12b
                at full width, its depth cut to 2 layers (TRAIN), random
                bf16 weights, seq 128, global batch 8, 3 steps: per leaf
                (`SyncConfig(strategy="plan", bucket_bytes=0)`) at the
                reference's lr 1e-3 and again at each of TRAIN_FALL_LRS;
                then bucketed at the first of TRAIN_FALL_LRS, (a) at the
                reference's default plan (`SyncConfig(strategy="plan")`:
                GenModel picks the bucket, which must be one bucket a
                half) and (b) with bucket_bytes pinned to
                TRAIN_BUCKET_BYTES (10 buckets, reduced last first on
                every step, read from the tracer's spans). Each run:
                finite losses and gnorms, falling at TRAIN_FALL_LRS, the
                gathered rows equal on every step, the exact fused_reduce
                launches (one per fold phase of each all-gather and
                reduce-scatter: a leaf each per leaf, a bucket each
                bucketed) and no other kernel, no guard failure, the plan
                (the bucket plan and its sweep's cheapest rows), the step
                time (host clock), its split over gather, forward and
                backward, reduce-scatter and AdamW (CUDA events) beside
                their bounds, the collectives against the schedule's byte
                bound, the peak memory. Then fused_reduce at the
                trainer's gradient shapes against its plain version and
                torch.sum; (c) `sync_bucketed` on the card over the smoke
                trainer's leaves and 2^26 f32 a rank in 8 leaves, f32 and
                the bf16, fp8 and int8 wires, default and pinned buckets,
                pipeline on and off, and a `MergedSchedule` run directly,
                against the column sum (f32 within 1e-6, wires within
                their budget) with the exact launches of fused_reduce,
                quantize, quant_reduce and dequantize; and (d) the
                trainer at smoke size in f32 on the card against the same
                code on the CPU, per leaf and bucketed at
                TRAIN_SMOKE_BUCKET_BYTES (per-step loss and gnorm within
                1e-4, the final shards as `shard_drift` says).

The main path is phases 3, 3b, 4 and 5: every launch count is zeroed
just before the executor, the families, each served run, each
full-width training run and the `sync_bucketed` runs, and read just
after. The executor must launch fused_reduce, quantize, quant_reduce and
dequantize (it runs the compressed wires), the families dequantize;
grouped_reduce and quant_reduce_requant have no caller on the main path
(nor in the JAX package) and show 0 launches, timed in phase 2 at their
2^26 shape; every served run must launch fused_reduce (the
decode AllReduce folds through it) and exactly the model kernels its
forwards (prefill and each decode step) run: rmsnorm once per norm (2 a
dense layer, 3 an RWKV6 layer, 4 a Hymba layer, and the final norm),
flash_attention once per attention layer, wkv once per RWKV6 layer and
ssm_scan once per Hymba layer (`expected_launches`), and each
flash_attention launch on the CUDA kernel its shape selects (the
prompt's on the bf16 prefill kernel, each decode step's on the decode
kernel, `ops.ATTENTION_LAUNCHES`); each training run must launch
fused_reduce exactly steps × (its all-gathers × the all-gather's fold
phases + its reduce-scatters × the reduce-scatter's) and no other
kernel (the training forward runs torch ops, as the
reference's runs XLA ops), with no guard demotion or failure anywhere (the guard raises rather than demote, so a
failure ends the run). The last lines are the per-kernel JSON (launches
on the main path; time, plain time, bound and yardstick of the wrapper
call of the kernel's first launch in phase 4, or in phase 3 or 3b for a
kernel phase 4 does not launch, or phase 2's 2^26 case for one the main
path never launches), the card's name and power limit, and
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
SPIN_HZ = 1.98e9                 # H100 SXM boost clock: spin cycles per s
KERNEL_LANES = (1000, 20480, 1 << 26)                 # phase 2 grid
INTO_LANES = (2560, 1 << 23)                # phase 2, gathered forms
EXEC_SIZES = ((4 * 5120, "decode 4x5120"), (1 << 26, "gradient 2^26"))
FAMILIES = ("reduce_scatter", "allgather", "all_to_all", "p2p")
SERVE = dict(batch=4, prompt_len=32, max_new=32, cache_len=128,
             local_ranks=8)
SERVE_ARCHS = ("stablelm-12b", "rwkv6-1.6b", "hymba-1.5b", "gemma2-27b")
# one long request after the batch: its prompt is longer than gemma2-27b's
# 4096 window, so the local layers mask in prefill and decode
LONG = dict(arch="gemma2-27b", batch=1, prompt_len=4352, max_new=8,
            cache_len=4416, local_ranks=8)
# per family, what one forward launches per layer: its norms (ln1 and
# ln2; RWKV6 adds ln_x, Hymba ln_attn and ln_ssm), its attention and its
# recurrence kernel; the final norm comes on top
NORMS_PER_LAYER = {"dense": 2, "ssm": 3, "hybrid": 4}
ATTENTION_PER_LAYER = {"dense": 1, "ssm": 0, "hybrid": 1}
RECURRENCE = {"ssm": "wkv", "hybrid": "ssm_scan"}
PROFILE_STEPS = 4                # decode steps traced after serving
# (batch, prompt, cache) of the smoke-size model held card against CPU
REFERENCE_RUN = {"gemma2-27b": (2, 48, 64)}
# the trainer: stablelm-12b at full width with its depth cut from 40 to 2
# layers (the one cut), 8 local ranks, the reference TrainConfig's
# sequence, global batch and lr; then the same run at each lr of
# TRAIN_FALL_LRS, over which the loss must fall
TRAIN = dict(arch="stablelm-12b", layers=2, steps=3, seq_len=128,
             global_batch=8, lr=1e-3, local_ranks=8)
TRAIN_FALL_LRS = (1e-4,)
TRAIN_SMOKE_STEPS = 3            # smoke-size f32 steps, card against CPU
# the bucketed trainer's pinned bucket: 10 buckets of the full-width leaves
TRAIN_BUCKET_BYTES = 64 << 20
TRAIN_SMOKE_BUCKET_BYTES = 32768  # 10 buckets of the smoke-size leaves
# sync_bucketed's leaves beside the trainer's smoke-size ones: 2^26 f32
# a rank in 8 leaves; and the pinned bucket bytes of its merged runs
SYNC_BIG = ("2^26 f32 a rank in 8 leaves", [(1 << 23,)] * 8)
SYNC_MERGED = {"trainer smoke leaves": 4096, SYNC_BIG[0]: 64 << 20}
# largest disagreement a kernel may show with its plain version: 0 = bit
# for bit; otherwise a share of the largest |value| of each output (for
# flash_attention, of each query row's output), by output dtype where the
# kernel writes f32 or bf16 (a bf16 output is one rounding of the f32
# result: 2^-8 of the largest |value|)
TOLERANCE = {"fused_reduce": 0.0, "grouped_reduce": 0.0, "quantize": 0.0,
             "dequantize": 0.0, "quant_reduce": 0.0,
             "quant_reduce_requant": 0.0, "wkv": 1e-5, "ssm_scan": 1e-5,
             "rmsnorm": {"float32": 1e-5, "bfloat16": 2.0 ** -8},
             "flash_attention": {"float32": 1e-5, "bfloat16": 2.0 ** -8}}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def host_ms(fn, *, calls: int = 3) -> float:
    """Median wall time of one call of `fn` ending in a device
    synchronize, in ms: what a caller waits for."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, *, launches: int = 10, blocks: int = 5) -> float:
    """Median device time of one call of `fn`, in ms. Each block enqueues
    `launches` calls behind a spin kernel that keeps the card busy while
    the host enqueues, so the two CUDA events bracket device work only.
    The spin lasts twice the host's enqueue time for the block, measured
    first (at least 10 ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(max(2 * launches * enqueue_s, 0.01) * SPIN_HZ)
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a, b) -> float:
    """Largest |a − b|, in f64, 2^26 elements at a time (the trainer's
    fold outputs hold billions; a NaN anywhere is the result)."""
    import torch
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 26
    return float(torch.stack([
        (a[i:i + step].double() - b[i:i + step].double()).abs().max()
        for i in range(0, a.numel(), step)]).max())


def rel_cmp(got, want) -> tuple[float, float]:
    """(largest |difference|, largest |difference| over the largest
    |value|), the worst over the outputs (output and final state)."""
    errs = [(max_abs_err(a, b), float(b.abs().max()))
            for a, b in zip(got, want)]
    return (max(e for e, _ in errs),
            max(e / (m + 1e-30) for e, m in errs))


def tolerance(name: str, r: dict) -> float:
    tol = TOLERANCE[name]
    return tol[r["out_dtype"]] if isinstance(tol, dict) else tol


def within(name: str, r: dict) -> bool:
    """Whether measured result `r` of kernel `name` is within its
    TOLERANCE of the plain version."""
    tol = tolerance(name, r)
    if tol == 0.0:
        return r["max_abs_err"] == 0.0
    return r["max_rel_err"] <= tol


def rel_cmp1(got, want) -> tuple[float, float]:
    return rel_cmp((got,), (want,))


def rel_rows(got, want) -> tuple[float, float]:
    """(largest |difference|, largest |difference| over the largest |value|
    of its row (last dim)): an attention output's rows differ in scale by
    the number of keys they average, so a fault in the small late rows
    of a long sequence must not hide under the first rows' scale."""
    diff = (got.double() - want.double()).abs()
    row = want.double().abs().amax(dim=-1, keepdim=True)
    return float(diff.max()), float((diff / (row + 1e-30)).max())


# ---------------------------------------------------------------------------
# per-kernel cases: inputs, byte counts, plain version, yardstick
# ---------------------------------------------------------------------------
def fused_reduce_case(shape, dtype, dev, seed=0):
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = torch.randn(shape, generator=g, device=dev).to(dtype)
    x, L = shape[-2], shape[-1]
    batch = parts.numel() // (x * L)
    nbytes = (x + 1) * L * batch * parts.element_size()
    return dict(kernel=lambda: ops.fused_reduce(parts),
                plain=lambda: ref.fused_reduce_ref(parts),
                library=lambda: parts.sum(dim=-2), nbytes=nbytes)


def grouped_reduce_case(shape, fan_in, dtype, dev, seed=0):
    """The tree of fan_in-ary adds over (x, L); the yardstick is one f32
    sum over the operand axis."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    parts = torch.randn(shape, generator=g, device=dev).to(dtype)
    x, L = shape
    return dict(kernel=lambda: ops.grouped_reduce(parts, fan_in),
                plain=lambda: ref.grouped_reduce_ref(parts, fan_in),
                library=lambda: parts.float().sum(0),
                nbytes=(x + 1) * L * parts.element_size())


def wire_cmp(a, b):
    """Largest difference of payload bytes and of scales."""
    import torch
    return max(max_abs_err(a[0].view(torch.uint8).int(),
                           b[0].view(torch.uint8).int()),
               max_abs_err(a[1], b[1]))


def quantize_case(shape, wire, dev, seed=0):
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 3.0
    R, L = shape
    nt = -(-L // ref.QUANT_TILE)
    nbytes = R * (4 * L + nt * ref.QUANT_TILE + 4 * nt)
    return dict(kernel=lambda: ops.quantize(x, wire),
                plain=lambda: ref.quantize_ref(x, wire),
                library=None, nbytes=nbytes, cmp=wire_cmp)


def dequantize_case(shape, wire, dev, seed=0):
    """The dense dequantize of a quantized (W, L) tensor to (W, L) f32:
    the payload and scales read once, the result written once."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    W, L = shape
    q, s = ops.quantize(torch.randn(shape, generator=g, device=dev), wire)
    nt = s.shape[1]
    nbytes = W * (nt * ref.QUANT_TILE + 4 * nt + 4 * L)
    return dict(kernel=lambda: ops.dequantize(q, s, out_len=L),
                plain=lambda: ref.dequantize_ref(q, s, out_len=L),
                library=None, nbytes=nbytes)


def quant_reduce_requant_case(q_shape, wire, dev, seed=0):
    """K wire rows (K, Lp) summed and requantized to (Lp,) of the same
    wire: the operands and their scales read once, one row written."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    K, Lp = q_shape
    q, s = ops.quantize(torch.randn(q_shape, generator=g, device=dev), wire)
    nt = Lp // ref.QUANT_TILE
    nbytes = (K + 1) * (Lp + 4 * nt)
    return dict(kernel=lambda: ops.quant_reduce_requant(q, s),
                plain=lambda: ref.quant_reduce_requant_ref(q, s, wire),
                library=None, nbytes=nbytes, cmp=wire_cmp)


def quant_reduce_case(q_shape, wire, own_len, dev, seed=0):
    """q_shape (..., K, Lp); own_len 0 = no resident partial."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    *lead, K, Lp = q_shape
    x = torch.randn((math.prod(lead) * K, Lp), generator=g, device=dev)
    q, s = ops.quantize(x, wire)
    q = q.reshape(q_shape)
    s = s.reshape(*lead, K, -1)
    own = (torch.randn((*lead, own_len), generator=g, device=dev)
           if own_len else None)
    batch = q.numel() // (K * Lp)
    nt = Lp // ref.QUANT_TILE
    nbytes = batch * (K * Lp + 4 * K * nt + 4 * own_len + 4 * Lp)
    return dict(kernel=lambda: ops.quant_reduce(q, s, own),
                plain=lambda: ref.quant_reduce_ref(q, s, own),
                library=None, nbytes=nbytes)


def gathered_tables(B, K, R, n_out, dev, seed=0):
    """Row tables of a gathered launch: operands from rows 0..R-1 with
    one masked (−1) slot per batch row, distinct out rows, every other
    batch row folding its own partial."""
    import numpy as np
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, (B, K))
    rows[np.arange(B), rng.integers(0, K, B)] = -1
    out_rows = rng.permutation(n_out)[:B]
    own_rows = np.where(np.arange(B) % 2 == 0, out_rows, -1)
    return ops.row_table(rows, out_rows, own_rows, dev)


def _live_rows(t) -> int:
    return int((t >= 0).sum())


def _table_bytes(t) -> int:
    """Bytes a gathered launch with RowTable `t` must move besides its
    rows: the three int64 tables."""
    return 8 * (t.rows.numel() + t.out_rows.numel() + t.own_rows.numel())


def fused_reduce_into_case(src_shape, src_dtype, table, out_shape,
                           out_dtype, dev, seed=0):
    """The gathered fused reduce at a main-path launch: fresh random src
    and out of the recorded shapes and dtypes, the recorded row table.
    Kernel and plain version each write into their own copy of out."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn(src_shape, generator=g, device=dev).to(src_dtype)
    out0 = torch.randn(out_shape, generator=g, device=dev).to(out_dtype)
    outs = {"kernel": out0.clone(), "plain": out0.clone()}
    L = src_shape[-1]
    nbytes = (_live_rows(table.rows) * L * src.element_size()
              + (_live_rows(table.own_rows) + table.out_rows.numel()) * L
              * out0.element_size() + _table_bytes(table))

    def kernel():
        ops.fused_reduce_into(src, table, outs["kernel"])
        return outs["kernel"]

    def plain():
        ref.fused_reduce_into_ref(src, table.rows, outs["plain"],
                                  table.out_rows, table.own_rows)
        return outs["plain"]
    return dict(kernel=kernel, plain=plain, library=None, nbytes=nbytes)


def quant_reduce_into_case(q_shape, wire, table, out_shape, out_dtype, dev,
                           seed=0):
    """The gathered compressed reduce at a main-path launch: a fresh
    quantized payload and out of the recorded shapes, the recorded row
    table."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    R, Lp = q_shape
    q, s = ops.quantize(torch.randn((R, Lp), generator=g, device=dev), wire)
    out0 = torch.randn(out_shape, generator=g, device=dev).to(out_dtype)
    outs = {"kernel": out0.clone(), "plain": out0.clone()}
    L = out_shape[-1]
    nt = Lp // ref.QUANT_TILE
    nbytes = (_live_rows(table.rows) * (Lp + 4 * nt)
              + (_live_rows(table.own_rows) + table.out_rows.numel()) * L
              * out0.element_size() + _table_bytes(table))

    def kernel():
        ops.quant_reduce_into(q, s, table, outs["kernel"])
        return outs["kernel"]

    def plain():
        ref.quant_reduce_into_ref(q, s, table.rows, outs["plain"],
                                  table.out_rows, table.own_rows)
        return outs["plain"]
    return dict(kernel=kernel, plain=plain, library=None, nbytes=nbytes)


def landing_table(B, R, n_out, dev, seed=0):
    """Row table of a gathered dequantize: one staged row of 0..R-1 a
    batch row, distinct out rows, no partial — a landing phase."""
    import numpy as np
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    return ops.row_table(rng.permutation(R)[:B, None],
                         rng.permutation(n_out)[:B], device=dev)


def dequantize_into_case(q_shape, wire, table, out_shape, out_dtype, dev,
                         seed=0):
    """The gathered dequantize at a main-path launch: a fresh quantized
    payload and out of the recorded shapes, the recorded row table."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    R, Lp = q_shape
    q, s = ops.quantize(torch.randn((R, Lp), generator=g, device=dev), wire)
    out0 = torch.randn(out_shape, generator=g, device=dev).to(out_dtype)
    outs = {"kernel": out0.clone(), "plain": out0.clone()}
    L = out_shape[-1]
    B = table.rows.shape[0]
    # each live staged row read up to L lanes with its scales, each out
    # row written, the two tables read
    nbytes = (_live_rows(table.rows) * (L + 4 * -(-L // ref.QUANT_TILE))
              + B * L * out0.element_size()
              + 8 * (table.rows.numel() + B))

    def kernel():
        ops.dequantize_into(q, s, table, outs["kernel"])
        return outs["kernel"]

    def plain():
        ref.dequantize_into_ref(q, s, table.rows, outs["plain"],
                                table.out_rows)
        return outs["plain"]
    return dict(kernel=kernel, plain=plain, library=None, nbytes=nbytes)


def wkv_case(B, H, T, K, V, dev, seed=0):
    """The wkv kernel at (B, H, T, K) / V: r, k, v ~ N(0, 1), decays
    exp(−exp(N(0, 1))), bonus and initial state N(0, 0.1²)."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    args = (n(B, H, T, K), n(B, H, T, K), n(B, H, T, V),
            -torch.exp(n(B, H, T, K)), n(H, K) * 0.1, n(B, H, K, V) * 0.1)
    # each input read once, out and the final state written once; per
    # (token, k, v) 7 flops, per (token, k) one exp
    nbytes = 4 * (B * H * T * (3 * K + 2 * V) + H * K + 2 * B * H * K * V)
    flops = B * H * T * K * (7 * V + 1)
    return dict(kernel=lambda: ops.wkv(*args),
                plain=lambda: ref.wkv_ref(*args), library=None,
                nbytes=nbytes, flops=flops, cmp=rel_cmp, args=args)


def ssm_scan_case(B, T, Di, N, dev, seed=0):
    """The ssm_scan kernel at (B, T, Di) / N: u, b, c ~ N(0, 1), step
    sizes softplus(N(0, 1)), decays −exp(N(0, 0.5²)), initial state
    N(0, 0.1²)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    args = (n(B, T, Di), F.softplus(n(B, T, Di)), n(B, T, N), n(B, T, N),
            -torch.exp(n(Di, N) * 0.5), n(B, Di, N) * 0.1)
    # each input read once, y and the final state written once; per
    # (token, d, n) 6 flops and one exp, per (token, d) one product
    nbytes = 4 * (3 * B * T * Di + 2 * B * T * N + Di * N + 2 * B * Di * N)
    flops = B * T * Di * (7 * N + 1)
    return dict(kernel=lambda: ops.ssm_scan(*args),
                plain=lambda: ref.ssm_scan_ref(*args), library=None,
                nbytes=nbytes, flops=flops, cmp=rel_cmp, args=args)


def rmsnorm_case(shape, x_dtype, w_dtype, offset, dev, seed=0,
                 last_token=False):
    """The rmsnorm kernel on x `shape` ~ N(0, 3²) and w ~ N(0, 0.5²), or
    with `last_token` on the strided rows x[:, -1:] of such an x (B, T,
    D), as the models' final norm after prefill (`last_token ==
    "misaligned"`: of such an x laid one element past a 16-byte
    boundary); the yardstick is `F.rms_norm` with (offset + w) formed
    beforehand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape) + (last_token == "misaligned")
    x = (torch.randn((n,), generator=g, device=dev) * 3.0).to(x_dtype)
    x = x[n - math.prod(shape):].view(shape)
    if last_token:
        x = x[:, -1:]
    D = shape[-1]
    w = (torch.randn((D,), generator=g, device=dev) * 0.5).to(w_dtype)
    w_lib = (offset + w.float()).to(x_dtype)
    # x read and y written once, w read once; 4 flops an element
    nbytes = 2 * x.numel() * x.element_size() + D * w.element_size()
    return dict(kernel=lambda: ops.rmsnorm(x, w, offset=offset),
                plain=lambda: ref.rmsnorm(x, w, offset=offset),
                want=lambda: ref.rmsnorm(x.float(), w, offset=offset),
                library=lambda: F.rms_norm(x, (D,), w_lib, eps=1e-6),
                nbytes=nbytes, flops=4 * x.numel(), cmp=rel_cmp1,
                out_dtype=x_dtype)


def visible_keys(B, Tq, Tk, kv_len, causal, window):
    """(Σ over batch rows and queries of the keys each query sees, Σ over
    batch rows of the key rows some query of the row sees): what the
    attention of this run's data must compute and read."""
    pairs = rows = 0
    for n in kv_len if kv_len is not None else [Tk] * B:
        n = min(max(int(n), 0), Tk)
        lo_all, hi_all = n, 0
        for i in range(Tq):
            p = n - Tq + i
            hi = min(n, p + 1) if causal else n
            lo = max(0, p - window + 1) if window > 0 else 0
            if hi > lo:
                pairs += hi - lo
                lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
        rows += max(0, hi_all - lo_all)
    return pairs, rows


def flash_case(B, Hq, Hkv, Tq, Tk, D, dtype, dev, *, window=0, softcap=0.0,
               kv_len=None, causal=True, seed=0):
    """The flash_attention kernel on q, k, v ~ N(0, 1): q a head transpose
    of a (B, Tq, Hq, D) tensor (the models' projection layout), k/v
    (B, Hkv, Tk, D) (the cache layout), kv_len a list of per-row key
    counts or None; held per query row (`rel_rows`). Bound: bytes (q,
    the visible K/V rows, out and kv_len once) against operations (4·D
    per visible score, on the bf16 tensor cores for bf16 inputs, the f32
    units for f32). The yardstick is `F.scaled_dot_product_attention`
    with `enable_gqa` wherever it computes the same function: no softcap
    and every query row sees a key. It takes `is_causal` where nothing
    else masks (no per-row counts, a window of at least Tk, Tq == Tk) or
    no mask where nothing masks at all; otherwise a boolean mask built
    before timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Tq, Hq, D), generator=g, device=dev).to(
        dtype).transpose(1, 2)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(dtype)
    n = (None if kv_len is None
         else torch.tensor(kv_len, dtype=torch.long, device=dev))
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=n)
    pairs, rows = visible_keys(B, Tq, Tk, kv_len, causal, window)
    elem = q.element_size()
    nbytes = (elem * (2 * B * Hq * Tq * D + 2 * rows * Hkv * D)
              + (0 if n is None else 8 * B))
    nk = torch.full((B,), Tk, device=dev) if n is None else n.clamp(0, Tk)
    qpos = nk[:, None] - Tq + torch.arange(Tq, device=dev)   # (B, Tq)
    kpos = torch.arange(Tk, device=dev)
    mask = (kpos < nk[:, None, None]).expand(B, Tq, Tk)
    if causal:
        mask = mask & (kpos <= qpos[..., None])
    if window > 0:
        mask = mask & (kpos > qpos[..., None] - window)
    mask = mask[:, None].contiguous()                        # (B, 1, Tq, Tk)
    library = None
    if softcap == 0 and bool(mask.any(dim=-1).all()):
        if n is None and (window == 0 or window >= Tk) \
                and (not causal or Tq == 1):
            attn = dict()
        elif n is None and (window == 0 or window >= Tk) and Tq == Tk:
            attn = dict(is_causal=True)
        else:
            attn = dict(attn_mask=mask)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, enable_gqa=True, **attn)
    return dict(kernel=lambda: ops.flash_attention(q, k, v, **kw),
                plain=lambda: ref.flash_attention(q, k, v, **kw),
                want=lambda: ref.flash_attention(q.float(), k.float(),
                                                 v.float(), **kw),
                library=library, nbytes=nbytes, flops=4 * Hq * D * pairs,
                rate=BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS,
                cmp=rel_rows, out_dtype=dtype)


def measure(case) -> dict:
    """Agreement with the plain version (or with `want`, the plain
    version on the inputs widened to f32, where the case gives one),
    device times of kernel, plain version and yardstick, and the bound:
    the larger of the bytes over the memory rate and (where the case
    counts them) the operations over the peak rate of their type (f32
    unless the case names another)."""
    import torch
    got = case["kernel"]()
    want = case.get("want", case["plain"])()
    torch.cuda.synchronize()
    err = (case["cmp"] if "cmp" in case else max_abs_err)(got, want)
    lib_err = None
    if case.get("cmp") is rel_rows and case["library"] is not None:
        lib_err = rel_rows(case["library"](), want)[1]
    del got, want
    t_bytes = bound_ms(case["nbytes"])
    t_ops = case.get("flops", 0) / case.get("rate", F32_FLOPS) * 1e3
    out = {"max_abs_err": err[0] if isinstance(err, tuple) else err,
           "ms": device_ms(case["kernel"]),
           "plain_ms": device_ms(case["plain"]),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": (device_ms(case["library"])
                          if case["library"] is not None else None)}
    if isinstance(err, tuple):
        out["max_rel_err"] = err[1]
    if lib_err is not None:
        out["library_rel_err"] = lib_err
    if "out_dtype" in case:
        out["out_dtype"] = str(case["out_dtype"]).removeprefix("torch.")
    torch.cuda.synchronize()
    return out


def handoff_err(kernel, args, time_dim: int, split: int) -> float:
    """Recurrence `kernel` over a sequence cut after `split` tokens, the
    first call's final state handed to the second, against one call over
    the whole: the largest relative disagreement of output and final
    state. args: the sequence inputs (time on axis `time_dim`), then the
    one fixed input and the initial state."""
    import torch
    *seq, fixed, s0 = args
    T = seq[0].shape[time_dim]
    whole, s_whole = kernel(*seq, fixed, s0)
    parts, s = [], s0
    for start, length in ((0, split), (split, T - split)):
        out, s = kernel(*(x.narrow(time_dim, start, length).contiguous()
                          for x in seq), fixed, s)
        parts.append(out)
    torch.cuda.synchronize()
    return rel_cmp((torch.cat(parts, dim=time_dim), s), (whole, s_whole))[1]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s, nvcc {build.nvcc()})")
    for name, text in build.build_logs.items():
        regs = [ln.split(":", 1)[1].strip() for ln in text.splitlines()
                if "Used" in ln and "registers" in ln]
        log(f"build: {name} ptxas: {'; '.join(regs)}")


def phase_kernels(dev) -> dict:
    """Returns, for each kernel the main path never launches, its result
    at the largest grid shape: {name: (wrapper, shapes, result)}."""
    import torch
    rows = []
    unlaunched = {}
    for L in KERNEL_LANES:
        for dtype in (torch.float32, torch.bfloat16):
            for x in (2, 3, 8, 9):
                r = measure(fused_reduce_case((x, L), dtype, dev))
                rows.append(("fused_reduce", f"x={x} L={L} {dtype}", r))
                if r["max_abs_err"] != 0.0:
                    fail(f"fused_reduce x={x} L={L} {dtype} differs from "
                         f"its plain version by {r['max_abs_err']}")
        # the tree: 4 levels (fan_in 2) and 2 (fan_in 3) over 9 operands
        for dtype, fan_in in ((torch.float32, 2), (torch.float32, 3),
                              (torch.bfloat16, 2)):
            r = measure(grouped_reduce_case((9, L), fan_in, dtype, dev))
            what = f"x=9 fan_in={fan_in} L={L} {dtype}"
            rows.append(("grouped_reduce", what, r))
            if r["max_abs_err"] != 0.0:
                fail(f"grouped_reduce {what} differs from its plain "
                     f"version by {r['max_abs_err']}")
            if L == KERNEL_LANES[-1] and "grouped_reduce" not in unlaunched:
                unlaunched["grouped_reduce"] = ("grouped_reduce",
                                                [(9, L)], r)
        for wire in ("float8_e4m3fn", "int8"):
            r = measure(quantize_case((8, L), wire, dev))
            rows.append(("quantize", f"R=8 L={L} {wire}", r))
            if r["max_abs_err"] != 0.0:
                fail(f"quantize L={L} {wire} differs from its plain "
                     f"version by {r['max_abs_err']}")
            r = measure(dequantize_case((8, L), wire, dev))
            rows.append(("dequantize", f"W=8 L={L} {wire}", r))
            if r["max_abs_err"] != 0.0:
                fail(f"dequantize L={L} {wire} differs from its plain "
                     f"version by {r['max_abs_err']}")
            Lp = -(-L // 128) * 128
            r = measure(quant_reduce_requant_case((8, Lp), wire, dev))
            rows.append(("quant_reduce_requant", f"K=8 Lp={Lp} {wire}", r))
            if r["max_abs_err"] != 0.0:
                fail(f"quant_reduce_requant Lp={Lp} {wire} differs from "
                     f"its plain version by {r['max_abs_err']}")
            if L == KERNEL_LANES[-1] and \
                    "quant_reduce_requant" not in unlaunched:
                unlaunched["quant_reduce_requant"] = (
                    "quant_reduce_requant", [(8, Lp)], r)
            for own_len in (0, L):
                r = measure(quant_reduce_case((8, Lp), wire, own_len, dev))
                tag = "own" if own_len else "no own"
                rows.append(("quant_reduce", f"K=8 Lp={Lp} {wire} {tag}", r))
                if r["max_abs_err"] != 0.0:
                    fail(f"quant_reduce L={L} {wire} {tag} differs from "
                         f"its plain version by {r['max_abs_err']}")
        torch.cuda.empty_cache()
    # the gathered forms: 8 batch rows of 8 operands out of 72 staged
    # rows, one operand slot masked and every other row folding its own
    # partial — an 8-rank fold phase
    for L in INTO_LANES:
        table = gathered_tables(8, 8, 72, 64, dev)
        for src_dtype, out_dtype in ((torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)):
            r = measure(fused_reduce_into_case(
                (72, L), src_dtype, table, (64, L), out_dtype, dev))
            what = f"into B=8 K=8 L={L} {src_dtype}->{out_dtype}"
            rows.append(("fused_reduce", what, r))
            if r["max_abs_err"] != 0.0:
                fail(f"fused_reduce {what} differs from its plain version "
                     f"by {r['max_abs_err']}")
        for wire in ("float8_e4m3fn", "int8"):
            Lp = -(-L // 128) * 128
            r = measure(quant_reduce_into_case(
                (72, Lp), wire, table, (64, L), torch.float32, dev))
            what = f"into B=8 K=8 L={L} {wire}->f32"
            rows.append(("quant_reduce", what, r))
            if r["max_abs_err"] != 0.0:
                fail(f"quant_reduce {what} differs from its plain version "
                     f"by {r['max_abs_err']}")
            # a landing phase: 8 ranks, one staged row each
            for out_dtype in (torch.float32, torch.bfloat16):
                r = measure(dequantize_into_case(
                    (72, Lp), wire, landing_table(8, 72, 64, dev), (64, L),
                    out_dtype, dev))
                what = f"into B=8 L={L} {wire}->{out_dtype}"
                rows.append(("dequantize", what, r))
                if r["max_abs_err"] != 0.0:
                    fail(f"dequantize {what} differs from its plain "
                         f"version by {r['max_abs_err']}")
        torch.cuda.empty_cache()
    rows += recurrence_grid(dev)
    rows += model_kernel_grid(dev)
    log_rows(rows)
    return unlaunched


# the recurrence grid: what, (B, H, T, K, V) of wkv and (B, T, Di, N) of
# ssm_scan. The serve shapes of rwkv6-1.6b (B 4, H 32, K = V = 64) and
# hymba-1.5b (B 4, Di 3200, N 16) at prefill and at T = 1, then the
# kernels' edges: batch 1 (a (b, h)'s columns, or a batch row's
# channels, over more blocks), T off the 16-token tile (1, 7, 33, 40 —
# which the reference's chunk of 32 does not divide — and 65), the smoke
# widths, V off a warp's column slice (20 at K 64; 36 at K 16; 18, off
# the 16-byte path), K 32 and 33 (off the 16-byte path), Di off the
# channel block (200; 130, off the 16-byte path), N 1, 3, 32 and 64
WKV_GRID = [
    ("prefill", (4, 32, 32, 64, 64)), ("decode", (4, 32, 1, 64, 64)),
    ("decode B=1", (1, 32, 1, 64, 64)), ("T=33", (4, 32, 33, 64, 64)),
    ("T=40", (4, 32, 40, 64, 64)), ("T=65", (2, 32, 65, 64, 64)),
    ("smoke", (2, 4, 8, 16, 16)), ("V=20", (2, 3, 40, 64, 20)),
    ("K=16 V=36", (2, 3, 33, 16, 36)), ("K=33 V=18", (1, 2, 65, 33, 18)),
    ("K=32 T=7", (3, 5, 7, 32, 64)),
]
SSM_GRID = [
    ("prefill", (4, 32, 3200, 16)), ("decode", (4, 1, 3200, 16)),
    ("decode B=1", (1, 1, 3200, 16)), ("T=33", (4, 33, 3200, 16)),
    ("T=40", (4, 40, 3200, 16)), ("T=65", (2, 65, 3200, 16)),
    ("smoke", (2, 8, 128, 8)), ("Di=200", (2, 32, 200, 16)),
    ("N=1", (2, 40, 200, 1)), ("N=3", (2, 33, 200, 3)),
    ("N=32 T=7", (2, 7, 200, 32)), ("N=64 Di=130", (1, 65, 130, 64)),
]
# (T, where the first call ends) of the state hand-off checks: halves of
# the serve prompt, and a first call of a tile and one token
HANDOFFS = ((32, 16), (40, 17))


def recurrence_grid(dev) -> list:
    """wkv and ssm_scan against their plain versions over WKV_GRID and
    SSM_GRID, then the state hand-off at HANDOFFS; fails on the first
    disagreement beyond TOLERANCE."""
    from repro_torch.kernels import ops
    rows = []
    for name, grid, make in (("wkv", WKV_GRID, wkv_case),
                             ("ssm_scan", SSM_GRID, ssm_scan_case)):
        for what, shape in grid:
            r = measure(make(*shape, dev))
            rows.append((name, f"{what} {shape}", r))
            if not within(name, r):
                fail(f"{name} {what} {shape} differs from its plain version "
                     f"by {r['max_rel_err']:.2e} of the largest |value|")
    for T, split in HANDOFFS:
        for name, case, dim in (
                ("wkv", wkv_case(4, 32, T, 64, 64, dev), 2),
                ("ssm_scan", ssm_scan_case(4, T, 3200, 16, dev), 1)):
            err = handoff_err(getattr(ops, name), case["args"], dim, split)
            log(f"kernel {name}: two calls over T={T} split at {split}, "
                f"state handed over, against one call: rel err {err:.2e}")
            if not err <= TOLERANCE[name]:
                fail(f"{name}: the state handoff at T={T} split at {split} "
                     f"disagrees with one call by {err:.2e}")
    return rows


def log_rows(rows) -> None:
    for name, what, r in rows:
        lib = (f" library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        rel = (f" (rel {r['max_rel_err']:.1e})" if "max_rel_err" in r
               else "")
        if "library_rel_err" in r:
            lib += f" (rel {r['library_rel_err']:.1e})"
        log(f"kernel {name:15s} {what:38s} err {r['max_abs_err']:.1e}{rel} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")


RAGGED = [33, 47, 60, 128]        # decode key counts of 4 batch rows
# attention grid: what, (B, Hq, Hkv, Tq, Tk, D), dtype, window, softcap,
# per-row key counts
FLASH_GRID = [
    ("stablelm-12b prefill", (4, 32, 8, 32, 32, 160), "bf16", 0, 0.0, None),
    ("stablelm-12b decode", (4, 32, 8, 1, 128, 160), "bf16", 0, 0.0,
     RAGGED),
    ("hymba-1.5b prefill", (4, 25, 5, 32, 32, 64), "bf16", 1024, 0.0, None),
    ("hymba-1.5b prefill w24", (4, 25, 5, 32, 32, 64), "bf16", 24, 0.0,
     None),
    ("hymba-1.5b decode", (4, 25, 5, 1, 128, 64), "bf16", 1024, 0.0, RAGGED),
    ("hymba-1.5b decode w24", (4, 25, 5, 1, 128, 64), "bf16", 24, 0.0,
     RAGGED),
    ("gemma2-27b prefill local", (4, 32, 16, 32, 32, 128), "bf16", 4096,
     50.0, None),
    ("gemma2-27b prefill global", (4, 32, 16, 32, 32, 128), "bf16", 0,
     50.0, None),
    ("gemma2-27b decode local", (4, 32, 16, 1, 128, 128), "bf16", 4096,
     50.0, RAGGED),
    ("gemma2-27b decode w24", (4, 32, 16, 1, 128, 128), "bf16", 24, 50.0,
     RAGGED),
    ("smoke f32 Tq 32 Tk 128", (2, 4, 2, 32, 128, 16), "f32", 24, 50.0,
     None),
    ("smoke f32 decode, a row sees none", (2, 4, 2, 1, 32, 16), "f32", 24,
     50.0, [0, 32]),
    ("smoke f32 group 1", (2, 4, 4, 32, 32, 16), "f32", 0, 0.0, None),
    ("D 160 f32 ragged", (2, 8, 2, 32, 128, 160), "f32", 0, 0.0, [100, 40]),
    ("gemma2-27b long local", (1, 32, 16, 4352, 4352, 128), "bf16", 4096,
     50.0, None),
    ("gemma2-27b long global", (1, 32, 16, 4352, 4352, 128), "bf16", 0,
     50.0, None),
    ("gemma2-27b long decode local", (1, 32, 16, 1, 4416, 128), "bf16",
     4096, 50.0, [4360]),
    ("gemma2-27b long decode global", (1, 32, 16, 1, 4416, 128), "bf16", 0,
     50.0, [4360]),
    ("decode Tq 3", (2, 8, 2, 3, 200, 128), "f32", 50, 0.0, [180, 2]),
    # the decode kernel at long context: no softcap, so SDPA is a
    # yardstick; a ragged batch with a row that sees none, one shorter
    # than a split and one at full length; four queries a head
    ("stablelm-12b long decode", (1, 32, 8, 1, 4416, 160), "bf16", 0, 0.0,
     [4360]),
    ("gemma2-27b ragged long decode", (4, 32, 16, 1, 4416, 128), "bf16",
     4096, 50.0, [4360, 0, 300, 4416]),
    ("long decode Tq 4 f32", (1, 32, 16, 4, 4416, 128), "f32", 4096, 50.0,
     [4360]),
    ("long decode Tq 4 bf16", (1, 32, 16, 4, 4416, 128), "bf16", 4096, 50.0,
     [4360]),
    # the f32 prefill kernel past one block of query rows
    ("f32 prefill Tq 130 D 160", (1, 8, 2, 130, 130, 160), "f32", 0, 0.0,
     None),
    # the bf16 prefill kernel's edges: Tq 5, 17, 33 and past its 128-row
    # tile, head dims 64/72/80/128/160/256, groups 1/4/5, ragged key
    # counts with a row that sees none, windows narrower than a key tile
    ("prefill Tq 5 group 1", (2, 4, 4, 5, 5, 64), "bf16", 0, 0.0, None),
    ("prefill Tq 17 D 72 ragged", (2, 8, 2, 17, 40, 72), "bf16", 0, 50.0,
     [40, 17]),
    ("prefill Tq 33 D 80 group 5 w24", (2, 10, 2, 33, 33, 80), "bf16", 24,
     0.0, None),
    ("prefill Tq 130 D 256", (1, 8, 4, 130, 130, 256), "bf16", 0, 50.0,
     None),
    ("prefill Tq 129 group 1", (1, 5, 5, 129, 129, 128), "bf16", 0, 0.0,
     None),
    ("prefill ragged, a row sees none, w16", (3, 4, 4, 40, 100, 160), "bf16",
     16, 0.0, [100, 0, 45]),
]
# rmsnorm widths: stablelm-12b, rwkv6-1.6b (d and ln_x), hymba-1.5b,
# gemma2-27b, the smoke models
RMSNORM_WIDTHS = (5120, 2048, 1600, 4608, 64)


def model_kernel_grid(dev, *, attention_only: bool = False) -> list:
    """The model kernels (flash_attention, rmsnorm) against their plain
    versions over FLASH_GRID and 4·32 rows of each of RMSNORM_WIDTHS
    (both offsets, every dtype pair), plus the decode rows, the strided
    last-token rows of the widest model (aligned and not), two widths on
    and off the 16-byte path, and the long prefill's rows; fails on the
    first disagreement beyond TOLERANCE. `attention_only`: FLASH_GRID
    alone."""
    import torch
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = []

    def check(name, what, case):
        r = measure(case)
        rows.append((name, what, r))
        if not within(name, r):
            fail(f"{name} {what} differs from its plain version by "
                 f"{r['max_rel_err']:.2e} of the largest |value| "
                 f"(tolerance {tolerance(name, r):.2e})")

    for what, (B, Hq, Hkv, Tq, Tk, D), dt, window, softcap, n in FLASH_GRID:
        check("flash_attention",
              f"{what} {(B, Hq, Hkv, Tq, Tk, D)} w={window} cap={softcap:g}",
              flash_case(B, Hq, Hkv, Tq, Tk, D, dtypes[dt], dev,
                         window=window, softcap=softcap, kv_len=n))
        torch.cuda.empty_cache()
    if attention_only:
        return rows
    for D in RMSNORM_WIDTHS:
        for offset in (0.0, 1.0):
            for xn, xd in dtypes.items():
                for wn, wd in dtypes.items():
                    check("rmsnorm", f"(4, 32, {D}) {xn} x {wn} w "
                          f"offset {offset:g}",
                          rmsnorm_case((4, 32, D), xd, wd, offset, dev))
    for what, shape, last in (("decode (4, 1, 5120)", (4, 1, 5120), False),
                              ("last token of (4, 32, 5120)", (4, 32, 5120),
                               True),
                              ("misaligned last token of (4, 32, 5120)",
                               (4, 32, 5120), "misaligned"),
                              ("(4, 32, 1000), 16-byte vectors",
                               (4, 32, 1000), False),
                              ("(4, 32, 1001), element path", (4, 32, 1001),
                               False),
                              ("gemma2-27b long prefill (1, 4352, 4608)",
                               (1, 4352, 4608), False)):
        check("rmsnorm", f"{what} bf16 x bf16 w offset 1",
              rmsnorm_case(shape, torch.bfloat16, torch.bfloat16, 1.0, dev,
                           last_token=last))
    return rows


# wrapper → the kernel it launches (the name its launches count under)
WRAPPERS = {"fused_reduce": "fused_reduce",
            "fused_reduce_into": "fused_reduce",
            "grouped_reduce": "grouped_reduce",
            "quantize": "quantize",
            "dequantize": "dequantize",
            "dequantize_into": "dequantize",
            "quant_reduce_requant": "quant_reduce_requant",
            "quant_reduce": "quant_reduce",
            "quant_reduce_into": "quant_reduce",
            "wkv": "wkv",
            "ssm_scan": "ssm_scan",
            "rmsnorm": "rmsnorm",
            "flash_attention": "flash_attention"}
# the kernels the executor folds, quantizes and lands copies with
EXECUTOR_KERNELS = ("fused_reduce", "quantize", "quant_reduce", "dequantize")


class ShapeRecorder:
    """Records, per kernel, the wrapper and arguments of its first launch
    on the main path (the call at which the kernels line times it):
    shapes and dtypes of the data, and the row table (immutable, so kept
    as it is). It calls the real wrapper, which alone counts launches."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.real = {w: getattr(ops, w) for w in WRAPPERS}
        self.first: dict[str, tuple] = {}

    def __enter__(self):
        import torch

        def keep(a):
            if isinstance(a, torch.Tensor):
                return ("tensor", tuple(a.shape), a.dtype)
            return a

        for wrapper, fn in self.real.items():
            def spy(*args, _w=wrapper, _fn=fn, **kw):
                if WRAPPERS[_w] not in self.first:
                    self.first[WRAPPERS[_w]] = (
                        _w, [keep(a) for a in args],
                        {k: keep(v) for k, v in kw.items()})
                return _fn(*args, **kw)
            setattr(self.ops, wrapper, spy)
        return self

    def __exit__(self, *exc):
        for wrapper, fn in self.real.items():
            setattr(self.ops, wrapper, fn)


def schedule_bytes(cs, size: int, dtype, steps=None,
                   copy_in: bool = True) -> int:
    """Bytes one run of schedule `cs` (its `steps`, default the AllReduce's
    two halves) on a working buffer of (n, size) rows of `dtype` must move
    if every step's data crosses device memory once: the input copied
    into the working buffer (unless `copy_in` is off: the operand is the
    working buffer); per round each live payload row read and
    written to staging at wire width (fp8/int8: the quantized row and its
    f32 scales); per fold or landing each live operand and resident
    partial read and the result row written."""
    import torch
    elem = torch.empty((), dtype=dtype).element_size()
    chunk = -(-size // cs.num_blocks)
    wire = cs.wire
    if wire is None:
        stage_row = chunk * elem
    elif wire.scale_block:
        nt = -(-chunk // wire.scale_block)
        stage_row = nt * wire.scale_block + 4 * nt
    else:
        stage_row = chunk * 2                  # bf16
    total = 2 * cs.n * cs.num_blocks * chunk * elem if copy_in else 0
    for st in (cs.rs + cs.ag if steps is None else steps):
        for rd in st.rounds:
            live = sum(int((rd.send_blks[s] >= 0).sum()) for s, _ in rd.perm)
            total += live * (chunk * elem + stage_row)
        for fd in st.folds:
            act = fd.blk >= 0
            total += int((fd.ops[act] >= 0).sum()) * stage_row
            total += int((fd.include_self & act).sum()) * chunk * elem
            total += int(act.sum()) * chunk * elem
    return total


def phase_executor(dev, recorder) -> dict:
    import torch
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.core.lower import guard_schedule
    from repro_torch.core.topology import single_switch, symmetric_tree
    from repro_torch.kernels import ops
    from repro_torch.planner.service import default_service

    svc = default_service()
    ops.reset_launches()
    with recorder:
        for size, label in EXEC_SIZES:
            for tname, topo in (("single_switch(8)", single_switch(8)),
                                ("symmetric_tree(2,4)", symmetric_tree(2, 4))):
                resp = svc.get_executable(topo, size * 4)
                g = torch.Generator(device=dev).manual_seed(size % 997)
                X = torch.randn((topo.num_servers(), size), generator=g,
                                device=dev)
                want = X.double().sum(dim=0)
                scale = float(want.abs().max())
                for wire in (None, "bf16", "fp8", "int8"):
                    cs = resp.schedule.with_wire(
                        None if wire is None else PRECISIONS[wire])
                    sched = guard_schedule(cs)
                    got = sched.run_local(X)
                    torch.cuda.synchronize()
                    err = max(float((row.double() - want).abs().max())
                              for row in got) / scale
                    del got
                    budget = (1e-6 if wire is None
                              else PRECISIONS[wire].error_budget)
                    if not err <= budget:
                        fail(f"executor {tname} {label} wire={wire}: rel "
                             f"err {err:.3e} over {budget}")
                    run = lambda: sched.run_local(X)   # noqa: E731
                    dev_ms = device_ms(run, launches=3, blocks=3)
                    wall_ms = host_ms(run)
                    if sched.demotions or sched.stats["failures"]:
                        fail(f"executor {tname} {label} wire={wire}: guard "
                             f"demoted {sched.demotions} time(s), "
                             f"{sched.stats['failures']} failure(s)")
                    sched_bound = bound_ms(schedule_bytes(cs, size,
                                                          X.dtype))
                    fn_bound = bound_ms(2 * X.numel() * X.element_size())
                    log(f"executor {tname:20s} {label:14s} "
                        f"wire={wire or 'f32':5s} {cs.describe()} rel err "
                        f"{err:.2e} (budget {budget:g}) device "
                        f"{dev_ms:.4f} ms wall {wall_ms:.4f} ms schedule "
                        f"bound {sched_bound:.4f} ms in+out bound "
                        f"{fn_bound:.4f} ms")
                del X, want
                torch.cuda.empty_cache()
    counts = dict(ops.LAUNCHES)
    log(f"executor: launches {json.dumps(counts)}")
    for name in EXECUTOR_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched by the executor")
    return counts


def family_steps(cs, family: str) -> list:
    """The steps a family entry point runs: the ReduceScatter half and the
    shard reorder, the unorder and the AllGather half, or the movement
    steps of all-to-all and p2p."""
    if family == "reduce_scatter":
        return cs.rs + ([cs.reorder] if cs.reorder is not None else [])
    if family == "allgather":
        return ([cs.unorder] if cs.unorder is not None else []) + cs.ag
    return cs.ag


def family_case(cs, family: str, size: int, dev, seed: int):
    """(entry point name, input, exact answer, f32 tolerance) of a family
    schedule at `size` elements a rank: the all-gather gathers shards of
    size / n into size; the others take (n, size)."""
    import torch
    n = cs.n
    g = torch.Generator(device=dev).manual_seed(seed)
    if family == "allgather":
        S = torch.randn((n, size // n), generator=g, device=dev)
        return ("run_local_all_gather", S,
                S.reshape(1, -1).expand(n, -1), 0.0)
    X = torch.randn((n, size), generator=g, device=dev)
    if family == "reduce_scatter":
        return ("run_local_reduce_scatter", X,
                X.double().sum(dim=0).reshape(n, -1), 1e-6)
    if family == "all_to_all":
        return ("run_local_all_to_all", X,
                X.reshape(n, n, -1).transpose(0, 1).reshape(n, -1), 0.0)
    want = X.clone()
    for s_, d in cs.perm_pairs:
        want[d] = X[s_]
    return "run_local_p2p", X, want, 0.0


def phase_families(dev, recorder) -> dict:
    """The planner's family schedules on the 8-rank local mesh, through
    the guard, in f32 and every wire; returns the kernel launches."""
    import torch
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.core.lower import guard_schedule
    from repro_torch.core.topology import single_switch, symmetric_tree
    from repro_torch.kernels import ops
    from repro_torch.planner.service import default_service

    svc = default_service()
    ops.reset_launches()
    seen = set()
    with recorder:
        for size, label in EXEC_SIZES:
            big = size >= 1 << 24       # fewer repeats at gradient size
            for tname, topo in (("single_switch(8)", single_switch(8)),
                                ("symmetric_tree(2,4)", symmetric_tree(2, 4))):
                for family in FAMILIES:
                    resp = svc.get_family_executable(
                        family, "x", topo.num_servers(), size, topo=topo)
                    if (id(resp.schedule), size) in seen:
                        # all-to-all and p2p plans are flat: the tree's
                        # schedule is the switch's, already run
                        continue
                    seen.add((id(resp.schedule), size))
                    entry, X, want, f32_tol = family_case(
                        resp.schedule, family, size, dev, size % 997)
                    scale = float(want.abs().max())
                    for wire in (None, "bf16", "fp8", "int8"):
                        cs = resp.schedule.with_wire(
                            None if wire is None else PRECISIONS[wire])
                        sched = guard_schedule(cs)
                        got = getattr(sched, entry)(X)
                        torch.cuda.synchronize()
                        err = float((got.double() - want.double()).abs()
                                    .max()) / scale
                        del got
                        budget = (f32_tol if wire is None
                                  else PRECISIONS[wire].error_budget)
                        what = (f"families {family} {tname} {label} "
                                f"wire={wire or 'f32'}")
                        if not err <= budget:
                            fail(f"{what}: rel err {err:.3e} over {budget}")
                        run = lambda: getattr(sched, entry)(X)  # noqa: E731
                        dev_ms = (device_ms(run, launches=2, blocks=2) if big
                                  else device_ms(run, launches=3, blocks=3))
                        wall_ms = host_ms(run, calls=2 if big else 3)
                        if sched.demotions or sched.stats["failures"]:
                            fail(f"{what}: guard demoted {sched.demotions} "
                                 f"time(s), {sched.stats['failures']} "
                                 f"failure(s)")
                        sched_bound = bound_ms(schedule_bytes(
                            cs, size, X.dtype, family_steps(cs, family)))
                        log(f"{what} {cs.describe()} rel err {err:.2e} "
                            f"(budget {budget:g}) device {dev_ms:.4f} ms "
                            f"wall {wall_ms:.4f} ms schedule bound "
                            f"{sched_bound:.4f} ms")
                    del X, want
                    torch.cuda.empty_cache()
    counts = dict(ops.LAUNCHES)
    log(f"families: launches {json.dumps(counts)}")
    if counts["dequantize"] <= 0:
        fail("kernel dequantize was never launched by the families")
    return counts


def expected_launches(cfg, forwards: int) -> dict:
    """Launches of each model kernel in `forwards` forwards of `cfg`:
    rmsnorm per norm, flash_attention per attention layer, the family's
    recurrence kernel per layer, and the other recurrence never."""
    fam = cfg.family
    want = {"rmsnorm": forwards * (NORMS_PER_LAYER[fam] * cfg.n_layers + 1),
            "flash_attention":
                forwards * ATTENTION_PER_LAYER[fam] * cfg.n_layers}
    for family, kernel in RECURRENCE.items():
        want[kernel] = forwards * cfg.n_layers if fam == family else 0
    return want


def phase_serve(dev, recorder, sc: dict) -> dict:
    """Serve `sc["arch"]` at full size with the ServeConfig fields `sc`;
    returns the kernel launches of the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, serve

    arch = sc["arch"]
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with recorder:
        res = serve(ServeConfig(**sc, device=str(dev)), smoke=False,
                    on_log=log)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    by_kernel = dict(ops.ATTENTION_LAUNCHES)
    cfg = res["config"]
    tm = res["timings"]
    log(f"serve: {cfg.name} family={cfg.family} layers={cfg.n_layers} "
        f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab}; batch {sc['batch']} prompt "
        f"{sc['prompt_len']} new {sc['max_new']} cache {sc['cache_len']}; "
        f"launches {json.dumps(counts)}; attention kernels "
        f"{json.dumps(by_kernel)}; "
        f"demotions {res['tp_schedule'].demotions}; self-check rel err "
        f"{res['self_check_err']:.2e}; prefill {tm['prefill_s'] * 1e3:.1f} "
        f"ms, decode first {tm['decode_first_s'] * 1e3:.1f} ms, median "
        f"{tm['decode_median_s'] * 1e3:.1f} ms; timings {json.dumps(tm)}; "
        f"wall {wall:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    if counts["fused_reduce"] <= 0:
        fail(f"serving {arch} launched no fused_reduce kernel")
    # each model kernel exactly as often as the forwards run it: the
    # prefill and max_new − 1 decode steps
    for kernel, want in expected_launches(cfg, sc["max_new"]).items():
        if counts[kernel] != want:
            fail(f"serving {arch} launched {kernel} {counts[kernel]} "
                 f"time(s), expected {want}")
    # the prompt's forward on the bf16 prefill kernel, each decode step's
    # on the decode kernel: one launch an attention layer each
    layers = ATTENTION_PER_LAYER[cfg.family] * cfg.n_layers
    want = {"flash_decode_kernel": layers * (sc["max_new"] - 1),
            "flash_tc_kernel": layers, "flash_tf32_kernel": 0}
    if by_kernel != want:
        fail(f"serving {arch} ran attention kernels {by_kernel}, expected "
             f"{want}")
    if res["tp_schedule"].demotions or res["tp_schedule"].stats["failures"]:
        fail(f"serving {arch}: the decode schedule was demoted "
             f"{res['tp_schedule'].demotions} time(s) or failed")
    if not res["self_check_err"] < 1e-5:
        fail(f"serving {arch}: self-check rel err {res['self_check_err']}")
    toks = res["tokens"]
    want = (sc["batch"], sc["max_new"])
    if toks.shape != want or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"serving {arch} produced tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    del res
    torch.cuda.empty_cache()
    return {**counts, **by_kernel}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _tensors(tree):
    """Every tensor of a nested dict / list of parameters."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for x in tree for t in _tensors(x)]
    return [tree]


def phase_decode_profile(dev, arch: str) -> None:
    """Where a decode step's time goes: the full-size model `arch`,
    prefilled, two warm-up steps, then PROFILE_STEPS greedy steps under
    torch.profiler. Prints per step: the wall time (under the profiler),
    the kernels launched, the device's busy time (the union of kernel,
    copy and set intervals in the trace) and its share of the wall time,
    the weight-read bound (every weight but the embedding read once, over
    the memory rate), and the kernels that take most device time."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build

    cfg = get_config(arch)
    api = build(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _tensors({k: v for k, v in params.items()
                                          if k != "embed"}))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab,
                           (SERVE["batch"], SERVE["prompt_len"]),
                           generator=gen, device=dev)

    def step(cache, tok):
        logits, cache = api.decode_step(params, cache,
                                        {"tokens": tok[:, None]})
        return cache, logits[:, -1].float().argmax(dim=-1)

    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": tokens},
                                    SERVE["cache_len"])
        tok = logits[:, -1].float().argmax(dim=-1)
        for _ in range(2):
            cache, tok = step(cache, tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                cache, tok = step(cache, tok)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "decode_trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    dev_events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev_events if e["cat"] == "kernel"]
    bound = bound_ms(weight_bytes)
    if not kernels:
        log(f"decode profile: {arch}: {PROFILE_STEPS} steps, wall "
            f"{wall_us / PROFILE_STEPS / 1e3:.3f} ms per step; the trace "
            f"holds no kernel: device time not measured; weight-read bound "
            f"{bound:.3f} ms")
    else:
        busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev_events)
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"decode profile: {arch}: {PROFILE_STEPS} steps, per step wall "
            f"{wall_us / PROFILE_STEPS / 1e3:.3f} ms, kernels "
            f"{len(kernels) / PROFILE_STEPS:.0f}, device busy "
            f"{busy / PROFILE_STEPS / 1e3:.3f} ms ({busy / wall_us:.1%} of "
            f"wall), weight-read bound {bound:.3f} ms "
            f"({weight_bytes / 1e9:.2f} GB)")
        for name, us in top:
            log(f"decode profile: {arch}: {us / PROFILE_STEPS / 1e3:.3f} ms "
                f"per step in {name[:100]}")
    del params, cache, logits
    torch.cuda.empty_cache()


def _to(tree, where):
    """A copy of a nested dict / list of tensors on device `where`."""
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, where) for v in tree]
    return tree.to(where)


def phase_model_reference(dev, arch: str) -> None:
    """The smoke-size model of `arch` in f32 on the card (its kernels)
    against the same code on the CPU (their plain versions): prefill of
    a (batch, prompt) of REFERENCE_RUN (default 2 × 8, cache 16) + 4
    greedy decode steps, logits within 1e-4 of the largest |logit|,
    identical tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    api = build(smoke_config(get_config(arch)))
    params = api.init_params(torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
    B, T, cache_len = REFERENCE_RUN.get(arch, (2, 8, 16))
    tokens = torch.randint(0, api.cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for where in ("cpu", dev):
        p = _to(params, where)
        with torch.inference_mode():
            logits, cache = api.prefill(p, {"tokens": tokens.to(where)},
                                        cache_len)
            outs, toks = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(dim=-1)
                toks.append(tok.cpu())
                logits, cache = api.decode_step(p, cache,
                                                {"tokens": tok[:, None]})
                outs.append(logits.cpu())
        runs[str(where)] = (torch.stack(outs), torch.stack(toks))
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(dev)]
    err = float((lg - lc).abs().max() / lc.abs().max())
    log(f"model: {arch} smoke-size f32, prompt {T}, logits card vs CPU "
        f"rel err "
        f"{err:.2e}, tokens equal {bool(torch.equal(tc, tg))}")
    if not (torch.isfinite(lg).all() and err <= 1e-4
            and torch.equal(tc, tg)):
        fail(f"the card's smoke-size {arch} disagrees with the CPU run")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
class FoldRecorder:
    """Records the arguments of every distinct `fused_reduce_into` launch
    (shapes, dtypes and the row table, kept as it is), in order: the
    shapes the trainer's gathers and reduce-scatters fold at."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.real = ops.fused_reduce_into
        self.calls: dict[tuple, tuple] = {}

    def __enter__(self):
        def spy(src, table, out):
            key = (tuple(src.shape), src.dtype, id(table), tuple(out.shape))
            if key not in self.calls:
                self.calls[key] = (tuple(src.shape), src.dtype, table,
                                   tuple(out.shape), out.dtype)
            return self.real(src, table, out)
        self.ops.fused_reduce_into = spy
        return self

    def __exit__(self, *exc):
        self.ops.fused_reduce_into = self.real


def train_bounds(cfg, cs, shards, n: int, seq_len: int, batch: int,
                 step=None) -> dict:
    """The least time of each part of one step (ms), from this run's
    shapes: the gather and the reduce-scatter at their schedule's bytes
    (`schedule_bytes` of each launch's per-rank rows: each leaf's padded
    rows on the per-leaf path, each bucket's n·width on the bucketed one,
    whose in-place reduce-scatter copies nothing in); each rank's forward
    and backward at the larger of its bytes (every weight read once,
    every gradient written once, bf16) and its products (2 operations a
    weight a token forward, 4 backward, plus attention's QK and PV, over
    the bf16 tensor core rate); AdamW at 22 bytes a parameter (bf16
    weight and gradient read, f32 m and v read, all four written back but
    the gradient)."""
    P = sum(int(t.numel()) for t in shards)       # padded, all ranks
    elem = shards[0].element_size()
    dtype = shards[0].dtype
    if step is not None and step.bucket_plan is not None:
        gather = sum(schedule_bytes(cs, n * bk.width, dtype,
                                    family_steps(cs, "allgather"))
                     for bk in step.gather_buckets)
        scatter = sum(schedule_bytes(cs, n * bk.width, dtype,
                                     family_steps(cs, "reduce_scatter"),
                                     copy_in=False)
                      for bk in step.scatter_buckets)
    else:
        gather = sum(schedule_bytes(cs, int(t.numel()), dtype,
                                    family_steps(cs, "allgather"))
                     for t in shards)
        scatter = sum(schedule_bytes(cs, int(t.numel()), dtype,
                                     family_steps(cs, "reduce_scatter"))
                      for t in shards)
    matmul = P - cfg.vocab * cfg.d_model - (2 * cfg.n_layers + 1) \
        * cfg.d_model                            # no embed, no norms
    tokens = seq_len * batch // n
    attn = (4 * tokens * seq_len * cfg.n_heads * cfg.head_dim
            * cfg.n_layers)                      # QK and PV, forward
    flops = 6 * tokens * matmul + 3 * attn
    fb_bytes = 2 * P * elem
    rank = max(bound_ms(fb_bytes), flops / BF16_FLOPS * 1e3)
    return {"gather": bound_ms(gather), "forward_backward": n * rank,
            "reduce_scatter": bound_ms(scatter), "adamw": bound_ms(22 * P),
            "rank_bytes_ms": bound_ms(fb_bytes),
            "rank_flops_ms": flops / BF16_FLOPS * 1e3}


def train_run(api, params, n: int, lr: float, steps: int, seq_len: int,
              global_batch: int, seed: int = 0, sync=None, param_dtype=None):
    """`steps` steps of `make_manual_train_step` on `api` from `params`
    (the port's per-layer tree, on the device the run takes), with `sync`
    (default: the step's own, the per-leaf path) and shards of
    `param_dtype` (default bf16): the state, per-step losses, gnorms,
    host-clock step times (each ending in the loss's copy to the host),
    device times of the step's parts, and the step."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import (make_manual_train_step, phase_ms,
                                          shard_params_zero3)
    from repro_torch.optim import AdamWConfig, adamw_init

    where = params["embed"].device
    shards = shard_params_zero3(params, n)
    del params
    state = {"params": shards, "opt": adamw_init(shards)}
    kw = {} if sync is None else {"sync": sync}
    step = make_manual_train_step(api, n, AdamWConfig(lr=lr), device=where,
                                  param_dtype=param_dtype or torch.bfloat16,
                                  **kw)
    data = SyntheticLM(DataConfig(vocab=api.cfg.vocab, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
    out = {"losses": [], "gnorms": [], "step_s": [], "phase_ms": []}
    for s in range(steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(np.asarray(v), device=where).long()
                 for k, v in data.batch_at(s).items()}
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["gnorms"].append(gnorm)
        out["phase_ms"].append(phase_ms(m))
    out.update(state=state, plans=step.plans, step=step)
    return out


def phase_train(dev, lr: float, must_fall: bool, recorder=None, *,
                sync=None, label: str = "per-leaf", tracer=None) -> dict:
    """The ZeRO-3 trainer on TRAIN (stablelm-12b at full width, its depth
    cut to 2 layers, random bf16 weights, 8 local ranks, seq 128, global
    batch 8) for TRAIN["steps"] steps at learning rate `lr` with `sync`
    (default: the per-leaf path), every launch count zeroed just before
    and read just after; `tracer`, when given, records the run's spans.
    Checks: finite losses and gnorms (falling losses where `must_fall`),
    the gathered rows equal on every step (the trainer compares them with
    torch.equal and raises), fused_reduce launched exactly steps × (the
    gather's launches × the all-gather's fold phases + the scatter's
    launches × the reduce-scatter's), a launch a leaf per leaf or a
    bucket bucketed, and no other kernel, no guard failure. Prints the
    plan (on the bucketed path the bucket plan and its sweep's three
    cheapest rows), the step time (host clock; median after the first),
    its parts (CUDA events) beside their bounds and the peak memory.
    Returns the launch counts, the losses and the step."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import PHASES
    from repro_torch.models.registry import build
    from repro_torch.runtime.trace import set_default_tracer

    tr = TRAIN
    cfg = dataclasses.replace(get_config(tr["arch"]), n_layers=tr["layers"])
    n, steps = tr["local_ranks"], tr["steps"]
    torch.empty(1, device=dev)       # the allocator's peak needs a context
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    api = build(cfg)
    prev = set_default_tracer(tracer) if tracer is not None else None
    try:
        with recorder or contextlib.nullcontext():
            res = train_run(api, api.init_params(
                torch.Generator(device=dev).manual_seed(0), torch.bfloat16,
                dev), n, lr, steps, tr["seq_len"], tr["global_batch"],
                sync=sync)
    finally:
        if tracer is not None:
            set_default_tracer(prev)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    by_kernel = dict(ops.ATTENTION_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    shards = res["state"]["params"]
    step = res["step"]
    (plan,) = res["plans"]
    sched = plan.schedule
    cs = sched.inner
    bp = step.bucket_plan
    losses, gnorms = res["losses"], res["gnorms"]
    if bp is not None:
        cheapest = sorted(bp.sweep.items(),
                          key=lambda kv: (kv[1]["contended"], kv[0]))[:3]
        plan_txt = (
            f"bucket plan {bp.bucket_bytes} bytes ({bp.bucket_floats} f32 "
            f"units), K={bp.num_buckets}, {bp.precision}, overlap "
            f"{bp.overlap.get('mode')}, predicted contended "
            f"{bp.predicted_contended * 1e3:.4f} ms pipelined "
            f"{bp.predicted_pipelined * 1e3:.4f} ms serial "
            f"{bp.predicted_serial * 1e3:.4f} ms; the sweep's three "
            f"cheapest rows "
            + "; ".join(f"{b} units K={r['num_buckets']} contended "
                        f"{r['contended'] * 1e3:.4f} ms"
                        for b, r in cheapest)
            + f"; {len(step.gather_buckets)} gather bucket(s), "
            f"{len(step.scatter_buckets)} scatter bucket(s); schedule "
            f"{cs.describe()}")
    else:
        plan_txt = (f"plan {cs.describe()} (predicted "
                    f"{plan.predicted * 1e3:.3f} ms)")
    log(f"train [{label}]: {cfg.name} layers={cfg.n_layers} (cut from "
        f"{get_config(tr['arch']).n_layers}) d={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab};"
        f" {sum(t.numel() for t in shards) / 1e6:.1f} M parameters (padded)"
        f" in {len(shards)} leaves; {n} local ranks, seq {tr['seq_len']}, "
        f"global batch {tr['global_batch']}, lr {lr}; {plan_txt}; losses "
        f"{losses}; gnorms {gnorms}; gathered rows equal on every step; "
        f"wall {wall:.1f} s; peak memory {peak / 2**30:.2f} GiB")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train [{label}]: non-finite loss or gnorm: {losses} {gnorms}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"train [{label}]: the loss did not fall at lr {lr}: {losses}")
    rs_folds = sum(len(st.folds) for st in family_steps(cs,
                                                        "reduce_scatter"))
    ag_folds = sum(len(st.folds) for st in family_steps(cs, "allgather"))
    if bp is None:
        n_ag = n_rs = len(shards)
    else:
        n_ag, n_rs = len(step.gather_buckets), len(step.scatter_buckets)
    want = steps * (n_ag * ag_folds + n_rs * rs_folds)
    log(f"train [{label}]: fused_reduce launches {counts['fused_reduce']} = "
        f"{steps} steps x ({n_ag} all-gathers x {ag_folds} landing phases "
        f"+ {n_rs} reduce-scatters x {rs_folds} fold phases) -> expected "
        f"{want}; launches {json.dumps(counts)}; attention kernels "
        f"{json.dumps(by_kernel)}; guard {json.dumps(sched.stats)}")
    if counts["fused_reduce"] != want:
        fail(f"train [{label}] launched fused_reduce "
             f"{counts['fused_reduce']} time(s), expected {want}")
    for name, count in counts.items():
        if name != "fused_reduce" and count:
            fail(f"train [{label}] launched {name} {count} time(s)")
    if any(by_kernel.values()):
        fail(f"train [{label}] ran attention kernels {by_kernel}")
    if sched.demotions or sched.stats["failures"]:
        fail(f"train [{label}]: guard {sched.stats}, {sched.demotions} "
             f"demotion(s)")
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    parts = {k: statistics.median(p[k] for p in res["phase_ms"][1:])
             for k in PHASES}
    bounds = train_bounds(cfg, cs, shards, n, tr["seq_len"],
                          tr["global_batch"], step)
    coll = parts["gather"] + parts["reduce_scatter"]
    coll_bound = bounds["gather"] + bounds["reduce_scatter"]
    log(f"train [{label}]: step time median of steps 2-{steps} "
        f"{step_ms:.1f} ms (first {res['step_s'][0] * 1e3:.1f} ms; steps "
        f"{[round(x * 1e3, 1) for x in res['step_s']]}); device parts "
        + ", ".join(f"{k} {parts[k]:.2f} ms (bound {bounds[k]:.2f})"
                    for k in PHASES)
        + f"; sum {sum(parts.values()):.2f} ms; collectives (gather + "
        f"reduce-scatter) {coll:.2f} ms against the schedule's byte bound "
        f"{coll_bound:.2f} ms; one rank's forward and backward bound: bytes "
        f"{bounds['rank_bytes_ms']:.3f} ms, products "
        f"{bounds['rank_flops_ms']:.3f} ms")
    return {"counts": counts, "losses": losses, "step": step}


def trainer_rows(dev, recorder) -> list:
    """fused_reduce at the trainer's gradient shapes: the largest leaf's
    reduce-scatter fold and its all-gather landing, and the smallest
    matrix leaf's fold, as the step launched them (gathered form,
    recorded tables), and the dense form of each fold (n ranks × n
    operands of the chunk) beside one torch.sum over the operands."""
    import torch
    calls = list(recorder.calls.values())
    folds = [c for c in calls if c[2].has_own]
    lands = [c for c in calls if not c[2].has_own]
    picks = [("rs fold, largest leaf", max(folds, key=lambda c: c[0][1])),
             ("ag landing, largest leaf", max(lands, key=lambda c: c[0][1])),
             ("rs fold, smallest matrix leaf",
              min((c for c in folds if c[0][1] >= 1 << 20),
                  key=lambda c: c[0][1]))]
    rows = []
    for what, (src_shape, src_dtype, table, out_shape, out_dtype) in picks:
        cases = [(f"trainer {what}: into B={table.rows.shape[0]} "
                  f"K={table.rows.shape[1]} L={src_shape[1]} "
                  f"{src_dtype}->{out_dtype}",
                  lambda: fused_reduce_into_case(src_shape, src_dtype, table,
                                                 out_shape, out_dtype, dev))]
        if what.startswith("rs fold"):
            n = table.rows.shape[0]
            cases.append((f"trainer {what}: dense ({n}, {n}, {src_shape[1]})",
                          lambda: fused_reduce_case((n, n, src_shape[1]),
                                                    src_dtype, dev)))
        for label, case in cases:
            r = measure(case())
            rows.append(("fused_reduce", label, r))
            if r["max_abs_err"] != 0.0:
                fail(f"fused_reduce {label} differs from its plain version "
                     f"by {r['max_abs_err']}")
            torch.cuda.empty_cache()
    return rows


def sync_launches(cs, buckets: int) -> dict:
    """Kernel launches of `buckets` reduce-scatters and all-gathers through
    schedule `cs` at its wire: one fold kernel a fold phase (fused_reduce
    at full precision and on the bf16 wire; on a scaled wire quant_reduce,
    or dequantize where the phase only lands copies) and, on a scaled
    wire, one quantize a live round."""
    steps = family_steps(cs, "reduce_scatter") + family_steps(cs,
                                                              "allgather")
    folds = sum(len(st.folds) for st in steps)
    if cs.wire is None or not cs.wire.scale_block:
        return {"fused_reduce": buckets * folds}
    rounds = sum(1 for st in steps for rd in st.rounds if rd.perm)
    landings = 0
    for st in steps:
        for fd in st.folds:
            act = fd.blk >= 0
            landings += int(not fd.include_self[act].any() and bool(
                ((fd.ops[act] >= 0).sum(axis=1) == 1).all()))
    return {"quantize": buckets * rounds, "dequantize": buckets * landings,
            "quant_reduce": buckets * (folds - landings)}


def phase_sync_bucketed(dev) -> dict:
    """`core.bucketing.sync_bucketed` on the card (8 local ranks, the
    planner's default pricing): full precision and the
    pinned bf16, fp8 and int8 wires (each at its error budget as the
    tolerance), each at the default bucket and at SYNC_MERGED's pinned
    one with pipeline on and off, on the smoke-size trainer's leaves and
    on SYNC_BIG's; then `execute_buckets` with a `MergedSchedule` built
    by `merge_schedules(cs, cs)` on the pinned buckets, so that the
    merged branch runs whatever the argmin picks. Each result against the plain column sum (f32 within 1e-6 of
    the largest |value|, a wire within its budget), each call's launches
    of fused_reduce, quantize, quant_reduce and dequantize exactly
    `sync_launches`. Returns the launch counts of the phase."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, overlap
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.core.sync import AxisPlan, SyncConfig
    from repro_torch.kernels import ops
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.models.tree import tree_items
    from repro_torch.planner.service import default_service

    n = TRAIN["local_ranks"]
    svc = default_service()
    smoke = build(smoke_config(get_config(TRAIN["arch"])))
    sets = {"trainer smoke leaves": [tuple(t.shape) for _, t in
                                     tree_items(smoke.params_spec())],
            SYNC_BIG[0]: SYNC_BIG[1]}
    ops.reset_launches()

    def check(what, got, want, scale, budget, before, expect):
        torch.cuda.synchronize()
        err = max(float((o.double() - w).abs().max())
                  for o, w in zip(got, want)) / scale
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                    if ops.LAUNCHES[k] != before[k]}
        log(f"sync_bucketed {what}: rel err {err:.2e} (budget {budget:g});"
            f" launches {json.dumps(launched)}, expected "
            f"{json.dumps(expect)}")
        if not err <= budget:
            fail(f"sync_bucketed {what}: rel err {err:.3e} over {budget}")
        if launched != expect:
            fail(f"sync_bucketed {what}: launches {launched}, expected "
                 f"{expect}")

    for set_name, shapes in sets.items():
        g = torch.Generator(device=dev).manual_seed(len(shapes))
        leaves = [torch.randn((n, *s), generator=g, device=dev)
                  for s in shapes]
        want = [x.double().sum(dim=0) for x in leaves]
        scale = max(float(w.abs().max()) for w in want)
        sizes = [int(x[0].numel()) for x in leaves]
        pinned = SYNC_MERGED[set_name]
        for wire in (None, "bf16", "fp8", "int8"):
            budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget
            for bb, pipeline in ((None, True), (pinned, True),
                                 (pinned, False)):
                cfg = SyncConfig(strategy="plan", bucket_bytes=bb,
                                 pipeline=pipeline, precision=wire,
                                 tolerance=None if wire is None else budget)
                bp = svc.get_bucket_plan(
                    [("data", n)], sum(sizes), config=bucketing.BucketConfig(
                        bucket_bytes=bb, pipeline=pipeline, precision=wire,
                        tolerance=cfg.tolerance))
                k = len(bucketing.partition(sizes, ["f32"] * len(sizes),
                                            bp.bucket_bytes,
                                            itemsizes=[4] * len(sizes)))
                before = dict(ops.LAUNCHES)
                stats = {}
                got = bucketing.sync_bucketed(leaves, [("data", n)], cfg,
                                              stats=stats)
                if stats["precision"] != (wire or "f32"):
                    fail(f"sync_bucketed {set_name}: the plan's wire is "
                         f"{stats['precision']}, not {wire or 'f32'}")
                check(f"{set_name} wire={wire or 'f32'} bucket_bytes={bb} "
                      f"pipeline={pipeline}: {k} bucket(s) of "
                      f"{bp.bucket_bytes} "
                      f"bytes, {stats['overlap_mode']} issuance, "
                      f"{bp.axis_plans[0].schedule.describe()}",
                      got, want, scale, budget, before,
                      sync_launches(bp.axis_plans[0].schedule, k))
                del got
        bb = pinned
        bp = svc.get_bucket_plan([("data", n)], sum(sizes),
                                 config=bucketing.BucketConfig(
                                     bucket_bytes=bb))
        cs = bp.axis_plans[0].schedule
        ms = overlap.merge_schedules(cs, cs)
        buckets = bucketing.partition(sizes, ["f32"] * len(sizes), bb,
                                      itemsizes=[4] * len(sizes))
        launches = ms.stats["launches"]
        before = dict(ops.LAUNCHES)
        got = bucketing.execute_buckets(
            leaves, buckets, [AxisPlan("data", "plan", schedule=cs)],
            merged=ms, reverse=True)
        check(f"{set_name} merged: {len(buckets)} buckets of {bb} bytes, "
              f"{ms.describe()}", got, want, scale, 1e-6, before,
              sync_launches(cs, len(buckets)))
        if ms.stats != {"launches": launches + len(buckets) - 1,
                        "failures": 0}:
            fail(f"sync_bucketed {set_name} merged: {ms.stats}, expected "
                 f"{len(buckets) - 1} more launches and no failure")
        del got, leaves, want
        torch.cuda.empty_cache()
    counts = dict(ops.LAUNCHES)
    log(f"sync_bucketed: launches {json.dumps(counts)}")
    return counts


def shard_drift(got, want, lr: float, steps: int) -> tuple[int, int, float]:
    """Final shards of two runs of the trainer from one state: (elements
    farther apart than 1e-4 of their leaf's largest |value|, elements in
    all, the largest distance over 2·lr·steps). AdamW's first update is
    about lr·sign(g), so an element whose gradient two runs round to
    opposite signs (|g| near the f32 noise of its sum) moves up to 2·lr a
    step apart; every other element follows its gradient's rounding."""
    far, total, worst = 0, 0, 0.0
    for a, b in zip(got, want, strict=True):
        d = (a.double() - b.double()).abs()
        far += int((d > 1e-4 * b.abs().max()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()) / (2 * lr * steps))
    return far, total, worst


def phase_train_reference(dev, sync=None, label: str = "per-leaf") -> None:
    """The trainer at smoke size in f32 on the card (fused_reduce on the
    card, the model in torch ops) against the same code on the CPU, from
    one state and the same batches, with `sync` (default: the per-leaf
    path): TRAIN_SMOKE_STEPS steps, per-step loss and gnorm within 1e-4
    relative, as the served smoke models are held; the final shards
    within 1e-4 of each leaf's largest |value| but for at most 1e-4 of
    their elements, those within 2·lr a step (`shard_drift`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    api = build(smoke_config(get_config(TRAIN["arch"])))
    params = api.init_params(torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
    lr, steps = TRAIN["lr"], TRAIN_SMOKE_STEPS
    runs = {str(where): train_run(api, _to(params, where),
                                  TRAIN["local_ranks"], lr, steps, 32,
                                  TRAIN["global_batch"], sync=sync,
                                  param_dtype=torch.float32)
            for where in ("cpu", dev)}
    card, cpu = runs[str(dev)], runs["cpu"]
    step = card["step"]
    buckets = (f"; {len(step.gather_buckets)} gather and "
               f"{len(step.scatter_buckets)} scatter buckets"
               if step.bucket_plan is not None else "")
    metric_err = max(abs(g - c) / abs(c) for k in ("losses", "gnorms")
                     for g, c in zip(card[k], cpu[k]))
    far, total, worst = shard_drift([t.cpu() for t in card["state"]["params"]],
                                    cpu["state"]["params"], lr, steps)
    log(f"train [{label}]: smoke-size f32 {steps} steps card vs CPU{buckets}:"
        f" losses {card['losses']} / {cpu['losses']}, gnorms "
        f"{card['gnorms']} / {cpu['gnorms']}; rel err {metric_err:.2e}; "
        f"final shards: {far} of {total} elements past 1e-4 of their "
        f"leaf's largest |value|, the farthest {worst:.3f} of 2·lr·steps")
    if not (metric_err <= 1e-4 and far <= 1e-4 * total and worst <= 1.0):
        fail(f"the card's smoke-size trainer [{label}] disagrees with the "
             f"CPU run: {metric_err:.2e}, {far} of {total} shard elements, "
             f"{worst:.3f}")
    if sync is not None and sync.bucket_bytes and min(
            len(step.gather_buckets), len(step.scatter_buckets)) < 3:
        fail(f"train [{label}]: fewer than 3 buckets a half")


def phase_train_all(dev) -> dict:
    """Phase 5: the per-leaf trainer at TRAIN's lr, then at each of
    TRAIN_FALL_LRS (the loss must fall), fused_reduce at the trainer's
    shapes; the bucketed trainer at the default plan (run (a), at the
    first of TRAIN_FALL_LRS: one bucket a half, the loss must fall, the
    per-leaf losses printed beside) and with bucket_bytes pinned to
    TRAIN_BUCKET_BYTES (run (b): its scatter buckets issued last first on
    every step); `sync_bucketed` on the card (run (c)); and the
    smoke-size trainer on the card against the CPU, per leaf and bucketed
    (run (d), TRAIN_SMOKE_BUCKET_BYTES). Returns the launch counts of the
    full-width runs and of run (c), summed."""
    import torch
    from repro_torch.core.sync import SyncConfig
    from repro_torch.runtime.trace import Tracer

    recorder = FoldRecorder()
    counts = phase_train(dev, TRAIN["lr"], False, recorder)["counts"]
    per_leaf = {}
    for lr in TRAIN_FALL_LRS:
        r = phase_train(dev, lr, True)
        per_leaf[lr] = r["losses"]
        for name, n in r["counts"].items():
            counts[name] += n
        del r
    torch.cuda.empty_cache()
    log_rows(trainer_rows(dev, recorder))
    del recorder
    torch.cuda.empty_cache()

    lr = TRAIN_FALL_LRS[0]
    r = phase_train(dev, lr, True, sync=SyncConfig(strategy="plan"),
                    label="bucketed, default plan")
    step = r["step"]
    log(f"train [bucketed, default plan]: losses {r['losses']}, the per-leaf"
        f" run's {per_leaf[lr]} at lr {lr} (printed, not gated)")
    if not (step.bucket_plan.num_buckets == 1
            and len(step.gather_buckets) == len(step.scatter_buckets) == 1):
        fail(f"train: the default plan is not one bucket: "
             f"{step.bucket_plan}")
    for name, n in r["counts"].items():
        counts[name] += n
    del r, step
    torch.cuda.empty_cache()

    tracer = Tracer(enabled=True)
    r = phase_train(dev, lr, True, sync=SyncConfig(
        strategy="plan", bucket_bytes=TRAIN_BUCKET_BYTES,
        backward_overlap=True), label="bucketed, 64 MiB", tracer=tracer)
    k = len(r["step"].scatter_buckets)
    order = [s.args["bucket"] for s in tracer.spans
             if s.name == "bucket/zero3_rs"]
    log(f"train [bucketed, 64 MiB]: {k} scatter buckets "
        f"{[bk.indices for bk in r['step'].scatter_buckets]}, issued "
        f"{order}")
    if k != 10 or order != list(range(k - 1, -1, -1)) * TRAIN["steps"]:
        fail(f"train [bucketed, 64 MiB]: {k} buckets issued {order}, "
             f"expected 10 a step, last first")
    for name, n in r["counts"].items():
        counts[name] += n
    del r, tracer
    torch.cuda.empty_cache()

    for name, n in phase_sync_bucketed(dev).items():
        counts[name] += n
    torch.cuda.empty_cache()
    phase_train_reference(dev)
    phase_train_reference(dev, SyncConfig(
        strategy="plan", bucket_bytes=TRAIN_SMOKE_BUCKET_BYTES),
        label="bucketed")
    return counts


def _case_at(wrapper, args, kw, dev):
    """The measuring case of the kernel behind `wrapper` at its recorded
    first launch: ("tensor", shape, dtype) for each data argument."""
    from repro_torch.kernels import ref
    wires = {v: k for k, v in ref.WIRE_DTYPES.items()}
    arg = lambda i, key: args[i] if len(args) > i else kw.get(key)  # noqa
    if wrapper == "fused_reduce":
        _, shape, dtype = args[0]
        return fused_reduce_case(shape, dtype, dev)
    if wrapper == "fused_reduce_into":
        (_, src_shape, src_dtype), table, (_, out_shape, out_dtype) = args[:3]
        return fused_reduce_into_case(src_shape, src_dtype, table,
                                      out_shape, out_dtype, dev)
    if wrapper == "quantize":
        _, shape, _ = args[0]
        return quantize_case(shape, arg(1, "wire") or "float8_e4m3fn", dev)
    if wrapper == "dequantize_into":
        (_, q_shape, q_dtype), _, table, (_, out_shape, out_dtype) = args[:4]
        return dequantize_into_case(q_shape, wires[q_dtype], table,
                                    out_shape, out_dtype, dev)
    if wrapper == "dequantize":
        _, (W, Lp), q_dtype = args[0]
        return dequantize_case((W, arg(3, "out_len") or Lp), wires[q_dtype],
                               dev)
    if wrapper == "quant_reduce":
        _, q_shape, q_dtype = args[0]
        own = arg(2, "own")
        return quant_reduce_case(q_shape, wires[q_dtype],
                                 0 if own is None else own[1][-1], dev)
    if wrapper == "wkv":
        (_, (B, H, T, K), _), (_, v_shape, _) = args[0], args[2]
        return wkv_case(B, H, T, K, v_shape[-1], dev)
    if wrapper == "ssm_scan":
        (_, (B, T, Di), _), (_, b_shape, _) = args[0], args[2]
        return ssm_scan_case(B, T, Di, b_shape[-1], dev)
    if wrapper == "rmsnorm":
        (_, shape, x_dtype), (_, _, w_dtype) = args[0], args[1]
        return rmsnorm_case(shape, x_dtype, w_dtype, arg(3, "offset") or 0.0,
                            dev)
    if wrapper == "flash_attention":
        (_, (B, Hq, Tq, D), dtype), (_, (_, Hkv, Tk, _), _) = args[:2]
        n = kw.get("kv_len")
        return flash_case(B, Hq, Hkv, Tq, Tk, D, dtype, dev,
                          window=kw.get("window", 0),
                          softcap=kw.get("softcap", 0.0),
                          kv_len=None if n is None else RAGGED[:B],
                          causal=kw.get("causal", True))
    (_, q_shape, q_dtype), _, table, (_, out_shape, out_dtype) = args[:4]
    return quant_reduce_into_case(q_shape, wires[q_dtype], table, out_shape,
                                  out_dtype, dev)


def kernels_line(dev, first, main_path, unlaunched) -> dict:
    """Per kernel: its launches on the main path (`main_path`, summed over
    its phases) and its measures at its first main-path launch (`first`),
    or, for a kernel the main path never launches, phase 2's result at
    its largest shape (`unlaunched`)."""
    from repro_torch.kernels import ops
    info = {
        "fused_reduce": ("src/repro_torch/kernels/csrc/fused_reduce.cu",
                         "src/repro/kernels/fused_reduce.py:58"),
        "grouped_reduce": ("src/repro_torch/kernels/csrc/fused_reduce.cu",
                           "src/repro/kernels/fused_reduce.py:95"),
        "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                     "src/repro/kernels/quant.py:81"),
        "dequantize": ("src/repro_torch/kernels/csrc/quant.cu",
                       "src/repro/kernels/quant.py:103"),
        "quant_reduce": ("src/repro_torch/kernels/csrc/quant.cu",
                         "src/repro/kernels/quant.py:147"),
        "quant_reduce_requant": ("src/repro_torch/kernels/csrc/quant.cu",
                                 "src/repro/kernels/quant.py:176"),
        "wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
                "src/repro/kernels/wkv.py:91"),
        "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:71"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:32"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:95"),
    }
    out = []
    for name, (source, replaces) in info.items():
        if name in first:
            wrapper, args, kw = first[name]
            case = _case_at(wrapper, args, kw, dev)
            shapes = [a[1] if isinstance(a, tuple) else tuple(a.rows.shape)
                      for a in args if isinstance(a, (tuple, ops.RowTable))]
            r = measure(case)
        elif main_path[name] == 0 and name in unlaunched:
            wrapper, shapes, r = unlaunched[name]
        else:
            fail(f"{name}: launched {main_path[name]} time(s) on the main "
                 f"path but no shape was recorded")
        if not within(name, r):
            fail(f"{name} ({wrapper}) at shapes {shapes} differs from its "
                 f"plain version by {r['max_abs_err']} (tolerance "
                 f"{tolerance(name, r)})")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": main_path[name],
                    **r, "wrapper": wrapper, "shapes": shapes})
    return {"kernels": out}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--attention", action="store_true",
                    help="build the kernels and run FLASH_GRID alone (the "
                    "attention rows of phase 2), then stop: no result line")
    ap.add_argument("--recurrence", action="store_true",
                    help="build the kernels and run the recurrence rows of "
                    "phase 2 alone (WKV_GRID, SSM_GRID and the state "
                    "hand-offs), then stop: no result line")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the port's source tree (default: this checkout's "
                    "src), e.g. another commit's unpacked beside it, to "
                    "time two versions on one card")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = args.src.resolve()
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} is missing: run from a checkout of "
             "the repository")
    sys.path.insert(0, str(src))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    phase_build()
    log(f"phase build done at {time.perf_counter() - t0:.1f} s")
    if args.attention:
        log(f"attention grid of {src}")
        log_rows(model_kernel_grid(dev, attention_only=True))
        log(f"attention grid done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.recurrence:
        log(f"recurrence grid of {src}")
        log_rows(recurrence_grid(dev))
        log(f"recurrence grid done at {time.perf_counter() - t0:.1f} s")
        return 0
    unlaunched = phase_kernels(dev)
    log(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels import ops
    rec_exec, rec_fam, rec_serve = (ShapeRecorder(), ShapeRecorder(),
                                    ShapeRecorder())
    executor = phase_executor(dev, rec_exec)
    log(f"phase executor done at {time.perf_counter() - t0:.1f} s")
    families = phase_families(dev, rec_fam)
    log(f"phase families done at {time.perf_counter() - t0:.1f} s")
    served = dict.fromkeys([*TOLERANCE, *ops.ATTENTION_LAUNCHES], 0)
    for arch in SERVE_ARCHS:
        for name, n in phase_serve(dev, rec_serve,
                                   {**SERVE, "arch": arch}).items():
            served[name] += n
        phase_decode_profile(dev, arch)
        log(f"phase serve {arch} done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_serve(dev, rec_serve, LONG).items():
        served[name] += n
    log(f"phase serve long {LONG['arch']} done at "
        f"{time.perf_counter() - t0:.1f} s")
    for arch in SERVE_ARCHS:
        phase_model_reference(dev, arch)
    log(f"phase serve done at {time.perf_counter() - t0:.1f} s")
    trained = phase_train_all(dev)
    log(f"phase train done at {time.perf_counter() - t0:.1f} s")
    # each kernel is timed at its first launch on the main path: the
    # server's shapes where it launched the kernel, else the executor's,
    # else the families'
    main_path = {k: executor[k] + families[k] + served[k] + trained[k]
                 for k in TOLERANCE}
    log(f"main path: flash_attention launches by CUDA kernel "
        f"{json.dumps({k: served[k] for k in ops.ATTENTION_LAUNCHES})}")
    line = kernels_line(dev, {**rec_fam.first, **rec_exec.first,
                              **rec_serve.first}, main_path, unlaunched)
    log(f"phase kernels line done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
