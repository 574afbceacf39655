#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --attention [--src OTHER/src]
    python3 chip_smoke.py --recurrence [--src OTHER/src]
    python3 chip_smoke.py --planner
    python3 chip_smoke.py --flat
    python3 chip_smoke.py --ft
    python3 chip_smoke.py --moe-train
    python3 chip_smoke.py --recurrent-train
    python3 chip_smoke.py --family-train
    python3 chip_smoke.py --census
    python3 chip_smoke.py --mp
    python3 chip_smoke.py --auto
    python3 chip_smoke.py --tp

The second and third forms build the kernels and run the attention rows
or the recurrence rows of phase 2 alone (of another source tree with
--src: two commits timed on one card in turn), the fourth the planner
phase (3c) alone, the fifth the flat collectives phase (3b2) alone, the
sixth phase 5r and phase
ft, the seventh phase 5m alone, the eighth phase 5r alone, the ninth
phase 5f alone, the tenth phase census alone (the dry run beside it),
the eleventh phase mp alone, the twelfth phase 5's per-leaf run at the
first of TRAIN_FALL_LRS, phase auto and phase mp (h), the thirteenth
phase tp alone; none prints a result line. The full run and --census
start the dry run
(`python -m repro_torch.launch.dryrun --all` on the meta device, no card
visible) in a process of its own at the start, beside the card's
phases.
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
                at the served models' prefill and decode shapes (ragged
                per-row key counts at decode; qwen3-32b's head dim 80,
                gemma3-4b's 256), the smoke widths in f32,
                gemma2-27b's long request (prefill of 4,352 tokens,
                decode against 4,360 of 4,416 cache slots, the 4096
                window masking) and gemma3-4b's (prefill of 1,152,
                decode against 1,160 of 1,168, the 1024 window
                masking), qwen2-vl-7b's GQA group 7, mixtral-8x22b's
                group 6 and whisper-large-v3's head dim 64 (its
                encoder non-causal at 32 frames and at 1,500), the
                decode kernel at long context
                (stablelm-12b's heads without a softcap, so SDPA times
                the same function; a batch of four rows of 4,360, 0,
                300 and 4,416 keys; four queries a head in f32 and
                bf16), the f32 prefill kernel past one block of query
                rows, and the bf16 prefill kernel's edges (Tq 5, 17, 33,
                129, 130; head dims 64 to 256; groups 1, 4, 5; a row
                that sees no key; windows narrower than a key tile);
                rmsnorm at 4·32 rows of every model's width (and head
                dims 80 and 256), qwen3-32b's head-transposed qk_norm
                rows at prefill and decode, both
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
  3c. planner — the rest of the planner, on PlannerService instances of
                its own: (a) the Fig.-4 curve of `TorchProvider` (x
                blocks folded by one fused_reduce launch, CUDA events
                behind a spin) at the reference's fig4_size and at 2^24
                floats, δ and γ fitted; (b) the decode and 2^26 gradient
                AllReduces observed as serve observes them, then
                `PlannerService.calibrate` on the card (backend "torch":
                Fig. 4 and the CPS AllReduce on the local mesh, every
                level), each fitted level passing `validate_params`,
                the two AllReduces fetched again, run against the column
                sum (1e-6) and observed: predicted, observed and drift
                before and after; (c) `get_plan` under exponential
                arrival skew at SKEW_SCALES on both topologies, priced on
                the fitted params, and every candidate the re-ranking
                prices (GenTree, cps, ring, rhd) lowered and run at 2^20
                f32 a rank within 1e-6; (d) `get_step_plan` on the
                reference tests' mix and on the bucketed trainer's own
                full-width step (its buckets' reduce-scatters and
                all-gathers), each family's schedule run at 2^24 f32 a
                rank against the exact answer. The phase's launches are
                counted in advance and must match exactly;
  4. serve    — `repro_torch.launch.serve` on stablelm-12b, rwkv6-1.6b,
                hymba-1.5b, gemma2-27b, qwen3-32b (qk_norm, head dim
                80), gemma3-4b (five 1024-window layers to one global,
                head dim 256), deepseek-moe-16b (64 routed experts,
                top 6, 2 shared; the sorted dispatch in 16 groups),
                qwen2-vl-7b (embeddings in, M-RoPE), whisper-large-v3
                (32 frames of stub audio through the encoder) and
                mixtral-8x22b (8 experts top 2, window 4096; its depth
                cut from 56 to SERVE_LAYERS' 14, the one cut) in turn,
                each at full width (random bf16 weights), batch 4,
                prompt 32, 32 new tokens, cache 128, 8 local ranks;
                after each, a few decode steps of the same model under
                torch.profiler (device busy share, kernels per step,
                weight-read bound); then one long gemma2-27b request
                (batch 1, prompt 4,352, 8 new tokens, cache 4,416) and
                one long gemma3-4b request (batch 1, prompt 1,152, 8
                new, cache 1,168), so the local layers' window masks in
                prefill and decode; one whisper-large-v3 request on
                1,500 frames (30 s of audio; batch 4, prompt 32, 8 new)
                through the model API, its encoder non-causal on the
                bf16 prefill kernel at 1,500 keys; each model is freed
                before the next; then each model's smoke-size version
                in f32 on the card against the same code on the CPU
                (gemma2-27b on a 48-token prompt, gemma3-4b on a
                40-token one and mixtral-8x22b on 4 × 40, longer than
                their smoke windows; deepseek-moe-16b on 4 × 64 tokens
                and mixtral-8x22b's 160, whose grouped dispatch drops
                slots on both; qwen2-vl-7b at head dim 32 with three
                distinct position streams, so M-RoPE's h and w
                sections turn; whisper-large-v3 on 12 seeded frames);
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
                1e-4, the final shards as `shard_drift` says), per leaf
                over TRAIN_MESH and bucketed on the fp8 wire. Between
                (b) and (c), at the first of TRAIN_FALL_LRS
                (`phase_train_levels`): the trainer over the two-level
                local mesh TRAIN_MESH, (pod 2, data 4), with
                `SyncConfig(strategy="plan")`, whose bucketed request
                takes the per-leaf path there, one plan a level; then
                per leaf on 8 ranks with each wire of TRAIN_WIRES (each
                rank forwards its own gathered copy) at depth
                TRAIN_LOSSY_LAYERS, the gap to the f32 wire's losses
                printed. Each: finite and falling losses, each kernel's
                launches exactly `level_launches` (a schedule's per
                group of the other axis), the gather's and
                reduce-scatter's device ms beside their byte bounds
                (`level_bytes`), the peak memory and the wall time;
  5m. moe train — MoE training (`phase_train_moe`): the ZeRO-3 trainer on
                deepseek-moe-16b at full width, its depth cut to 2 of 28
                layers (TRAIN_MOE; 64 experts, top 6, 2 shared), random
                bf16 weights, 8 local ranks, seq 128, global batch 8, 3
                steps at lr 1e-4 (the loss must fall), per leaf with
                `SyncConfig(strategy="plan", bucket_bytes=0)`: the
                reference's expert-parallel dispatch over "data" (8
                experts a rank) with its exchange on the guarded planned
                all-to-all. Prints the step time and its parts beside
                `train_bounds`, each exchange's device ms (CUDA events
                around it) beside its byte bound and the standalone
                exchange beside the same, the peak memory, the slots
                dropped a step and the smallest top-k margin, and checks
                the exact fused_reduce launches: the gathers' and
                reduce-scatters' fold phases, plus the exchanges' (2 a
                MoE layer in the forward, 2 in its recompute, 2 in the
                backward, each the schedule's fold phases), counted
                apart; no other kernel; the peak under TRAIN_PEAK_GIB
                (the full-width body is phase 5r's and 5f's,
                `train_full_width`). Then the smoke-size trainer (8
                experts, top 2, 1 shared) in f32 on the card against the
                CPU, per leaf, EP over one axis (8 ranks) and over
                TRAIN_MESH ("pod" is the EP axis): per-step loss and
                gnorm within 1e-4, equal drops, exact launches (none on
                the CPU);
  5r. recurrent train — the recurrent families' training
                (`phase_train_recurrent`): rwkv6-1.6b, then hymba-1.5b,
                through the ZeRO-3 trainer at full width, rwkv6-1.6b at
                8 of 24 layers and hymba-1.5b at 4 of 32
                (TRAIN_RECURRENT), random bf16 weights,
                8 local ranks, seq 128, global batch 8, 3 steps at lr
                1e-4 (the loss must fall), per leaf with
                `SyncConfig(strategy="plan", bucket_bytes=0)`; their
                recurrences run as torch ops (the chunked WKV, the
                chunk-checkpointed SSM scan). Prints the losses, step
                time and its parts beside `train_bounds`, the peak
                memory, and checks the exact fused_reduce launches
                (`level_launches`) and that wkv, ssm_scan, rmsnorm and
                flash_attention launch 0 times; then one rank's forward
                and backward under torch.profiler (kernels, device busy
                share, top kernels), and the smoke-size trainer (48
                tokens) in f32 on the card against the CPU: per-step
                loss and gnorm within 1e-4, exact launches (none on the
                CPU);
  5f. family train — the last three configurations' training
                (`phase_train_family`, TRAIN_FAMILY): qwen2-vl-7b at full
                width, its depth cut to 3 of 28 layers, on 8 local ranks
                (its stub embeddings in f32 and three M-RoPE streams, as
                the trainer's pipeline gives them); whisper-large-v3
                at 8 of 32 encoder and 8 of 32 decoder layers (32 stub
                frames) on 8 ranks; mixtral-8x22b at full width, its depth cut to
                1 of 56, on 4 ranks (8 experts top 2, window 4096;
                expert-parallel over the 4, two experts a rank, the
                exchange the guarded planned all-to-all), each from
                random bf16 weights, seq 128, global batch 8, 3 steps at
                lr 1e-4 (the loss must fall), per leaf with
                `SyncConfig(strategy="plan", bucket_bytes=0)`. Prints the
                losses, the step time and its parts beside
                `train_bounds` (whisper's counting its encoder and
                cross-attention), the peak memory beside its reckoning
                (under TRAIN_PEAK_GIB, or the run fails), and checks the
                exact fused_reduce launches (`level_launches`; mixtral's
                with its exchanges', `moe_launches`) and that wkv,
                ssm_scan, rmsnorm and flash_attention launch 0 times;
                then each model's smoke-size trainer (48 tokens; qwen2-vl
                at head dim 32 with its streams drawn apart; mixtral past
                its smoke window, EP over 8) in f32 on the card against
                the CPU: per-step loss and gnorm within 1e-4, the same
                slots dropped, exact launches (none on the CPU);
  auto     — the auto engine (`launch.train.make_train_step`: no
                planner; DTensor placements and torch.distributed's
                collectives over processes; `phase_auto`). (a) the
                smoke stablelm-12b (vocab 4,096, so that its embedding
                and head shard over processes) in f32 on the card
                against the CPU, 3 steps: losses and gnorms within 1e-4,
                no kernel launched (`ops.LAUNCHES` unchanged); (b)
                stablelm-12b at full width, depth 2 of 40, bf16, seq
                128, global batch 8, 3 steps at lr 1e-4 on the card:
                the loss falling, no kernel launched, the step (host
                clock), forward + backward and AdamW (CUDA events)
                beside `rank_bounds` and AdamW's 22 bytes a parameter,
                the peak, and phase 5's per-leaf manual step from the
                same run on the same line;
  mp       — the process mesh, one process a rank over
                torch.distributed, every rank on this card with the gloo
                backend (each round's bytes staged through pinned host
                memory: its times are host staging, not links;
                `phase_mp`). The parent frees its cached card memory,
                and the ranks load the kernels phase 1 built. (b) the
                trainer: stablelm-12b at full width, depth 1 of 40, 4
                processes, sync plan per leaf, bucketed, and per leaf on
                (pod 2, data 2), 3 steps at lr 1e-4, global batch 8, seq
                128, each run first on the 4-rank local mesh in this
                process: losses and gnorms equal to every digit (or
                within MP_TRAIN_GAP, printed), the ranks' step-1
                gathered copies equal (checksums), the loss falling,
                each rank's launches equal to `dist_launches`, each
                process's peak and their sum (under TRAIN_PEAK_GIB);
                (a) the executor: 8 processes, GenTree, cps and ring on
                single_switch(8) and symmetric_tree(2,4) and the
                planner's all-to-all and p2p schedules at MP_SIZES, each
                entry point in f32 and every wire: every rank's result
                equal to `run_local`'s row on the card (checksums),
                `run_local` within the wire's budget, each rank's
                launches equal to `dist_launches`, the 2²⁴ AllReduces
                timed; (c) `observe_sync_probe` (predicted against
                observed) and `measure_dist_cps` on the same 8
                processes; (d) with two cards or more, (a) and (c) again
                over NCCL, one card a rank, else a line saying why not;
                (h) the auto engine on the 4 trainer processes
                (`phase_mp_auto`): AUTO_SMOKE with FSDP and ZeRO-1,
                each rank's losses and gnorms within 1e-5 of phase auto
                (a)'s card run and its local tensors its slice of (a)'s
                state within 1e-4 of each leaf's largest |value|, no
                kernel launched; AUTO_FULL at (b)'s depth with FSDP,
                each process's
                step, its parts and its peak beside (b)'s per-leaf
                manual step (gloo through the host: host staging, not
                links); over NCCL too with a card a rank, else a line
                saying why not;
  tp       — tensor parallelism on the auto engine's "model" axis
                (`phase_tp`): 4 processes on this card over gloo
                through the host, each rank multiplying its slice of
                every weight "model" shards, the partial products and
                cotangents exchanged over its model line. (a) TP_SMOKE,
                the smoke stablelm-12b widened (vocab 4,096, d_ff 2,048:
                its embedding, head, gate, up and down products shard on
                "model") in f32, 3 steps, on (data 2, model 2) and on
                (data 1, model 4): each rank's losses and gnorms within
                TP_TOL (1e-5) of the same model on one card, no kernel
                launched; (b) stablelm-12b at full width, depth 1 of 40
                (mp (h)'s), bf16, seq 128, global batch 8, 2 steps on
                (data 2, model 2): losses finite and equal on every
                rank, no kernel launched, each process's step, its
                parts, the bytes it sent over its model line a step and
                its peak beside mp (h)'s FSDP run's (and under it);
                over NCCL too with a card a rank, else a line saying
                why not;
  ft       — checkpoints and fault tolerance: `run_training` with a
                checkpoint directory (FaultTolerantLoop; checkpoints
                under build/, removed after). (a) phase 5r's hymba-1.5b
                run (FT_ARCH at full width, depth 4; the same weights and
                batches) for 4 steps, a checkpoint every 2, against the
                same run without faults: a device loss at step 3 and a
                corrupted payload in a reduce-scatter of step 3's
                second attempt, each a step past the checkpoint of step
                2, each restored in place and replayed; its losses by
                step equal the fault-free run's, whose first 3 equal
                phase 5r's, to every digit, and its fused_reduce
                launches the step calls' and the failed attempt's
                (`phase_ft`); the
                checkpoint's bytes, host snapshot, write + CRC, restore
                (checksum pass, read, copy to the card) with GB/s, the
                device peak during the restore, the disk's free space;
                (b) the smoke soak (bf16, TRAIN_SMOKE_BUCKET_BYTES, 12
                steps, a checkpoint every 3): a delay, two device
                losses, a root_sw sag and its restore, a corrupted
                newest checkpoint the restore falls back past and one
                corrupted payload at a guarded gather, against the same
                run without faults: the final state bit for bit, 3
                restarts, a checkpoint fallback, a guarded failure, no
                degraded level left, no demotion, exact launches;
  census   — the step census and the dry run (`phase_census`): phase 5's
                per-leaf stablelm-12b step on the card inside
                `launch.analysis.census(8)`, its collectives (one
                all-gather and one reduce-scatter a leaf, the two
                metrics' pmeans) and their per-rank payloads exactly as
                `level_bytes` pads the leaves, its launches those of the
                step before; its FLOPs beside `train_bounds`' product
                count, its peak live bytes beside
                `torch.cuda.max_memory_allocated()`, the step's time with
                and without the census; one full-width stablelm-12b
                decode step censused (kernel calls equal to launches);
                one smoke-size decode step of each CENSUS_DECODE_ARCHS
                model on the card and on the CPU with equal kernel work;
                and the dry run's 35 supported cells, one line each, its
                wall time.

The main path is phases 3, 3b, 3c, 4, 5, 5m, 5r, 5f, mp, ft and census
(phases auto, mp (h) and tp launch no kernel, checked)
(phase mp's launches those of every process, summed): every
launch count is zeroed just before the executor, the families, the
planner, each served run, each full-width training run (the MoE,
recurrent and phase 5f ones too), the
`sync_bucketed` runs and each run of phase ft, and read just after. The executor must launch fused_reduce, quantize, quant_reduce and
dequantize (it runs the compressed wires), the families dequantize;
grouped_reduce and quant_reduce_requant have no caller on the main path
(nor in the JAX package) and show 0 launches, timed in phase 2 at their
2^26 shape; every served run must launch fused_reduce (the
decode AllReduce folds through it; the whisper request through the
model API runs no self-check and none) and exactly the model kernels its
forwards (prefill and each decode step) run: rmsnorm once per norm (2 a
dense, MoE or vlm layer, 2 more with qk_norm, 3 an RWKV6 layer, 4 a Hymba
layer, and the final norm; 3 a whisper decoder layer, and in its prefill
2 an encoder layer and the encoder's final norm),
flash_attention once per attention layer (whisper's encoder layers in
its prefill), wkv once per RWKV6 layer and
ssm_scan once per Hymba layer (`expected_launches`), and each
flash_attention launch on the CUDA kernel its shape selects (the
prompt's on the bf16 prefill kernel, each decode step's on the decode
kernel, `ops.ATTENTION_LAUNCHES`); each training run must launch
fused_reduce exactly steps × (its all-gathers × the all-gather's fold
phases + its reduce-scatters × the reduce-scatter's) and no other
kernel (the training forward runs torch ops, as the
reference's runs XLA ops; the MoE run adds its exchanges' fold phases),
with no guard demotion anywhere and no guard
failure but the one phase ft injects (the guard raises rather than
demote: a failure ends the run, or in phase ft's loop a restore). The last lines are the per-kernel JSON (launches
on the main path; time, plain time, bound and yardstick of the wrapper
call of the kernel's first launch in phase 4, or in phase 3 or 3b for a
kernel phase 4 does not launch, or phase 2's 2^26 case for one the main
path never launches), the card's name and power limit, and
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
SERVE_ARCHS = ("stablelm-12b", "rwkv6-1.6b", "hymba-1.5b", "gemma2-27b",
               "qwen3-32b", "gemma3-4b", "deepseek-moe-16b", "qwen2-vl-7b",
               "whisper-large-v3", "mixtral-8x22b")
# the one served configuration cut in depth: mixtral-8x22b at full width,
# its 56 layers cut to the deepest that stays under 70 GiB of peak on the
# card. A layer is 2.504 B parameters (24 expert matrices of 6144 x
# 16384 and 88 M of attention), 5.008 GB in bf16; the embeddings 0.81 GB;
# drawing one (8, 6144, 16384) expert leaf holds it in f32 (3.22 GB) as
# well: 14 layers reckon at 66.05 GiB held, ≈ 69.1 GiB at peak
SERVE_LAYERS = {"mixtral-8x22b": 14}
# the tokens each SERVE request served in phase 4, by arch (phase mp's
# server on processes must serve them again)
SERVED_TOKENS: dict = {}
# one long request after the batch: its prompt is longer than gemma2-27b's
# 4096 window, so the local layers mask in prefill and decode
LONG = dict(arch="gemma2-27b", batch=1, prompt_len=4352, max_new=8,
            cache_len=4416, local_ranks=8)
# and one past gemma3-4b's 1024 window (its local layers, five in six)
LONG_GEMMA3 = dict(arch="gemma3-4b", batch=1, prompt_len=1152, max_new=8,
                   cache_len=1168, local_ranks=8)
# whisper-large-v3 on 30 s of audio (N_AUDIO_FRAMES = 1,500 frames of stub
# embeddings) through the model API: its encoder's non-causal attention
# at (4, 20/20, 1500, 1500, 64) on the bf16 prefill kernel
WHISPER_LONG = dict(arch="whisper-large-v3", batch=4, prompt_len=32,
                    max_new=8, cache_len=48)
# per family, what one forward launches per layer: its norms (ln1 and
# ln2; RWKV6 adds ln_x, Hymba ln_attn and ln_ssm; qk_norm two more), its
# attention and its recurrence kernel; the final norm comes on top. The
# MoE layer (router, expert products) launches none of the ten kernels.
# The encoder-decoder ("audio") has a rule of its own (`expected_launches`):
# its prefill runs the encoder too, and cross-attention is torch ops.
NORMS_PER_LAYER = {"dense": 2, "moe": 2, "vlm": 2, "ssm": 3, "hybrid": 4}
ATTENTION_PER_LAYER = {"dense": 1, "moe": 1, "vlm": 1, "ssm": 0,
                       "hybrid": 1}
RECURRENCE = {"ssm": "wkv", "hybrid": "ssm_scan"}
PROFILE_STEPS = 4                # decode steps traced after serving
# (batch, prompt, cache) of the smoke-size model held card against CPU:
# gemma2-27b, gemma3-4b and mixtral-8x22b past their smoke windows;
# deepseek-moe-16b's 256 tokens and mixtral-8x22b's 160 through the
# grouped dispatch (16 groups), where slots drop
REFERENCE_RUN = {"gemma2-27b": (2, 48, 64), "gemma3-4b": (2, 40, 48),
                 "deepseek-moe-16b": (4, 64, 72),
                 "mixtral-8x22b": (4, 40, 48)}
# smoke-size overrides of that run: qwen2-vl-7b at head dim 32, where the
# rotary half reaches M-RoPE's h and w sections (at the smoke 16 every
# lane takes the t stream); its three position streams are drawn apart
REFERENCE_CFG = {"qwen2-vl-7b": {"d_head": 32}}
REFERENCE_FRAMES = 12            # whisper's stub frames in that run
# the trainer: stablelm-12b at full width with its depth cut from 40 to 2
# layers (the one cut), 8 local ranks, the reference TrainConfig's
# sequence, global batch and lr; then the same run at each lr of
# TRAIN_FALL_LRS, over which the loss must fall
TRAIN = dict(arch="stablelm-12b", layers=2, steps=3, seq_len=128,
             global_batch=8, lr=1e-3, local_ranks=8)
TRAIN_FALL_LRS = (1e-4,)
# MoE training (phase 5m): deepseek-moe-16b at full width, its depth cut
# from 28 to 2 layers (the one cut: the run peaks at 52.7 GiB at 2; each
# layer more adds ≈ 18 GB of state and gradient rows and widens the
# largest leaf's gather, ≈ 76 GB at 3), 8 local ranks, the reference
# TrainConfig's sequence and global batch, lr 1e-4
TRAIN_MOE = dict(arch="deepseek-moe-16b", layers=2, steps=3, seq_len=128,
                 global_batch=8, lr=1e-4, local_ranks=8)
# recurrent training (phase 5r): (arch, depth or None for the
# configuration's) at full width, their depth cut for the script's time
# (the step is host dispatch, ≈ 40 µs a kernel: at full depth rwkv6-1.6b's
# 24 layers took 20-27 s of it and hymba-1.5b's 32 took 59 s): rwkv6-1.6b
# at 8 of 24, hymba-1.5b at 4 of 32; the trainer's shapes, lr 1e-4, per
# leaf. Phase ft (a) and phase mp (g) run the hymba-1.5b configuration
# through their checkpoints
TRAIN_RECURRENT = dict(runs=(("rwkv6-1.6b", 8), ("hymba-1.5b", 4)),
                       steps=3, seq_len=128, global_batch=8, lr=1e-4,
                       local_ranks=8)
# the checkpointed runs' model (phase ft (a), phase mp (g)): hymba-1.5b at
# full width and phase 5r's depth, 2.95 GB of state (bf16 weights and f32
# moments). stablelm-12b's depth-2 state is 15.83 GB, two thirds of it the
# embedding and head of its 100,352-token vocabulary, which no depth cut
# shrinks; its checkpoints and restores took 150-200 s of the disk in
# each of the two phases
FT_ARCH = "hymba-1.5b"
# the last three configurations' training (phase 5f), per leaf at lr
# 1e-4: (arch, depth or None for the configuration's, local ranks; an
# encoder-decoder's encoder cut to the same depth). The
# reckoning (`family_reckon_bytes`): the ZeRO-3 state (10 B a parameter),
# the ranks' bf16 gradient rows (2n B) and one gathered copy (2 B), with
# ≈ 11-12 GiB above that at peak (phases 5 and 5m). qwen2-vl-7b at depth 3
# of 28: 1.789 G parameters, 46.7 GiB (at depth 4, 2.022 G and 52.7 GiB,
# the run peaked at 69.05 GiB with expandable segments, and under the
# default allocator failed the first 545 M leaf's 7.11 GiB reduce-scatter
# stage with 60.94 GiB allocated and 15.79 GiB reserved in fragments);
# whisper-large-v3 at 8 + 8 of 32 + 32 layers (uncut, 2.020 G and 52.7
# GiB, its host-bound step took 36 s of the script's time for 3 steps);
# mixtral-8x22b at depth 1 of
# 56 (2.907 G) does not fit on 8 ranks (75.8 GiB before any temporary),
# on 4 it reckons 54.1 GiB, EP over the 4 with two experts a rank
TRAIN_FAMILY = dict(runs=(("qwen2-vl-7b", 3, 8), ("whisper-large-v3", 8, 8),
                          ("mixtral-8x22b", 1, 4)),
                    steps=3, seq_len=128, global_batch=8, lr=1e-4)
TRAIN_PEAK_GIB = 70.0  # full-width training (5m, 5r, 5f) peaks under this
# phase mp, the process mesh (one process a rank, gloo through the host
# on this card): (a) the executor's ranks, plans and sizes a rank; (b)
# the trainer (stablelm-12b at full width, depth cut to 1 of 40, where
# phase 5 runs 2: each step's gather and reduce-scatter go through the
# host, and a layer is 0.28 G of its 1.31 G parameters; 4 processes), its
# runs (label, mesh axes, sync) and the
# largest relative gap allowed from the local mesh's losses and gnorms
# should they not be equal; (c) the probe's size and the CPS curve; the
# deadline of each spawn
MP_RANKS = 8
MP_SIZES = ((4 * 5120, "decode 4x5120"), (1 << 24, "gradient 2^24"))
MP_PLANS = ("gentree", "cps", "ring")
MP_TRAIN = dict(arch="stablelm-12b", layers=1, procs=4, steps=3, lr=1e-4,
                seq_len=128, global_batch=8)
MP_TRAIN_RUNS = (("per-leaf", (("data", 4),), {"bucket_bytes": 0}),
                 ("bucketed", (("data", 4),), {"bucket_bytes": None}),
                 ("(pod 2, data 2) per-leaf", (("pod", 2), ("data", 2)),
                  {"bucket_bytes": 0}))
MP_TRAIN_GAP = 1e-5
MP_PROBE_FLOATS = 1 << 20
MP_CPS = dict(ns=(2, 4, 8), sizes=(1 << 16, 1 << 20, 1 << 22))
MP_TIMEOUT_S = 600.0
# (a') on the 8 executor processes, at MP_SIZES: `allreduce_planned`'s
# routes (label, kwargs; "bucketing" the default BucketConfig), then the
# int8 CPS AllReduce and sync_gradients(compress="int8") on cps
MP_PLANNED = (("plan f32", {}), ("plan bf16 wire", {"precision": "bf16"}),
              ("plan fp8 wire", {"precision": "fp8"}),
              ("bucketed", {"bucketing": True}))
# (e) the server on MP_SERVE_PROCS processes (axis "model"): SERVE's
# request of stablelm-12b at full size, served by rank 0; each rank runs
# the decode schedule SERVE_SCHEDULE_RUNS times (the self-check, then
# three timed runs: `launch.serve`)
MP_SERVE_ARCH = "stablelm-12b"
MP_SERVE_PROCS = 4
SERVE_SCHEDULE_RUNS = 4
# (f) deepseek-moe-16b at full width, depth 2 of 28, on the 4 trainer
# processes, EP over ("data", 4) (16 routed experts a rank), "plan" per
# leaf
MP_MOE = dict(arch="deepseek-moe-16b", layers=2, steps=3, lr=1e-4,
              seq_len=128, global_batch=8)
# (g) the fault loop on the 4 trainer processes: FT_ARCH at full width
# and phase 5r's depth (MP_FT["model"]: a quarter of its 2.95 GB state a
# rank), per leaf, through `run_training`, its 5 steps with a
# checkpoint every 2 (under build/, removed after); at step 4
# `file_corrupt` clobbers rank 0's member of step 4, then a device loss:
# every rank restores step 2 (the newest step every rank verifies) and
# replays; the step calls that complete; held against the same run
# without faults on the same processes (the same weights and batches)
MP_FT = dict(model=dict(arch=FT_ARCH,
                        layers=dict(TRAIN_RECURRENT["runs"])[FT_ARCH],
                        steps=5, lr=1e-4, seq_len=128, global_batch=8),
             ckpt_every=2, restored=2,
             calls=[0, 1, 2, 3, 2, 3, 4],
             events=(("file_corrupt", 4, "checkpoint", 0.0),
                     ("device_loss", 4, "", 0.0)))


# phase auto, the auto engine (`launch.train.make_train_step`, no planner,
# torch.distributed's own collectives): (a) the smoke stablelm-12b in f32,
# its vocabulary widened to 4,096 so that its embedding and head (64 x
# 4,096) reach sharding.REPLICATE_BELOW and shard over processes (every
# smoke leaf replicates otherwise), seq 32, global batch 8, on one card
# against the CPU; (b) stablelm-12b at full width, depth cut from 40 to 2
# (phase 5's cut), bf16, the trainer's seq and global batch, lr 1e-4, one
# card. Phase mp (h) runs (a) on 4 processes (FSDP and ZeRO-1) and (b)
# at MP_TRAIN's depth (1, as the manual step beside it) on 4 processes
# (FSDP), each over gloo through the host
AUTO_SMOKE = dict(arch="stablelm-12b", overrides={"vocab": 4096}, steps=3,
                  seq_len=32, global_batch=8, lr=1e-3)
AUTO_FULL = dict(arch="stablelm-12b", layers=2, steps=3, seq_len=128,
                 global_batch=8, lr=1e-4)
AUTO_CPU_TOL = 1e-4      # (a) card against CPU, losses and gnorms
AUTO_MP_TOL = 1e-5       # (h) each rank against (a)'s card run
# (h) each rank's final local tensors against its slice of (a)'s, of each
# leaf's largest |value|: AdamW divides each gradient element by its own
# running RMS, so an element whose gradient is near zero (an embedding
# row of a rare token) turns a summation-order difference of 1e-7 into
# a part of its step, lr 1e-3 (2.5e-5 measured on the CPU, one element
# of 32,768: tests/test_torch_dist_auto.py's PARAM_TOL)
AUTO_MP_PARAM_TOL = 1e-4
# phase tp, tensor parallelism on the auto engine's "model" axis
# (`phase_tp`; 4 processes on this card over gloo through the host): (a)
# TP_SMOKE, the smoke stablelm-12b widened (vocab 4,096 and d_ff 2,048, so
# that its gate, up and down products, its embedding and its head shard
# on "model"; AUTO_SMOKE's model replicates its layers), in f32 on each of
# TP_MESHES, each rank's losses and gnorms within TP_TOL of a one-card run
# of the same model made in the phase; (b) AUTO_FULL at full width, its
# depth cut to MP_TRAIN's 1 of 40 (mp (h)'s), bf16, TP_FULL_STEPS steps
# on the first of TP_MESHES
TP_SMOKE = dict(AUTO_SMOKE, overrides={"vocab": 4096, "d_ff": 2048})
TP_MESHES = ((("data", 2), ("model", 2)), (("data", 1), ("model", 4)))
TP_FULL_STEPS = 2
TP_TOL = 1e-5
# each process's peak in mp (h)'s FSDP run at full width over gloo (the
# same depth as phase tp (b)'s), which phase tp prints beside its own
MP_AUTO_PEAKS: list = []
# phase census: the smoke-size models whose decode step's kernel work the
# card and the CPU must count alike; the dry run's output directory and
# the most it may take from its start (it runs beside every earlier
# phase)
CENSUS_DECODE_ARCHS = ("stablelm-12b", "gemma2-27b", "rwkv6-1.6b",
                       "hymba-1.5b")
DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_BUDGET_S = 900.0
# the per-leaf trainer's other sync labels, at the first of TRAIN_FALL_LRS
TRAIN_FLAT = ("ring", "rhd", "cps", "hcps", "gentree", "auto")
TRAIN_SMOKE_STEPS = 3            # smoke-size f32 steps, card against CPU
# the bucketed trainer's pinned bucket: 10 buckets of the full-width leaves
TRAIN_BUCKET_BYTES = 64 << 20
TRAIN_SMOKE_BUCKET_BYTES = 32768  # 10 buckets of the smoke-size leaves
# phase 5's two-level runs: TRAIN at the first of TRAIN_FALL_LRS over the
# (pod 2, data 4) local mesh, sync "plan" (bucketed by default, which the
# reference takes per leaf on two axes); then the lossy wires, per leaf on
# 8 ranks, at TRAIN_LOSSY_LAYERS (the memory reckoning: 8 gathered copies
# of the full-width weights on top of the per-leaf run's peak)
TRAIN_MESH = [("pod", 2), ("data", 4)]
TRAIN_WIRES = ("fp8", "int8")
TRAIN_LOSSY_LAYERS = 2
# phase 3b2's bucketed (pod 2, data 4) rows: each rank's data in 8 leaves,
# at the default bucket and at this pinned one
FLAT_TWO_AXIS_BUCKET = 64 << 10
# phase ft, the checkpointed trainer (`run_training` with a checkpoint
# directory): (a) TRAIN at the first of TRAIN_FALL_LRS per leaf, FT_FULL's
# steps, a checkpoint every FT_FULL["ckpt_every"], a device loss at
# FT_FULL["loss_at"], then a payload corruption at reduce-scatter
# FT_FULL["scatter"] of the attempt after FT_FULL["after"] completed step
# calls (the second of step FT_FULL["loss_at"]); FT_FULL["calls"] the step
# calls that complete; (b) the smoke soak, bf16, bucketed at
# TRAIN_SMOKE_BUCKET_BYTES: the reference soak's fault mix
# (tests/test_faults.py) at half its steps, (kind, at, target, magnitude),
# plus one payload corruption in the gather of bucket FT_SOAK["bucket"]
# of the first run of step 8, after FT_SOAK["after"] completed step calls
FT_FULL = dict(steps=4, ckpt_every=2, loss_at=3, after=4, scatter=5,
               calls=[0, 1, 2] + [2] + [2, 3])
FT_SOAK = dict(steps=12, ckpt_every=3, after=9, bucket=5, events=[
    ("delay", 2, "", 0.02), ("device_loss", 4, "", 0.0),
    ("link_degrade", 7, "root_sw", 0.5), ("link_restore", 9, "root_sw", 0.0),
    ("file_corrupt", 10, "checkpoint", 0.0), ("device_loss", 11, "", 0.0)],
    calls=[0, 1, 2, 3] + [3, 4, 5, 6, 7] + [6, 7, 8, 9, 10]
    + [6, 7, 8, 9, 10, 11])
# sync_bucketed's leaves beside the trainer's smoke-size ones: 2^26 f32
# a rank in 8 leaves; and the pinned bucket bytes of its merged runs
SYNC_BIG = ("2^26 f32 a rank in 8 leaves", [(1 << 23,)] * 8)
SYNC_MERGED = {"trainer smoke leaves": 4096, SYNC_BIG[0]: 64 << 20}
# the planner phase: the Fig.-4 fold sizes (floats; the reference's
# default fig4_size and 2^24), the calibration's Fig.-4 size, the arrival
# skew scales (s, exponential) and the f32 a rank at which every
# candidate the re-ranking prices runs, the step plans' mixes (the
# reference tests' MIX of tests/test_families.py; the bucketed trainer's
# own step is read off its BucketPlan) and the f32 a rank at which each
# family's schedule runs
PLANNER_FIG4_SIZES = (1e6, 1 << 24)
PLANNER_CAL_FIG4 = 1 << 24
SKEW_SCALES = (1e-5, 1e-2)
SKEW_SIZE = 1 << 20
STEP_MIX = {"allreduce": {"count": 4, "size_floats": 1 << 20},
            "reduce_scatter": {"count": 2, "size_floats": 1 << 18},
            "allgather": {"count": 2, "size_floats": 1 << 18},
            "all_to_all": {"count": 6, "size_floats": 1 << 16},
            "p2p": {"count": 1, "size_floats": 1 << 14}}
STEP_SIZE = 1 << 24
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
                 last_token=False, heads=False):
    """The rmsnorm kernel on x `shape` ~ N(0, 3²) and w ~ N(0, 0.5²), or
    with `last_token` on the strided rows x[:, -1:] of such an x (B, T,
    D), as the models' final norm after prefill (`last_token ==
    "misaligned"`: of such an x laid one element past a 16-byte
    boundary), or with `heads` on the (B, H, T, hd) `shape` as the head
    transpose of a (B, T, H, hd) tensor, as qk_norm passes it; the
    yardstick is `F.rms_norm` with (offset + w) formed beforehand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape) + (last_token == "misaligned")
    x = (torch.randn((n,), generator=g, device=dev) * 3.0).to(x_dtype)
    if heads:
        B, H, T, hd = shape
        x = x[n - math.prod(shape):].view(B, T, H, hd).transpose(1, 2)
    else:
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
# per-row key counts, and (where a row ends with it) causal=False
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
    # the served shapes of qwen3-32b (head dim 80, the decode kernel's
    # 128 template), gemma3-4b (head dim 256; window 1024 and global) and
    # deepseek-moe-16b, and gemma3-4b's long request
    ("qwen3-32b prefill", (4, 64, 8, 32, 32, 80), "bf16", 0, 0.0, None),
    ("qwen3-32b decode", (4, 64, 8, 1, 128, 80), "bf16", 0, 0.0, RAGGED),
    ("gemma3-4b prefill local", (4, 8, 4, 32, 32, 256), "bf16", 1024, 0.0,
     None),
    ("gemma3-4b prefill global", (4, 8, 4, 32, 32, 256), "bf16", 0, 0.0,
     None),
    ("gemma3-4b decode local", (4, 8, 4, 1, 128, 256), "bf16", 1024, 0.0,
     RAGGED),
    ("gemma3-4b decode global", (4, 8, 4, 1, 128, 256), "bf16", 0, 0.0,
     RAGGED),
    ("deepseek-moe-16b prefill", (4, 16, 16, 32, 32, 128), "bf16", 0, 0.0,
     None),
    ("deepseek-moe-16b decode", (4, 16, 16, 1, 128, 128), "bf16", 0, 0.0,
     RAGGED),
    ("gemma3-4b long local", (1, 8, 4, 1152, 1152, 256), "bf16", 1024, 0.0,
     None),
    ("gemma3-4b long global", (1, 8, 4, 1152, 1152, 256), "bf16", 0, 0.0,
     None),
    ("gemma3-4b long decode local", (1, 8, 4, 1, 1168, 256), "bf16", 1024,
     0.0, [1160]),
    ("gemma3-4b long decode global", (1, 8, 4, 1, 1168, 256), "bf16", 0,
     0.0, [1160]),
    # the served shapes of qwen2-vl-7b (GQA group 7), mixtral-8x22b (group
    # 6, its 4096 window) and whisper-large-v3 (group 1, head dim 64): the
    # encoder's non-causal prefill at the served 32 frames and at 1,500
    # (30 s of audio), the decoder's causal prefill and its decode
    ("qwen2-vl-7b prefill", (4, 28, 4, 32, 32, 128), "bf16", 0, 0.0, None),
    ("qwen2-vl-7b decode", (4, 28, 4, 1, 128, 128), "bf16", 0, 0.0,
     RAGGED),
    ("mixtral-8x22b prefill", (4, 48, 8, 32, 32, 128), "bf16", 4096, 0.0,
     None),
    ("mixtral-8x22b decode", (4, 48, 8, 1, 128, 128), "bf16", 4096, 0.0,
     RAGGED),
    ("whisper-large-v3 encoder", (4, 20, 20, 32, 32, 64), "bf16", 0, 0.0,
     None, False),
    ("whisper-large-v3 encoder 1500 frames", (4, 20, 20, 1500, 1500, 64),
     "bf16", 0, 0.0, None, False),
    ("whisper-large-v3 decoder prefill", (4, 20, 20, 32, 32, 64), "bf16", 0,
     0.0, None),
    ("whisper-large-v3 decode", (4, 20, 20, 1, 128, 64), "bf16", 0, 0.0,
     RAGGED),
]
# rmsnorm widths: stablelm-12b, rwkv6-1.6b (d and ln_x), hymba-1.5b,
# gemma2-27b, the smoke models, gemma3-4b, the head dims qk_norm would
# take at gemma3-4b and qwen3-32b, whisper-large-v3, qwen2-vl-7b and
# mixtral-8x22b
RMSNORM_WIDTHS = (5120, 2048, 1600, 4608, 64, 2560, 256, 80, 1280, 3584,
                  6144)
# qwen3-32b's qk_norm rows as the layer passes them: (B, H, T, 80) head
# transposes of the (B, T, H·80) projections, q's 64 heads and k's 8, at
# prefill (T 32) and decode (T 1)
QK_NORM_ROWS = ((4, 64, 32, 80), (4, 8, 32, 80), (4, 64, 1, 80),
                (4, 8, 1, 80))


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

    for what, (B, Hq, Hkv, Tq, Tk, D), dt, window, softcap, n, *causal \
            in FLASH_GRID:
        causal = causal[0] if causal else True
        check("flash_attention",
              f"{what} {(B, Hq, Hkv, Tq, Tk, D)} w={window} cap={softcap:g}"
              + ("" if causal else " non-causal"),
              flash_case(B, Hq, Hkv, Tq, Tk, D, dtypes[dt], dev,
                         window=window, softcap=softcap, kv_len=n,
                         causal=causal))
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
    for shape in QK_NORM_ROWS:
        check("rmsnorm", f"qk_norm head-transposed {shape} bf16 x bf16 w "
              "offset 1", rmsnorm_case(shape, torch.bfloat16, torch.bfloat16,
                                       1.0, dev, heads=True))
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
    """The steps a family entry point runs: both halves of the AllReduce,
    the ReduceScatter half and the shard reorder, the unorder and the
    AllGather half, or the movement steps of all-to-all and p2p."""
    if family == "allreduce":
        return cs.rs + cs.ag
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
    if family == "allreduce":
        X = torch.randn((n, size), generator=g, device=dev)
        return ("run_local", X,
                X.double().sum(dim=0).expand(n, -1), 1e-6)
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


# ---------------------------------------------------------------------------
# the flat collectives (core.collectives, core.sync) on the local mesh
# ---------------------------------------------------------------------------
# the reference test's strategies on 8 ranks, then rhd on the ranks that
# are not a power of two; sizes a rank: EXEC_SIZES and the padded 13
FLAT_CASES = ([(8, "psum", None), (8, "ring", None), (8, "rhd", None),
               (8, "cps", None), (8, "hcps", (4, 2)), (8, "hcps", (2, 4)),
               (8, "hcps", (2, 2, 2))]
              + [(n, "rhd", None) for n in (3, 5, 6, 7)])
FLAT_PADDED = 13


def flat_folds(strategy: str, factors, n: int, half: str) -> int:
    """The fused_reduce launches of one flat collective, from its
    structure: a reduce-scatter folds n − 1 times on the ring (one
    2-operand fold a step, the first reads two ranks' chunks in place),
    log2 p times by rhd over its power-of-two core p (plus the fold-in of
    the extras at n ≠ p), once for cps and psum (one n-ary fold), once a
    stage for hcps; an all-gather only copies; an AllReduce is its
    reduce-scatter's folds (psum: one n-ary fold and a broadcast copy)."""
    if half == "all_gather":
        return 0
    pow2 = 1 << (n.bit_length() - 1)
    return {"psum": 1, "cps": 1, "ring": n - 1,
            "rhd": pow2.bit_length() - 1 + (n != pow2),
            "hcps": len(factors or ())}[strategy]


class Counted:
    """`fn` with its calls counted, so that a phase's launches can be
    reckoned as (launches a call) × (calls) over its checks and timings."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self):
        self.calls += 1
        return self.fn()


def flat_strategy_bytes(strategy, factors, n: int, size: int, half: str,
                        elem: int = 4) -> int:
    """Bytes one flat collective must move if each round's copy and each
    fold's rows cross device memory once (`FlatProgram.nbytes` of its
    reduce-scatter and all-gather programs), plus the copy of the input
    into a padded (or, for rhd's in-place fold-in, private) buffer."""
    from repro_torch.core import collectives as C
    mult = C._pad_multiple(n, strategy)
    L = size + (-size) % mult
    total = 0
    if half == "allreduce" and strategy == "psum":
        return C.flat_program("psum", "allreduce", (n,), (0,)).nbytes(
            n, size, elem)
    fac = tuple(factors) if factors else None
    rs = C.flat_program(strategy, "reduce_scatter", (n,), (0,), fac,
                        order=half != "allreduce")
    ag = C.flat_program(strategy, "all_gather", (n,), (0,), fac,
                        order=half != "allreduce")
    if half in ("allreduce", "reduce_scatter"):
        if L != size or rs.mutates_input:
            total += 2 * n * L * elem
        total += rs.nbytes(n, L, elem)
    if half in ("allreduce", "all_gather"):
        total += ag.nbytes(n, L, elem)
    return total


def phase_flat(dev) -> tuple[dict, list]:
    """The flat collectives on the local mesh (`core.collectives`,
    `core.sync`), every sum a fused_reduce launch: each case of
    FLAT_CASES at EXEC_SIZES a rank (and 8 × FLAT_PADDED) through
    `allreduce`, `reduce_scatter` and `all_gather` (rhd off a power of
    two: its AllReduce; its reduce-scatter shards over the core), held
    against the column sum in f32 (1e-6 of the largest |value|; the
    all-gather exactly), each call's fused_reduce launches exactly
    `flat_folds`; the GenTree plan (`run_local` through
    `collectives.allreduce(strategy="plan")`) on the same inputs;
    `allreduce_int8_cps` within 0.05, `allreduce_topk` exact on a sparse
    input, and `sync_gradients` over a (pod 2, data 4) mesh with hcps (2,
    2), and with "plan" at 20,480 and 2^26 f32 a rank in 8 leaves, per
    leaf and bucketed (the hierarchical bucket chain) at the default
    bucket and at FLAT_TWO_AXIS_BUCKET, the bucketed routes within 1e-6
    of the per-leaf one. Prints each run's device time (CUDA events),
    wall time (host clock to a synchronize), the function's bound (input
    read and output written once) and the strategy's byte bound
    (`flat_strategy_bytes`, or the schedules' `schedule_bytes`).
    Returns the phase's launches and the fold kernel's rows at the new
    launch shapes (gathered, recorded tables; dense, beside torch.sum)."""
    import torch
    from repro_torch.core import collectives as C
    from repro_torch.core import sync as S
    from repro_torch.core.lower import guard_schedule
    from repro_torch.kernels import ops, ref
    from repro_torch.planner.service import default_service

    svc = default_service()
    ops.reset_launches()
    expected = 0
    # the fold launches of 2^26 a rank recorded for the kernel rows:
    # ring's 2-operand folds, cps's 8-ary fold, hcps (4, 2)'s two stages
    recorded = {(8, "ring", None): FoldRecorder(),
                (8, "cps", None): FoldRecorder(),
                (8, "hcps", (4, 2)): FoldRecorder()}
    rows = []

    def run(what, fn, per_call, *, time_it=True, big=False):
        """Call fn once checked (its fused_reduce launches must be
        per_call), then time it; returns (result, device ms, wall ms)."""
        nonlocal expected
        f = Counted(fn)
        before = ops.LAUNCHES["fused_reduce"]
        got = f()
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["fused_reduce"] - before
        if launched != per_call:
            fail(f"flat {what}: {launched} fused_reduce launch(es), its "
                 f"structure gives {per_call}")
        dev_ms = wall_ms = float("nan")
        if time_it:
            dev_ms = (device_ms(f, launches=2, blocks=2) if big
                      else device_ms(f, launches=3, blocks=3))
            wall_ms = host_ms(f, calls=2 if big else 3)
        expected += per_call * f.calls
        return got, dev_ms, wall_ms

    def report(what, err, tol, dev_ms, wall_ms, fn_bytes, strat_bytes,
               launches):
        log(f"flat {what}: rel err {err:.2e} (tol {tol:g}); fused_reduce "
            f"{launches} a call (by its structure); device {dev_ms:.4f} ms "
            f"wall {wall_ms:.4f} ms; in+out bound "
            f"{bound_ms(fn_bytes):.4f} ms; strategy byte bound "
            f"{bound_ms(strat_bytes):.4f} ms")
        if not err <= tol:
            fail(f"flat {what}: rel err {err:.3e} over {tol}")

    sizes = [(s, label) for s, label in EXEC_SIZES] + [(FLAT_PADDED,
                                                        "padded 13")]
    for size, label in sizes:
        big = size >= 1 << 24
        for n, strategy, factors in FLAT_CASES:
            if size == FLAT_PADDED and n != 8:
                continue
            g = torch.Generator(device=dev).manual_seed(size % 997 + n)
            X = torch.randn((n, size), generator=g, device=dev)
            want = X.double().sum(dim=0)
            scale = float(want.abs().max())
            name = f"{strategy}{'' if factors is None else factors} n={n}"
            what = f"{name} {label}"
            elem = X.element_size()
            per = flat_folds(strategy, factors, n, "allreduce")
            rec = recorded.get((n, strategy, factors)) if big else None
            with rec or contextlib.nullcontext():
                got, d_ms, w_ms = run(f"allreduce {what}", lambda: C.allreduce(
                    X, "x", strategy, factors=factors), per, big=big)
            err = float((got.double() - want).abs().max()) / scale
            del got
            report(f"allreduce {what}", err, 1e-6, d_ms, w_ms,
                   2 * X.numel() * elem,
                   flat_strategy_bytes(strategy, factors, n, size,
                                       "allreduce"), per)
            if strategy == "rhd" and n & (n - 1):
                continue
            per = flat_folds(strategy, factors, n, "reduce_scatter")
            rs, d_ms, w_ms = run(f"reduce_scatter {what}",
                                 lambda: C.reduce_scatter(
                                     X, "x", strategy, factors=factors),
                                 per, big=big)
            mult = C._pad_multiple(n, strategy)
            wp = torch.nn.functional.pad(want, (0, (-size) % mult))
            err = float((rs.double() - wp.reshape(n, -1)).abs().max()) / scale
            report(f"reduce_scatter {what}", err, 1e-6, d_ms, w_ms,
                   (X.numel() + rs.numel()) * elem,
                   flat_strategy_bytes(strategy, factors, n, size,
                                       "reduce_scatter"), per)
            ag, d_ms, w_ms = run(f"all_gather {what}", lambda: C.all_gather(
                rs, "x", strategy, factors=factors), 0, big=big)
            exact = torch.equal(ag, rs.reshape(1, -1).expand(n, -1))
            report(f"all_gather {what}", 0.0 if exact else float("inf"), 0.0,
                   d_ms, w_ms, (rs.numel() + ag.numel()) * elem,
                   flat_strategy_bytes(strategy, factors, n, size,
                                       "all_gather"), 0)
            del rs, ag
            if n == 8 and strategy == "cps":
                # the same inputs through the GenTree plan and int8 CPS
                cs = svc.get_axis_executable("x", n, float(size)).schedule
                sched = guard_schedule(cs)
                per = sum(len(st.folds) for st in cs.rs + cs.ag)
                got, d_ms, w_ms = run(f"gentree {label}", lambda: C.allreduce(
                    X, "x", "plan", schedule=sched), per, big=big)
                err = float((got.double() - want).abs().max()) / scale
                del got
                report(f"allreduce gentree plan n=8 {label} "
                       f"({cs.describe()})", err, 1e-6, d_ms, w_ms,
                       2 * X.numel() * elem, schedule_bytes(cs, size,
                                                            X.dtype), per)
                if sched.demotions or sched.stats["failures"]:
                    fail(f"flat gentree {label}: guard {sched.stats}")
                got, d_ms, w_ms = run(f"int8 cps {label}",
                                      lambda: S.allreduce_int8_cps(X, "x"),
                                      1, big=big)
                err = float((got.double() - want).abs().max()) / scale
                del got
                report(f"allreduce_int8_cps n=8 {label}", err, 0.05, d_ms,
                       w_ms, 2 * X.numel() * elem,
                       # X read, its int8 payload written and read, the
                       # decoded f32 operands written and read, the
                       # gathered f32 result written
                       X.numel() * (elem + 2 + 2 * 4 + 4), 1)
            del X, want
        torch.cuda.empty_cache()

    # top-k on the reference test's sparse input and at the decode size:
    # k covers every nonzero, so the result is the column sum, added in
    # rank order from zero (the plain fold's order): exact
    for size in (1000, 4 * 5120):
        sparse = torch.zeros((8, size), device=dev)
        g = torch.Generator(device=dev).manual_seed(size)
        sparse[:, :5] = torch.randn((8, 5), generator=g, device=dev)
        got, d_ms, w_ms = run(f"topk {size}", lambda: S.allreduce_topk(
            sparse, "x", k_frac=0.01), 0)
        exact = all(torch.equal(r, ref.fused_reduce_ref(sparse))
                    for r in got)
        report(f"allreduce_topk 8 x {size} sparse (5 nonzeros a rank)",
               0.0 if exact else float("inf"), 0.0, d_ms, w_ms,
               2 * sparse.numel() * 4, 2 * sparse.numel() * 4, 0)

    # sync_gradients on (pod 2, data 4) with hcps (2, 2), the reference
    # test's case and a decode-sized leaf: data folds twice, pod once
    cfg = S.SyncConfig(strategy="hcps", factors=(2, 2))
    axes, mesh = [("data", 4), ("pod", 2)], [("pod", 2), ("data", 4)]
    plans = S.resolve_axis_plans(axes, cfg, 1.0)
    per = sum(flat_folds(p.strategy, p.factors, n, "allreduce")
              for p, (_, n) in zip(plans, axes))
    for size in (24, 4 * 5120):
        z = torch.randn((2, 4, size), generator=torch.Generator(
            device=dev).manual_seed(size), device=dev)
        want = z.double().sum(dim=(0, 1))
        got, d_ms, w_ms = run(f"sync_gradients {size}",
                              lambda: S.sync_gradients({"g": z}, axes, cfg,
                                                       mesh=mesh)["g"], per)
        err = float((got.double() - want).abs().max()) / float(
            want.abs().max())
        report(f"sync_gradients (pod 2, data 4) hcps (2, 2) x {size} "
               f"({', '.join(f'{p.axis} {p.strategy}{p.factors or ()}' for p in plans)})",
               err, 1e-6, d_ms, w_ms, 2 * z.numel() * 4,
               sum(8 // n * flat_strategy_bytes(p.strategy, p.factors, n,
                                                size, "allreduce")
                   for p, (_, n) in zip(plans, axes)), per)

    # sync_gradients(strategy="plan") on the same mesh, each rank's data in
    # 8 leaves: per leaf (a schedule an axis, its groups side by side in
    # one run), then bucketed (the hierarchical bucket chain, a group of
    # the other axis at a time) at the default bucket and a pinned one;
    # the routes agree within 1e-6
    from repro_torch.core.bucketing import BucketConfig, partition
    for size in (4 * 5120, 1 << 26):
        t_row = time.perf_counter()
        big = size >= 1 << 24
        z = torch.randn((2, 4, size), generator=torch.Generator(
            device=dev).manual_seed(size + 1), device=dev)
        leaves = [c.contiguous() for c in z.chunk(8, dim=-1)]
        widths = [int(c.shape[-1]) for c in leaves]
        want = z.double().sum(dim=(0, 1))
        scale = float(want.abs().max())
        del z
        cfg0 = S.SyncConfig(strategy="plan", bucket_bytes=0)
        leaf_plans = S.resolve_axis_plans(axes, cfg0, float(size))
        per = sum(len(st.folds) for p in leaf_plans
                  for st in p.schedule.rs + p.schedule.ag) * len(leaves)
        base, d_ms, w_ms = run(
            f"sync_gradients plan per leaf {size}",
            lambda: S.sync_gradients(leaves, axes, cfg0, mesh=mesh), per,
            big=big)
        err = float((torch.cat(base, dim=-1).double() - want).abs().max()
                    ) / scale
        described = "; ".join(p.schedule.describe() for p in leaf_plans)
        report(f"sync_gradients (pod 2, data 4) plan per leaf 8 leaves x "
               f"{size // 8} ({described})",
               err, 1e-6, d_ms, w_ms, 2 * 8 * size * 4,
               sum(schedule_bytes(p.schedule, 8 // n * w, torch.float32)
                   for p, (_, n) in zip(leaf_plans, axes)
                   for w in widths), per)
        for bb in (None, FLAT_TWO_AXIS_BUCKET):
            cfg = S.SyncConfig(strategy="plan", bucket_bytes=bb)
            bp = svc.get_bucket_plan(axes, float(size), dtype="float32",
                                     config=BucketConfig(bucket_bytes=bb))
            bks = partition(widths, ["f32"] * len(widths), bp.bucket_bytes,
                            itemsizes=[4] * len(widths))
            per = 0
            for p, (_, n) in zip(bp.axis_plans, axes):
                cs = p.schedule
                per += len(bks) * 8 // n * sum(
                    len(st.folds) for st in family_steps(
                        cs, "reduce_scatter") + family_steps(cs,
                                                             "allgather"))
            stats = {}
            got, d_ms, w_ms = run(
                f"sync_gradients plan bucketed {bb} {size}",
                lambda: S.sync_gradients(leaves, axes, cfg, mesh=mesh,
                                         stats=stats), per, big=big)
            err = max(float((g.double() - b.double()).abs().max())
                      for g, b in zip(got, base)) / scale
            err_sum = float((torch.cat(got, dim=-1).double() - want).abs()
                            .max()) / scale
            del got
            # each bucket's chain: the reduce-scatter and all-gather of
            # each axis at the size it runs on, once a group
            strat = 0
            for bk in bks:
                cur = sum(widths[i] for i in bk.indices)
                for p, (_, n) in zip(bp.axis_plans, axes):
                    cs = p.schedule
                    strat += 8 // n * (
                        schedule_bytes(cs, cur, torch.float32,
                                       family_steps(cs, "reduce_scatter"))
                        + schedule_bytes(cs, cur, torch.float32,
                                         family_steps(cs, "allgather")))
                    cur = -(-cur // cs.num_blocks) * cs.num_blocks // n
            described = "; ".join(p.schedule.describe()
                                  for p in bp.axis_plans)
            report(f"sync_gradients (pod 2, data 4) plan bucketed "
                   f"bucket_bytes={bb}: {len(bks)} bucket(s) of "
                   f"{bp.bucket_bytes} bytes, {stats['overlap_mode']} "
                   f"mode, {described}; against per leaf", err, 1e-6, d_ms,
                   w_ms,
                   2 * 8 * size * 4, strat, per)
            if not err_sum <= 1e-6:
                fail(f"flat bucketed {bb} {size}: {err_sum:.3e} from the "
                     "column sum")
        del leaves, base, want
        torch.cuda.empty_cache()
        log(f"flat: bucketed (pod 2, data 4) rows at {size} a rank: wall "
            f"{time.perf_counter() - t_row:.1f} s")

    counts = dict(ops.LAUNCHES)
    log(f"flat: fused_reduce launches {counts['fused_reduce']}, expected "
        f"{expected} (each call's structure times its calls); launches "
        f"{json.dumps(counts)}")
    if counts["fused_reduce"] != expected:
        fail(f"flat: {counts['fused_reduce']} fused_reduce launches, "
             f"expected {expected}")
    for name, count in counts.items():
        if name != "fused_reduce" and count:
            fail(f"flat launched {name} {count} time(s)")

    # the fold kernel at the new launch shapes (2^26 a rank, 8 ranks):
    # the gathered form with the recorded tables, and the dense (B, x, L)
    # form beside torch.sum over the stack
    picks = []
    for (n, strategy, factors), rec in recorded.items():
        seen = set()
        for call in rec.calls.values():
            table = call[2]
            key = (table.rows.shape, call[0][1], table.has_own)
            if key not in seen:
                seen.add(key)
                picks.append((f"{strategy}{factors or ''}", call))
    for case, (src_shape, src_dtype, table, out_shape, out_dtype) in picks:
        B, x = table.rows.shape
        own = table.has_own
        L = src_shape[1]
        label = (f"flat {case} fold x={x}{' + own' if own else ''}: into "
                 f"B={B} L={L}")
        r = measure(fused_reduce_into_case(src_shape, src_dtype, table,
                                           out_shape, out_dtype, dev))
        rows.append(("fused_reduce", label, r))
        r = measure(fused_reduce_case((B, x + int(own), L), src_dtype, dev))
        rows.append(("fused_reduce", f"flat fold dense ({B}, {x + int(own)}"
                     f", {L}) vs torch.sum", r))
        torch.cuda.empty_cache()
    r = measure(fused_reduce_case((9, 1 << 24), torch.float32, dev))
    rows.append(("fused_reduce", "Fig. 4 fold dense (9, 2^24) f32", r))
    for name, what, r in rows:
        if r["max_abs_err"] != 0.0:
            fail(f"{name} {what} differs from its plain version by "
                 f"{r['max_abs_err']}")
    return counts, rows


def run_checked(cs, family: str, size: int, dev, seed: int, what: str
                ) -> tuple[float, float]:
    """Run schedule `cs` through the guard's entry point for `family` at
    `size` elements a rank against the exact answer (`family_case`; f32
    within its tolerance, a wire within its budget), then time it (host
    clock to a synchronize: a warm-up and the median of 3). Five runs in
    all; returns (relative error, wall ms)."""
    import torch
    from repro_torch.core.lower import guard_schedule
    entry, X, want, f32_tol = family_case(cs, family, size, dev, seed)
    sched = guard_schedule(cs)
    got = getattr(sched, entry)(X)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max()) / float(
        want.abs().max())
    del got
    budget = f32_tol if cs.wire is None else cs.wire.error_budget
    if not err <= budget:
        fail(f"{what}: rel err {err:.3e} over {budget}")
    wall = host_ms(lambda: getattr(sched, entry)(X))
    if sched.demotions or sched.stats["failures"]:
        fail(f"{what}: guard demoted {sched.demotions} time(s), "
             f"{sched.stats['failures']} failure(s)")
    return err, wall


def phase_planner(dev) -> dict:
    """The rest of the planner on the card, each part on PlannerService
    instances of its own (the other phases' plans do not move):
    (a) Fig. 4: `TorchProvider.fig4_curve` at PLANNER_FIG4_SIZES, δ and γ
    fitted; (b) the decode and gradient AllReduces of EXEC_SIZES observed
    as serve observes them (`source="local_mesh"`), then `calibrate` on
    the card (`backend="torch"`), the fitted params validated, the two
    executables fetched again, run against the column sum and observed;
    (c) `get_plan` under arrival skew on the two topologies at
    SKEW_SCALES, every candidate the re-ranking prices lowered and run at
    SKEW_SIZE; (d) `get_step_plan` on STEP_MIX and on the bucketed
    trainer's own step, each family's schedule run at STEP_SIZE. Every
    launch is counted in advance and must match exactly. Returns the
    launch counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import gentree as gentree_mod
    from repro_torch.core.cost_model import cost_cps
    from repro_torch.core.fitting import fit_delta_gamma
    from repro_torch.core.lower import guard_schedule, lower_plan
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.topology import single_switch, symmetric_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_manual_train_step
    from repro_torch.models.registry import build
    from repro_torch.planner import service as service_mod
    from repro_torch.planner.calibrate import (CalibrationConfig,
                                               TorchProvider,
                                               validate_params)
    from repro_torch.planner.service import PlannerService
    from repro_torch.planner.skew import SkewModel, pick_plan_under_skew

    n = TRAIN["local_ranks"]
    ops.reset_launches()
    want = dict.fromkeys(ops.LAUNCHES, 0)

    def expect(counts: dict) -> None:
        for k, v in counts.items():
            want[k] += v

    # (a) Fig. 4 through fused_reduce: a warm-up and 5 timed folds a fan-in
    prov = TorchProvider(device=dev)
    hbm_delta = 4 / HBM_BYTES_PER_S
    for size in PLANNER_FIG4_SIZES:
        cfg = CalibrationConfig(backend="torch", fig4_size=size)
        xs, ts = prov.fig4_curve("server", None, cfg)
        expect({"fused_reduce": 6 * len(xs)})
        delta, gamma = fit_delta_gamma(xs, ts, size)
        fit = (xs + 1) * size * delta + (xs - 1) * size * gamma
        resid = float(np.max(np.abs(fit - ts) / ts))
        log(f"planner fig4 S={size:.0f}: x, ms: " + ", ".join(
            f"{x:.0f} {t * 1e3:.4f}" for x, t in zip(xs, ts)))
        log(f"planner fig4 S={size:.0f}: delta {delta:.4e} s a float "
            f"({4 / delta / 1e12:.3f} TB/s), gamma {gamma:.4e} (before "
            f"clamping), fit residual max {resid:.2%}; delta / (4 B / "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {hbm_delta:.3e} s) = "
            f"{delta / hbm_delta:.3f}")

    # (b) observed against predicted, before and after calibrating
    svc = PlannerService()

    def observe(size: int, label: str, when: str):
        resp = svc.get_axis_executable("model", n, float(size))
        sched = guard_schedule(resp.schedule, telemetry=svc.telemetry)
        g = torch.Generator(device=dev).manual_seed(size % 997)
        X = torch.randn((n, size), generator=g, device=dev)
        got = sched.run_local(X)
        ref = X.double().sum(dim=0)
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        del got, ref
        if not err <= 1e-6:
            fail(f"planner {when} {label}: rel err {err:.3e} over 1e-06")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.run_local(X)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        del X
        measured = sorted(ts)[1]
        obs = svc.observe("root_sw", n, float(size), measured, key=resp.key,
                          source="local_mesh")
        expect(steps_launches(resp.schedule, family_steps(resp.schedule,
                                                          "allreduce"), 4))
        if sched.demotions or sched.stats["failures"]:
            fail(f"planner {when} {label}: guard demoted or failed")
        log(f"planner {when} calibration, {label}: {resp.algo} "
            f"({resp.schedule.describe()}) rel err {err:.2e}; predicted "
            f"{obs['predicted'] * 1e3:.4f} ms, observed "
            f"{measured * 1e3:.4f} ms (observed / predicted "
            f"{measured / obs['predicted']:.3f}), drift "
            f"{abs(obs['rel_residual']):.2f}")
        return resp

    before = {label: observe(size, label, "before")
              for size, label in EXEC_SIZES}
    ccfg = CalibrationConfig(backend="torch", fig4_size=PLANNER_CAL_FIG4)
    t0 = time.perf_counter()
    res = svc.calibrate(cfg=ccfg)
    cal_s = time.perf_counter() - t0
    # per level: a warm-up and 5 folds a fan-in; a warm-up and 3 runs of
    # each (n, S)'s CPS, one fold kernel a fold phase
    cps_folds = {m: steps_launches(cs, family_steps(cs, "allreduce"), 1)[
        "fused_reduce"] for m in ccfg.ns for cs in [lower_plan(
            gentree_mod.baseline_plan("cps", single_switch(m),
                                      float(ccfg.sizes[0])))]}
    expect({"fused_reduce": len(ccfg.levels) * (
        6 * len(ccfg.fig4_xs)
        + sum(4 * cps_folds[m] * len(ccfg.sizes) for m in ccfg.ns))})
    log(f"planner: calibrated on the card in {cal_s:.1f} s (backend "
        f"{res.backend}, {len(ccfg.levels)} levels, Fig. 4 at "
        f"{ccfg.fig4_size} floats, CPS over n {ccfg.ns[0]}..{ccfg.ns[-1]} "
        f"and S {list(ccfg.sizes)})")
    for lvl, p in res.params.items():
        bad = validate_params(p)
        log(f"planner calibrated {lvl}: alpha {p.alpha:.4e} beta "
            f"{p.beta:.4e} gamma {p.gamma:.4e} delta {p.delta:.4e} "
            f"epsilon {p.epsilon:.4e} w_t {p.w_t}")
        if bad:
            fail(f"planner: the fitted {lvl} params fail validate_params: "
                 f"{bad}")
    smp, fitted = res.samples["root_sw"], res.params["root_sw"]
    for m, size, t in zip(smp.ns, smp.sizes, smp.times):
        if int(m) in (2, 8, 16):
            log(f"planner CPS curve n={m:.0f} S={size:.0f}: measured "
                f"{t * 1e3:.4f} ms, fitted {cost_cps(int(m), size, fitted) * 1e3:.4f} ms")
    for size, label in EXEC_SIZES:
        resp = observe(size, label, "after")
        old = before[label]
        if (resp.algo, resp.schedule.describe()) != (
                old.algo, old.schedule.describe()):
            log(f"planner {label}: the plan changed with calibration: "
                f"{old.algo} ({old.schedule.describe()}) -> {resp.algo} "
                f"({resp.schedule.describe()})")
        else:
            log(f"planner {label}: the plan is unchanged by calibration")

    # (c) arrival skew, priced on the fitted params
    baseline_wins = 0
    for tname, topo in (("single_switch(8)", single_switch(8)),
                        ("symmetric_tree(2,4)", symmetric_tree(2, 4))):
        models = [SkewModel(dist="exponential", scale=sc)
                  for sc in SKEW_SCALES]
        for model in models:
            ssvc = PlannerService(params=svc.params, skew=model)
            resp = ssvc.get_plan(topo, SKEW_SIZE * 4)
            baseline_wins += resp.algo != "gentree"
            log(f"planner skew {tname} exponential scale {model.scale:g} "
                f"s: {resp.algo} wins, priced {resp.predicted_time * 1e3:.4f}"
                f" ms synchronized, {resp.expected_skewed_time * 1e3:.4f} ms "
                f"under skew")
        # the candidates the re-ranking priced (`PlannerService.get_plan`)
        m = topo.num_servers()
        cands = [("gentree", gentree_mod.gentree(
            topo, resp.size_floats, params=ssvc.params).plan)] + [
            (k, gentree_mod.baseline_plan(k, topo, resp.size_floats))
            for k in ssvc.baseline_kinds
            if not (k == "rhd" and m & (m - 1))]
        for name, plan in cands:
            cs = lower_plan(plan)
            what = f"planner skew {tname} candidate {name}"
            err, wall = run_checked(cs, "allreduce", SKEW_SIZE, dev, 11, what)
            expect(steps_launches(cs, family_steps(cs, "allreduce"), 5))
            costs = [pick_plan_under_skew([(name, plan)], topo, model,
                                          ssvc.params)[2]
                     for model in models]
            log(f"{what} ({cs.describe()}) rel err {err:.2e}, wall "
                f"{wall:.4f} ms; priced under skew " + ", ".join(
                    f"{c * 1e3:.4f} ms at {mo.scale:g} s"
                    for c, mo in zip(costs, models)))
    log(f"planner skew: a baseline won {baseline_wins} of "
        f"{2 * len(SKEW_SCALES)} re-rankings")

    # (d) whole-step plans: the tests' mix, and the bucketed trainer's own
    # step at full width, its bucket plan from a service of its own
    prev = service_mod.peek_default_service()
    service_mod.set_default_service(PlannerService())
    try:
        tcfg = dataclasses.replace(get_config(TRAIN["arch"]),
                                   n_layers=TRAIN["layers"])
        step = make_manual_train_step(build(tcfg), n,
                                      sync=SyncConfig(strategy="plan"),
                                      device=dev)
    finally:
        service_mod.set_default_service(prev)
    rs = [n * bk.width for bk in step.scatter_buckets]
    ag = [n * bk.width for bk in step.gather_buckets]
    trainer_mix = {"reduce_scatter": (len(rs), sum(rs) / len(rs)),
                   "allgather": (len(ag), sum(ag) / len(ag))}
    for mname, mix, dtype in (("the tests' MIX", STEP_MIX, "float32"),
                              ("the bucketed trainer's step", trainer_mix,
                               "bfloat16")):
        sp = svc.get_step_plan([("data", n)], mix, dtype)
        log(f"planner step plan, {mname} ({dtype}): precision "
            f"{sp.precision}, ratio {sp.ratio:.4f}; per call "
            f"{sp.total_per_call * 1e3:.4f} ms, coalesced "
            f"{sp.total_joint * 1e3:.4f} ms, best {sp.total_best * 1e3:.4f}"
            f" ms")
        for fam, q in sorted(sp.quotes.items()):
            log(f"planner step plan, {mname}, {fam}: {q['count']} x "
                f"{q['size_floats']:.0f}: per call "
                f"{q['per_call_total'] * 1e3:.4f} ms, coalesced "
                f"{q['joint_total'] * 1e3:.4f} ms, pipelined "
                f"{q['contended'] * 1e3:.4f} ms; {q['mode']} "
                f"{q['best_total'] * 1e3:.4f} ms, {q['precision']}")
        for i, (fam, cs) in enumerate(sorted(sp.schedules.items())):
            what = f"planner step plan, {mname}, {fam} schedule"
            err, wall = run_checked(cs, fam, STEP_SIZE, dev, 20 + i, what)
            expect(steps_launches(cs, family_steps(cs, fam), 5))
            log(f"{what} ({cs.describe()}) at {STEP_SIZE} f32 a rank: rel "
                f"err {err:.2e}, wall {wall:.4f} ms")
        torch.cuda.empty_cache()

    counts = dict(ops.LAUNCHES)
    log(f"planner: launches {json.dumps(counts)}")
    if counts != want:
        fail(f"planner: launches {counts}, expected {want}")
    return counts


def attention_launches(cfg, forwards: int) -> dict:
    """flash_attention launches by CUDA kernel in `forwards` forwards of
    `cfg` in bf16, the first a prefill of more than 4 tokens (on the
    prefill kernel), the rest decode steps (on the decode kernel): one an
    attention layer; the encoder-decoder's prefill adds its encoder's
    layers (its cross-attention is torch ops)."""
    layers = ATTENTION_PER_LAYER.get(cfg.family, 1) * cfg.n_layers
    return {"flash_decode_kernel": layers * (forwards - 1),
            "flash_tc_kernel": layers + cfg.n_encoder_layers,
            "flash_tf32_kernel": 0}


def expected_launches(cfg, forwards: int) -> dict:
    """Launches of each model kernel in `forwards` forwards of `cfg`, the
    first a prefill: rmsnorm per norm (qk_norm's two a layer included),
    flash_attention per attention layer, the family's recurrence kernel
    per layer, and the other recurrence never. The encoder-decoder
    ("audio"): a decoder layer's ln1, ln_x and ln2 and its self-attention
    each forward, the final norm, and in the prefill each encoder layer's
    ln1 and ln2 and attention and the encoder's final norm."""
    fam = cfg.family
    attention = sum(attention_launches(cfg, forwards).values())
    if fam == "audio":
        return {"rmsnorm": forwards * (3 * cfg.n_layers + 1)
                + 2 * cfg.n_encoder_layers + 1,
                "flash_attention": attention, "wkv": 0, "ssm_scan": 0}
    norms = NORMS_PER_LAYER[fam] + 2 * bool(cfg.qk_norm)
    want = {"rmsnorm": forwards * (norms * cfg.n_layers + 1),
            "flash_attention": attention}
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
        + (f"encoder layers={cfg.n_encoder_layers} "
           if cfg.n_encoder_layers else "")
        + f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
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
    want = attention_launches(cfg, sc["max_new"])
    if by_kernel != want:
        fail(f"serving {arch} ran attention kernels {by_kernel}, expected "
             f"{want}")
    if res["tp_schedule"].demotions or res["tp_schedule"].stats["failures"]:
        fail(f"serving {arch}: the decode schedule was demoted "
             f"{res['tp_schedule'].demotions} time(s) or failed")
    if not res["self_check_err"] < 1e-5:
        fail(f"serving {arch}: self-check rel err {res['self_check_err']}")
    if sc["prompt_len"] > SERVE["prompt_len"]:
        # a long request: some layer's window must mask its prompt
        windows = {cfg.window_for_layer(i) for i in range(cfg.n_layers)}
        if not any(0 < w < sc["prompt_len"] for w in windows):
            fail(f"the long {arch} request of {sc['prompt_len']} tokens "
                 f"fits every window of {sorted(windows)}")
    toks = res["tokens"]
    want = (sc["batch"], sc["max_new"])
    if toks.shape != want or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"serving {arch} produced tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    if all(sc.get(k) == v for k, v in SERVE.items()) \
            and sc.get("n_layers") is None:
        SERVED_TOKENS[arch] = toks
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
    """Where a decode step's time goes: the full-size model `arch` (its
    depth cut as SERVE_LAYERS says), prefilled, two warm-up steps, then
    PROFILE_STEPS greedy steps under torch.profiler. Prints per step: the
    wall time (under the profiler), the kernels launched, the device's
    busy time (the union of kernel, copy and set intervals in the trace)
    and its share of the wall time, the weight-read bound (every weight a
    decode step reads, read once, over the memory rate: all but the
    embedding and an encoder's; a MoE model's sorted decode runs every
    expert's capacity buffer, so it reads every routed expert), and the
    kernels that take most device time."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, step_batch
    from repro_torch.models.registry import build

    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    api = build(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _tensors({k: v for k, v in params.items()
                                          if k not in ("embed", "encoder",
                                                       "ln_enc")}))
    batch = prompt_batch(cfg, SERVE["batch"], SERVE["prompt_len"],
                         torch.Generator(device=dev).manual_seed(1))

    def step(cache, tok):
        logits, cache = api.decode_step(params, cache,
                                        step_batch(cfg, params, tok))
        return cache, logits[:, -1].float().argmax(dim=-1)

    with torch.inference_mode():
        logits, cache = api.prefill(params, batch, SERVE["cache_len"])
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
    if cfg.n_experts:
        experts = sum(params["layers"][0]["moe"][w].numel()
                      for w in ("wi", "wg", "wo"))
        log(f"decode profile: {arch}: {experts / 1e6:.1f} M routed expert "
            f"weights a layer ({experts * 2 / 1e9:.3f} GB in bf16), all "
            f"read by each sorted decode step; {cfg.n_layers} layers")
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
    del params, cache, logits, batch
    torch.cuda.empty_cache()


def _to(tree, where):
    """A copy of a nested dict / list of tensors on device `where`."""
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, where) for v in tree]
    return tree.to(where)


class MoeRecorder:
    """Per `transformer.moe` call: the tokens, the slots the sorted
    dispatch drops and the smallest margin between a token's k-th and
    (k+1)-th router probability (a near-tie is where two devices could
    route a token differently). It calls the real layer."""

    def __init__(self):
        from repro_torch.models import transformer
        self.mod = transformer
        self.real = transformer.moe
        self.calls: list[tuple[int, int, float]] = []

    def __enter__(self):
        from repro_torch.models import layers

        def spy(p, x, cfg, **kw):
            xt = x.reshape(-1, x.shape[-1])
            probs, _, topi = layers.moe_route(p, xt, cfg.top_k)
            top = probs.sort(dim=-1, descending=True).values
            margin = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
            self.calls.append((xt.shape[0], layers.moe_drops(topi, cfg),
                               float(margin.min())))
            return self.real(p, x, cfg, **kw)
        self.mod.moe = spy
        return self

    def __exit__(self, *exc):
        self.mod.moe = self.real


def phase_whisper_long(dev, recorder) -> dict:
    """whisper-large-v3 at full size on N_AUDIO_FRAMES frames of stub
    audio (30 s), through the model API (WHISPER_LONG: batch 4, prompt
    32, 8 new tokens): prefill, then greedy decode. The encoder's
    attention runs the bf16 prefill kernel non-causal at (4, 20/20,
    1500, 1500, 64). Exact launches (`expected_launches`, by CUDA kernel
    `attention_launches`), finite logits, tokens in range; prints the
    prefill and decode times (host clock to a synchronize) and the peak
    memory. Returns the kernel launches of the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.encdec import N_AUDIO_FRAMES
    from repro_torch.models.registry import build

    sc = WHISPER_LONG
    cfg = get_config(sc["arch"])
    api = build(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    B = sc["batch"]
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, sc["prompt_len"]),
                                     generator=gen, device=dev),
             "frames": torch.randn((B, N_AUDIO_FRAMES, cfg.d_model),
                                   generator=gen, device=dev).to(
                                       torch.bfloat16)}
    torch.cuda.synchronize()
    ops.reset_launches()
    with recorder, torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch, sc["cache_len"])
        tok = logits[:, -1].float().argmax(dim=-1)
        outs, finite = [tok.cpu()], bool(torch.isfinite(logits).all())
        prefill_s = time.perf_counter() - t0
        steps = []
        for _ in range(sc["max_new"] - 1):
            t0 = time.perf_counter()
            logits, cache = api.decode_step(params, cache,
                                            {"tokens": tok[:, None]})
            tok = logits[:, -1].float().argmax(dim=-1)
            outs.append(tok.cpu())
            finite &= bool(torch.isfinite(logits).all())
            steps.append(time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    by_kernel = dict(ops.ATTENTION_LAUNCHES)
    toks = torch.stack(outs, dim=1)
    log(f"serve long: {cfg.name} batch {B} frames {N_AUDIO_FRAMES} prompt "
        f"{sc['prompt_len']} new {sc['max_new']} cache {sc['cache_len']}; "
        f"launches {json.dumps(counts)}; attention kernels "
        f"{json.dumps(by_kernel)}; prefill {prefill_s * 1e3:.1f} ms, decode "
        f"first {steps[0] * 1e3:.1f} ms, median "
        f"{statistics.median(steps) * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    want = {**expected_launches(cfg, sc["max_new"]), "fused_reduce": 0}
    for kernel, n in want.items():
        if counts[kernel] != n:
            fail(f"the long {cfg.name} request launched {kernel} "
                 f"{counts[kernel]} time(s), expected {n}")
    if by_kernel != attention_launches(cfg, sc["max_new"]):
        fail(f"the long {cfg.name} request ran attention kernels "
             f"{by_kernel}, expected {attention_launches(cfg, sc['max_new'])}")
    if not finite or toks.shape != (B, sc["max_new"]) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        fail(f"the long {cfg.name} request gave non-finite logits or tokens "
             f"of shape {tuple(toks.shape)} in [{toks.min()}, {toks.max()}]")
    del params, cache, logits, batch
    torch.cuda.empty_cache()
    return {**counts, **by_kernel}


def reference_batch(cfg, B: int, T: int) -> dict:
    """The smoke-size run's prompt batch on the CPU, from seeded
    generators: (B, T) token ids; for the vlm family N(0, 1) embeddings
    and three position streams drawn apart in [0, 2048); for the audio
    family REFERENCE_FRAMES N(0, 1) frames beside the tokens."""
    import torch
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "vlm":
        return {"embeds": torch.randn((B, T, cfg.d_model), generator=gen),
                "mrope_positions": torch.randint(0, 2048, (3, B, T),
                                                 generator=gen)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, REFERENCE_FRAMES, cfg.d_model),
                                      generator=gen)
    return batch


def phase_model_reference(dev, arch: str) -> None:
    """The smoke-size model of `arch` (with REFERENCE_CFG's overrides) in
    f32 on the card (its kernels) against the same code on the CPU (their
    plain versions): prefill of a (batch, prompt) of REFERENCE_RUN
    (default 2 × 8, cache 16; `reference_batch`) + 4 greedy decode
    steps, logits within 1e-4 of the largest |logit|, identical tokens. A
    MoE model prints its dropped slots and smallest top-k margin on each
    side, and must drop slots on both."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import step_batch
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    api = build(dataclasses.replace(smoke_config(get_config(arch)),
                                    **REFERENCE_CFG.get(arch, {})))
    params = api.init_params(torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
    B, T, cache_len = REFERENCE_RUN.get(arch, (2, 8, 16))
    batch = reference_batch(api.cfg, B, T)
    runs, routes = {}, {}
    for where in ("cpu", dev):
        p = _to(params, where)
        with torch.inference_mode(), MoeRecorder() as moe:
            logits, cache = api.prefill(p, _to(batch, where), cache_len)
            outs, toks = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(dim=-1)
                toks.append(tok.cpu())
                logits, cache = api.decode_step(p, cache,
                                                step_batch(api.cfg, p, tok))
                outs.append(logits.cpu())
        runs[str(where)] = (torch.stack(outs), torch.stack(toks))
        routes[str(where)] = moe.calls
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(dev)]
    err = float((lg - lc).abs().max() / lc.abs().max())
    log(f"model: {arch} smoke-size f32, head dim {api.cfg.head_dim}, "
        f"batch {B}, prompt {T}, logits card vs CPU rel err "
        f"{err:.2e}, tokens equal {bool(torch.equal(tc, tg))}")
    if api.cfg.n_experts:
        for where, calls in routes.items():
            drops = sum(d for n, d, _ in calls if n == B * T)
            log(f"model: {arch} on {where}: {len(calls)} MoE calls, "
                f"{drops} slots dropped in prefill, smallest top-k margin "
                f"{min(m for _, _, m in calls):.3e}")
            if not drops:
                fail(f"the smoke-size {arch} prefill on {where} dropped no "
                     "slot: the run must cover a capacity drop")
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
                 step=None, plan=None) -> dict:
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
    the gradient). A MoE layer's products count its router, shared
    experts and top_k routed experts a token. Where the activations are
    f32 (a vlm's embeddings; whisper's encoder, `encdec_flops`) the
    products take the f32 rate."""
    P = sum(int(t.numel()) for t in shards)       # padded, all ranks
    elem = shards[0].element_size()
    dtype = shards[0].dtype
    if plan is not None and plan.strategy != "plan":
        # a flat label: its programs' bytes at each leaf's padded rows
        # (`flat_strategy_bytes`)
        gather = sum(flat_strategy_bytes(plan.strategy, plan.factors, n,
                                         int(t.numel()), "all_gather", elem)
                     for t in shards)
        scatter = sum(flat_strategy_bytes(plan.strategy, plan.factors, n,
                                          int(t.numel()), "reduce_scatter",
                                          elem)
                      for t in shards)
    elif step is not None and step.bucket_plan is not None:
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
    rank = rank_bounds(cfg, P, elem, n, seq_len, batch)
    return {"gather": bound_ms(gather),
            "forward_backward": n * max(rank["rank_bytes_ms"],
                                        rank["rank_flops_ms"]),
            "reduce_scatter": bound_ms(scatter), "adamw": bound_ms(22 * P),
            **rank}


def rank_bounds(cfg, P: int, elem: int, n: int, seq_len: int,
                batch: int) -> dict:
    """One rank's forward and backward over its batch // n rows (of P
    parameters of `elem` bytes; `train_bounds`' terms): its bytes'
    bound in ms, its products' bound in ms, and the products."""
    active = cfg.active_params_count() if cfg.n_experts else P
    matmul = active - cfg.vocab * cfg.d_model - (2 * cfg.n_layers + 1) \
        * cfg.d_model                            # no embed, no norms
    tokens = seq_len * batch // n
    attn = (4 * tokens * seq_len * cfg.n_heads * cfg.head_dim
            * cfg.n_layers)                      # QK and PV, forward
    if cfg.family in ("ssm", "hybrid"):
        attn = recurrent_flops(cfg, tokens, seq_len)
    flops, f32_flops = 6 * tokens * matmul + 3 * attn, 0
    if cfg.family == "vlm":
        flops, f32_flops = 0, flops
    elif cfg.family == "audio":
        flops, f32_flops = encdec_flops(cfg, tokens, seq_len, batch // n)
    fb_bytes = 2 * P * elem
    flops_ms = (flops / BF16_FLOPS + f32_flops / F32_FLOPS) * 1e3
    return {"rank_bytes_ms": bound_ms(fb_bytes), "rank_flops_ms": flops_ms,
            "rank_flops": flops + f32_flops}


def encdec_flops(cfg, tokens: int, seq_len: int, rows: int
                 ) -> tuple[int, int]:
    """(bf16, f32) operations of one rank's forward and backward through
    the encoder-decoder (3 × the forward's; the products 2 a weight a
    token): its `rows` rows of AUDIO_FRAMES stub frames through the
    encoder, in f32 (the frames are f32); its `tokens` decoder tokens
    (rows of `seq_len`) through the decoder's products in bf16, and the
    cross-attention K/V products of the encoder states in f32; every
    attention's QK and PV (the encoder's, the decoder's causal and its
    cross-attention over the frames) in f32."""
    from repro_torch.launch.train import AUDIO_FRAMES
    d, f, H, Hkv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim)
    te = rows * AUDIO_FRAMES                     # encoder tokens
    attn_w = d * hd * (2 * H + 2 * Hkv)          # wq, wk, wv, wo
    mlp_w = 3 * d * f
    enc = cfg.n_encoder_layers * (2 * te * (attn_w + mlp_w)
                                  + 4 * te * AUDIO_FRAMES * H * hd)
    dec = (cfg.n_layers * 2 * tokens * (attn_w + mlp_w + 2 * d * H * hd)
           + 2 * tokens * d * cfg.vocab)         # + xattn wq, wo; lm_head
    cross = cfg.n_layers * (2 * te * 2 * d * Hkv * hd    # xattn wk, wv
                            + 4 * tokens * (seq_len + AUDIO_FRAMES) * H * hd)
    return 3 * dec, 3 * (enc + cross)


def recurrent_flops(cfg, tokens: int, seq_len: int) -> int:
    """Forward operations of a recurrent model's token mixers over `tokens`
    tokens of `seq_len`-token rows, all layers: RWKV6's chunked WKV (a
    chunk of C = the largest divisor of the row up to 32: a token's state
    term and update, 2·K·V each, and its C pairs, 2·(K + V) each), or
    Hymba's attention (QK and PV) plus its scan (6 a state a step: the
    decay's product, the input, the update and the read-out)."""
    H, hd, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    if cfg.family == "ssm":
        C = next(c for c in range(min(32, seq_len), 0, -1)
                 if seq_len % c == 0)
        return tokens * H * (4 * hd * hd + 2 * C * 2 * hd) * L
    di = cfg.ssm_expand * cfg.d_model
    return (4 * tokens * seq_len * H * hd + 6 * tokens * di * cfg.ssm_state
            ) * L


def train_run(api, params, n, lr: float, steps: int, seq_len: int,
              global_batch: int, seed: int = 0, sync=None, param_dtype=None,
              edit=None, digest: bool = False):
    """`steps` steps of `make_manual_train_step` on `api` from `params`
    (the port's per-layer tree, on the device the run takes) on the local
    mesh `n` (a rank count, or (axis, size) pairs), with `sync`
    (default: the step's own, the per-leaf path) and shards of
    `param_dtype` (default bf16), on the trainer's pipeline
    (`train.data_config`: stub embeddings, M-RoPE streams and frames
    where the model takes them), each step's numpy batch passed through
    `edit(batch, step)` where given: the state, per-step losses, gnorms,
    host-clock step times (each ending in the loss's copy to the host),
    device times of the step's parts, and the step; with `digest` (a
    process mesh `n`) step 1's gathered-copy checksum."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import (batch_tensors, data_config,
                                          make_manual_train_step, phase_ms,
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
    data = SyntheticLM(data_config(api.cfg, seq_len, global_batch, seed))
    out = {"losses": [], "gnorms": [], "step_s": [], "phase_ms": [],
           "ep_exchanges": [], "digest": None}
    for s in range(steps):
        t0 = time.perf_counter()
        batch = data.batch_at(s)
        if edit is not None:
            batch = edit(batch, s)
        step.digest = digest and s == 0
        state, m = step(state, batch_tensors(batch, where))
        if "digest" in m:
            out["digest"] = m["digest"]
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["gnorms"].append(gnorm)
        out["phase_ms"].append(phase_ms(m))
        out["ep_exchanges"].append(m.get("ep_exchanges"))
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
    flat = plan.strategy != "plan"          # a flat label: no schedule
    sched = None if flat else plan.schedule
    cs = None if flat else sched.inner
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
    elif flat:
        plan_txt = (f"flat {plan.strategy}"
                    + (f" factors {plan.factors}" if plan.factors else "")
                    + (f" (predicted {plan.predicted * 1e3:.3f} ms)"
                       if plan.predicted is not None else ""))
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
    if flat:
        rs_folds = flat_folds(plan.strategy, plan.factors, n,
                              "reduce_scatter")
        ag_folds = flat_folds(plan.strategy, plan.factors, n, "all_gather")
    else:
        rs_folds = sum(len(st.folds) for st in family_steps(
            cs, "reduce_scatter"))
        ag_folds = sum(len(st.folds) for st in family_steps(cs,
                                                            "allgather"))
    if bp is None:
        n_ag = n_rs = len(shards)
    else:
        n_ag, n_rs = len(step.gather_buckets), len(step.scatter_buckets)
    want = steps * (n_ag * ag_folds + n_rs * rs_folds)
    log(f"train [{label}]: fused_reduce launches {counts['fused_reduce']} = "
        f"{steps} steps x ({n_ag} all-gathers x {ag_folds} landing phases "
        f"+ {n_rs} reduce-scatters x {rs_folds} fold phases) -> expected "
        f"{want}; launches {json.dumps(counts)}; attention kernels "
        f"{json.dumps(by_kernel)}; guard "
        f"{json.dumps(sched.stats) if sched is not None else 'none (flat)'}")
    if counts["fused_reduce"] != want:
        fail(f"train [{label}] launched fused_reduce "
             f"{counts['fused_reduce']} time(s), expected {want}")
    for name, count in counts.items():
        if name != "fused_reduce" and count:
            fail(f"train [{label}] launched {name} {count} time(s)")
    if any(by_kernel.values()):
        fail(f"train [{label}] ran attention kernels {by_kernel}")
    if sched is not None and (sched.demotions or sched.stats["failures"]):
        fail(f"train [{label}]: guard {sched.stats}, {sched.demotions} "
             f"demotion(s)")
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    parts = {k: statistics.median(p[k] for p in res["phase_ms"][1:])
             for k in PHASES}
    bounds = train_bounds(cfg, cs, shards, n, tr["seq_len"],
                          tr["global_batch"], step, plan)
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
    return {"counts": counts, "losses": losses, "step": step, "peak": peak,
            "step_ms": step_ms, "parts": parts}


def level_launches(step, leaves: int, steps: int) -> dict:
    """Kernel launches of `steps` per-leaf steps over the live axes of
    `step.mesh`: for each leaf and each axis plan, a flat label's
    reduce-scatter folds (`flat_folds`: one launch for every group of the
    other axes; its all-gather only copies), or a schedule's launches at
    its wire (`steps_launches`) of its reduce-scatter and all-gather,
    once a group of the other axes (`collectives._per_group`)."""
    sizes = dict(step.mesh)
    R = math.prod(sizes.values())
    out: dict = {}
    for pl in step.plans:
        n = sizes[pl.axis]
        if pl.strategy == "plan":
            cs = pl.schedule
            got = steps_launches(cs, family_steps(cs, "reduce_scatter")
                                 + family_steps(cs, "allgather"), R // n)
        else:
            got = {"fused_reduce": flat_folds(pl.strategy, pl.factors, n,
                                              "reduce_scatter")}
        for name, c in got.items():
            out[name] = out.get(name, 0) + steps * leaves * c
    return {k: v for k, v in out.items() if v}


def level_bytes(step, numels, dtype) -> tuple[int, int]:
    """(gather, reduce-scatter) bytes of one per-leaf step over the live
    axes of `step.mesh`, each launch's rows crossing device memory once:
    per leaf of `numels`, the reduce-scatter axis by axis in reverse mesh
    order on the shard the axis before left (padded to the axis's
    multiple), the all-gather in mesh order up to the same sizes; each
    schedule's `schedule_bytes` (a flat label's `flat_strategy_bytes`)
    once a group of the other axes."""
    import torch
    from repro_torch.core import collectives as C
    elem = torch.empty((), dtype=dtype).element_size()
    sizes = dict(step.mesh)
    R = math.prod(sizes.values())
    gather = scatter = 0
    for m in numels:
        cur, seen = m, []
        for pl in reversed(step.plans):
            n = sizes[pl.axis]
            G = R // n
            if pl.strategy == "plan":
                cs = pl.schedule
                mult = cs.num_blocks
                scatter += G * schedule_bytes(
                    cs, cur, dtype, family_steps(cs, "reduce_scatter"))
            else:
                mult = C._pad_multiple(n, pl.strategy)
                scatter += G * flat_strategy_bytes(
                    pl.strategy, pl.factors, n, cur, "reduce_scatter", elem)
            padded = -(-cur // mult) * mult
            seen.append((pl, n, G, padded))
            cur = padded // n
        for pl, n, G, padded in reversed(seen):
            if pl.strategy == "plan":
                cs = pl.schedule
                gather += G * schedule_bytes(cs, padded, dtype,
                                             family_steps(cs, "allgather"))
            else:
                gather += G * flat_strategy_bytes(
                    pl.strategy, pl.factors, n, padded, "all_gather", elem)
    return gather, scatter


def phase_train_levels(dev, lr: float, *, mesh, sync, label: str,
                       layers: int = TRAIN["layers"], base=None) -> dict:
    """The ZeRO-3 trainer at TRAIN's full width and seq, depth `layers`,
    per leaf on the local mesh `mesh` with `sync` (a bucketed request on
    two axes takes the per-leaf path, as the reference's does: checked),
    TRAIN["steps"] steps at `lr`, every launch count zeroed just before
    and read just after. Checks: finite and falling losses, finite
    gnorms, each kernel's launches exactly `level_launches` and no other
    kernel, no guard failure. Prints the plans, the losses (and their gap
    to `base`, the f32-wire run's, where given), the launches beside the
    count, the gather's and reduce-scatter's device ms (CUDA events,
    median after the first step) beside their byte bounds
    (`level_bytes`), the peak memory and the wall time. Returns the
    launch counts, the losses, the peak and the wall seconds."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build
    from repro_torch.models.tree import tree_items

    tr = TRAIN
    cfg = dataclasses.replace(get_config(tr["arch"]), n_layers=layers)
    steps = tr["steps"]
    torch.empty(1, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    api = build(cfg)
    res = train_run(api, api.init_params(
        torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev),
        mesh, lr, steps, tr["seq_len"], tr["global_batch"], sync=sync)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    by_kernel = dict(ops.ATTENTION_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    step = res["step"]
    losses, gnorms = res["losses"], res["gnorms"]
    numels = [math.prod(t.shape) for _, t in tree_items(api.params_spec())]
    want = level_launches(step, len(numels), steps)
    plans = "; ".join(
        (pl.schedule.describe() if pl.strategy == "plan"
         else f"axis {pl.axis} {pl.strategy}"
         + (f" factors {pl.factors}" if pl.factors else ""))
        for pl in step.plans)
    gap = ("" if base is None else "; gap to the f32 wire's losses "
           + str([f"{a - b:+.3e}" for a, b in zip(losses, base)]))
    log(f"train [{label}]: {cfg.name} layers={cfg.n_layers} (cut from "
        f"{get_config(tr['arch']).n_layers}) d={cfg.d_model}; mesh "
        f"{step.mesh}, wire {step.wire or 'f32'}, "
        f"{'bucketed' if step.bucket_plan is not None else 'per leaf'}; "
        f"plans {plans}; seq {tr['seq_len']}, global "
        f"batch {tr['global_batch']}, lr {lr}; losses {losses}; gnorms "
        f"{gnorms}{gap}; wall {wall:.1f} s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"train [{label}]: launches {json.dumps(counts)}, expected "
        f"{json.dumps(want)} ({len(numels)} leaves x {steps} steps, each "
        f"axis plan once a group of the other axes); attention kernels "
        f"{json.dumps(by_kernel)}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train [{label}]: non-finite loss or gnorm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"train [{label}]: the loss did not fall at lr {lr}: {losses}")
    if sync.bucket_bytes != 0 and len(step.mesh) > 1 \
            and step.bucket_plan is not None:
        fail(f"train [{label}]: a bucketed request on two axes kept its "
             "bucket plan; the reference takes the per-leaf path")
    if {k: v for k, v in counts.items() if v} != want:
        fail(f"train [{label}]: launches {counts}, expected {want}")
    if any(by_kernel.values()):
        fail(f"train [{label}] ran attention kernels {by_kernel}")
    for pl in step.plans:
        if pl.schedule is not None and (pl.schedule.demotions
                                        or pl.schedule.stats["failures"]):
            fail(f"train [{label}]: guard {pl.schedule.stats}")
    parts = {k: statistics.median(p[k] for p in res["phase_ms"][1:])
             for k in ("gather", "reduce_scatter")}
    gb, sb = level_bytes(step, numels, torch.bfloat16)
    log(f"train [{label}]: device gather {parts['gather']:.2f} ms (byte "
        f"bound {bound_ms(gb):.2f}), reduce-scatter "
        f"{parts['reduce_scatter']:.2f} ms (byte bound {bound_ms(sb):.2f});"
        f" step {statistics.median(res['step_s'][1:]) * 1e3:.1f} ms "
        f"(median of steps 2-{steps})")
    return {"counts": counts, "losses": losses, "peak": peak, "wall": wall}


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


def steps_launches(cs, steps, runs: int) -> dict:
    """Kernel launches of `runs` runs of `steps` of schedule `cs` at its
    wire: one fold kernel a fold phase (fused_reduce at full precision and
    on the bf16 wire; on a scaled wire quant_reduce, or dequantize where
    the phase only lands copies) and, on a scaled wire, one quantize a
    live round."""
    folds = sum(len(st.folds) for st in steps)
    if cs.wire is None or not cs.wire.scale_block:
        return {"fused_reduce": runs * folds}
    rounds = sum(1 for st in steps for rd in st.rounds if rd.perm)
    landings = 0
    for st in steps:
        for fd in st.folds:
            act = fd.blk >= 0
            landings += int(not fd.include_self[act].any() and bool(
                ((fd.ops[act] >= 0).sum(axis=1) == 1).all()))
    return {"quantize": runs * rounds, "dequantize": runs * landings,
            "quant_reduce": runs * (folds - landings)}


def sync_launches(cs, buckets: int) -> dict:
    """Kernel launches of `buckets` reduce-scatters and all-gathers through
    schedule `cs` at its wire (`steps_launches`)."""
    return steps_launches(cs, family_steps(cs, "reduce_scatter")
                          + family_steps(cs, "allgather"), buckets)


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


def phase_train_reference(dev, sync=None, label: str = "per-leaf",
                          mesh=None) -> float:
    """The trainer at smoke size in f32 on the card (fused_reduce on the
    card, the model in torch ops) against the same code on the CPU, from
    one state and the same batches, with `sync` (default: the per-leaf
    path) on the local mesh `mesh` (default: TRAIN's 8 ranks):
    TRAIN_SMOKE_STEPS steps, per-step loss and gnorm within 1e-4
    relative, as the served smoke models are held; the final shards
    within 1e-4 of each leaf's largest |value| but for at most 1e-4 of
    their elements, those within 2·lr a step (`shard_drift`). Returns
    the wall seconds of the two runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    t0 = time.perf_counter()
    api = build(smoke_config(get_config(TRAIN["arch"])))
    params = api.init_params(torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
    lr, steps = TRAIN["lr"], TRAIN_SMOKE_STEPS
    runs = {str(where): train_run(api, _to(params, where),
                                  mesh or TRAIN["local_ranks"], lr, steps,
                                  32, TRAIN["global_batch"], sync=sync,
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
    if sync is not None and sync.precision and step.wire != sync.precision:
        fail(f"train [{label}]: the step's wire is {step.wire}, not "
             f"{sync.precision}")
    wall = time.perf_counter() - t0
    log(f"train [{label}]: smoke-size card vs CPU wall {wall:.1f} s")
    return wall


def phase_train_all(dev) -> tuple[dict, dict]:
    """Phase 5: the per-leaf trainer at TRAIN's lr, then at each of
    TRAIN_FALL_LRS (the loss must fall), fused_reduce at the trainer's
    shapes; the bucketed trainer at the default plan (run (a), at the
    first of TRAIN_FALL_LRS: one bucket a half, the loss must fall, the
    per-leaf losses printed beside) and with bucket_bytes pinned to
    TRAIN_BUCKET_BYTES (run (b): its scatter buckets issued last first on
    every step); the two-level trainer over TRAIN_MESH and the per-leaf
    trainer on each of TRAIN_WIRES (`phase_train_levels`); `sync_bucketed`
    on the card (run (c)); and the smoke-size trainer on the card against
    the CPU, per leaf, bucketed (run (d), TRAIN_SMOKE_BUCKET_BYTES), per
    leaf over TRAIN_MESH and bucketed on the fp8 wire. Returns the launch
    counts of the
    full-width runs and of run (c), summed, and the per-leaf run at the
    first of TRAIN_FALL_LRS (its step time, parts and peak: phase auto's
    baseline)."""
    import torch
    from repro_torch.core.sync import SyncConfig
    from repro_torch.runtime.trace import Tracer

    recorder = FoldRecorder()
    counts = phase_train(dev, TRAIN["lr"], False, recorder)["counts"]
    per_leaf, baseline = {}, {}
    for lr in TRAIN_FALL_LRS:
        r = phase_train(dev, lr, True)
        per_leaf[lr] = r["losses"]
        for k in ("step_ms", "parts", "peak"):
            baseline.setdefault(k, r[k])
        for name, n in r["counts"].items():
            counts[name] += n
        del r
    torch.cuda.empty_cache()
    log_rows(trainer_rows(dev, recorder))
    del recorder
    torch.cuda.empty_cache()

    lr = TRAIN_FALL_LRS[0]
    # the per-leaf step with the flat labels, "gentree" and "auto" (psum):
    # the same weights and batches as the per-leaf plan run at lr, so step
    # 1's loss (no sync before it) is that run's to every digit, and the
    # later steps differ by the sums' roundings only
    base = per_leaf[lr]
    for sync_label in TRAIN_FLAT:
        r = phase_train(dev, lr, True, sync=SyncConfig(strategy=sync_label),
                        label=f"per-leaf, --sync {sync_label}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], base)]
        log(f"train [per-leaf, --sync {sync_label}]: losses {r['losses']} "
            f"against the plan run's {base}: step 1 "
            f"{'equal' if r['losses'][0] == base[0] else 'DIFFERS'}, steps"
            f" 2-{len(base)} rel {[f'{x:.2e}' for x in rel[1:]]}; step "
            f"{r['step_ms']:.1f} ms; peak {r['peak'] / 2**30:.2f} GiB")
        if r["losses"][0] != base[0] or max(rel[1:]) > 1e-2:
            fail(f"train [--sync {sync_label}]: losses {r['losses']} are "
                 f"not the plan run's {base} (step 1 exactly, then 1e-2)")
        for name, c in r["counts"].items():
            counts[name] += c
        del r
        torch.cuda.empty_cache()
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

    # the two-level mesh, then the lossy wires per leaf: the same weights
    # and batches as the per-leaf plan run at lr
    r = phase_train_levels(dev, lr, mesh=TRAIN_MESH,
                           sync=SyncConfig(strategy="plan"),
                           label="two-level (pod 2, data 4), sync plan")
    for name, n in r["counts"].items():
        counts[name] += n
    del r
    torch.cuda.empty_cache()
    for wire in TRAIN_WIRES:
        r = phase_train_levels(
            dev, lr, mesh=TRAIN["local_ranks"],
            sync=SyncConfig(strategy="plan", bucket_bytes=0,
                            precision=wire),
            label=f"per-leaf, {wire} wire", layers=TRAIN_LOSSY_LAYERS,
            base=base if TRAIN_LOSSY_LAYERS == TRAIN["layers"] else None)
        for name, n in r["counts"].items():
            counts[name] += n
        del r
        torch.cuda.empty_cache()

    for name, n in phase_sync_bucketed(dev).items():
        counts[name] += n
    torch.cuda.empty_cache()
    phase_train_reference(dev)
    phase_train_reference(dev, SyncConfig(
        strategy="plan", bucket_bytes=TRAIN_SMOKE_BUCKET_BYTES),
        label="bucketed")
    phase_train_reference(dev, SyncConfig(strategy="plan", bucket_bytes=0),
                          label="two-level (pod 2, data 4), per leaf",
                          mesh=TRAIN_MESH)
    phase_train_reference(dev, SyncConfig(
        strategy="plan", bucket_bytes=TRAIN_SMOKE_BUCKET_BYTES,
        precision="fp8"), label="bucketed, fp8 wire")
    return counts, baseline


# ---------------------------------------------------------------------------
# MoE training
# ---------------------------------------------------------------------------
class ExchangeRecorder:
    """Spies on the EP exchange (`core.sync._ep_run`, both directions of
    `ep_exchange`): per call its operand's shape and dtype, the
    fused_reduce launches inside it and, on a card, CUDA events around
    it (`ms` waits for the last)."""

    def __init__(self):
        from repro_torch.core import sync
        self.sync = sync
        self.real = sync._ep_run
        self.calls: list[dict] = []

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        rec = self

        def spy(x, axis_name, schedule, mesh):
            on_card = x.is_cuda
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if on_card else None
            before = ops.LAUNCHES["fused_reduce"]
            if ev:
                ev[0].record()
            out = rec.real(x, axis_name, schedule, mesh)
            if ev:
                ev[1].record()
            rec.calls.append({"shape": tuple(x.shape), "dtype": x.dtype,
                              "launches": ops.LAUNCHES["fused_reduce"]
                              - before, "events": ev})
            return out
        self.sync._ep_run = spy
        return self

    def __exit__(self, *exc):
        self.sync._ep_run = self.real

    def ms(self) -> list[float]:
        import torch
        if not self.calls or self.calls[-1]["events"] is None:
            return []
        torch.cuda.synchronize()
        return [c["events"][0].elapsed_time(c["events"][1])
                for c in self.calls]


class RouteRecorder:
    """Spies on `layers.moe_route`: per call (a rank's tokens in one MoE
    layer, in the forward or its recompute) the slots the one-block
    dispatch drops (past each expert's capacity over the call's tokens)
    and the smallest margin between a token's k-th and (k+1)-th router
    probability. It calls the real router."""

    def __init__(self):
        from repro_torch.models import layers
        self.mod = layers
        self.real = layers.moe_route
        self.calls: list[tuple[int, float]] = []

    def __enter__(self):
        import torch
        rec = self

        def spy(p, xt, k):
            probs, topv, topi = rec.real(p, xt, k)
            E = probs.shape[-1]
            cap = rec.mod.moe_capacity(xt.shape[0], k, E, 1.25)
            counts = torch.bincount(topi.reshape(-1), minlength=E)
            top = probs.detach().sort(dim=-1, descending=True).values
            rec.calls.append((int((counts - cap).clamp(min=0).sum()),
                              float((top[:, k - 1] - top[:, k]).min())))
            return probs, topv, topi
        self.mod.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.real

    def per_step(self, steps: int, layers: int, ranks: int
                 ) -> tuple[list[int], float]:
        """(slots dropped in each step's forward, the smallest margin),
        checking that each step ran its layers' routes twice (forward
        and recompute) with the same drops."""
        per = layers * ranks
        if len(self.calls) != 2 * per * steps:
            fail(f"moe train: {len(self.calls)} router calls, expected "
                 f"{2 * per * steps} (forward and recompute)")
        drops = []
        for s in range(steps):
            block = self.calls[2 * per * s:2 * per * (s + 1)]
            fwd = sum(d for d, _ in block[:per])
            if fwd != sum(d for d, _ in block[per:]):
                fail(f"moe train: step {s + 1} recompute routed otherwise")
            drops.append(fwd)
        return drops, min(m for _, m in self.calls)


def exchange_folds(step) -> int:
    """fused_reduce launches of one EP exchange: the planned all-to-all's
    fold phases, once a group of the other axes (none for the flat
    copy)."""
    cs = step.ep_schedule
    if cs is None:
        return 0
    n = dict(step.mesh)[step.ep[0]]
    groups = math.prod(s for _, s in step.mesh) // n
    return groups * sum(len(st.folds) for st in family_steps(
        cs.inner, "all_to_all"))


def moe_launches(step, leaves: int, steps: int, exchanges: int) -> dict:
    """Exact fused_reduce launches of a per-leaf MoE run: the gathers'
    and reduce-scatters' (`level_launches`) and the exchanges'."""
    base = level_launches(step, leaves, steps)
    ex = exchanges * exchange_folds(step)
    return {"sync": base.get("fused_reduce", 0), "exchange": ex,
            "fused_reduce": base.get("fused_reduce", 0) + ex}


def phase_train_moe(dev) -> dict:
    """Phase 5m: the MoE trainer at full width (`train_full_width`), its
    exchange timed alone and its landing fold as a kernel row, then the
    smoke-size trainer on the card against the CPU (module docstring).
    Returns the full-width run's kernel launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import collectives

    t_phase = time.perf_counter()
    tr = TRAIN_MOE
    full_cfg = get_config(tr["arch"])
    cfg = dataclasses.replace(full_cfg, n_layers=tr["layers"])
    label = "train [MoE, EP plan]"

    def exchange_alone(res, ex):
        e_cs = res["step"].ep_schedule
        ex_ms = ex.ms()
        buf = ex.calls[0]
        ex_bytes = 2 * math.prod(buf["shape"]) * buf["dtype"].itemsize
        sched_b = schedule_bytes(e_cs.inner, math.prod(buf["shape"][1:]),
                                 buf["dtype"], family_steps(e_cs.inner,
                                                            "all_to_all"))
        steps = tr["steps"]
        ex_step = sum(ex_ms[len(ex_ms) // steps:2 * len(ex_ms) // steps])
        x = torch.randn(buf["shape"], device=dev).to(buf["dtype"])
        with FoldRecorder() as folds:
            alone = device_ms(lambda: collectives.all_to_all(
                x, "data", schedule=e_cs))
        # fused_reduce at the exchange's landing shape (gathered form, the
        # schedule's first landing table)
        src_shape, src_dtype, table, out_shape, out_dtype = next(iter(
            folds.calls.values()))
        r = measure(fused_reduce_into_case(src_shape, src_dtype, table,
                                           out_shape, out_dtype, dev))
        log_rows([("fused_reduce", f"EP exchange landing: into B="
                   f"{table.rows.shape[0]} K={table.rows.shape[1]} L="
                   f"{src_shape[1]} {src_dtype}->{out_dtype}", r)])
        if r["max_abs_err"] != 0.0:
            fail(f"fused_reduce at the exchange's landing differs from its "
                 f"plain version by {r['max_abs_err']}")
        mib = math.prod(buf["shape"][1:]) * buf["dtype"].itemsize / 2**20
        log(f"{label}: exchanges {len(ex_ms) // steps} a step of "
            f"{buf['shape']} {buf['dtype']} ({mib:.2f} MiB a rank), device "
            f"ms a step (step 2) {ex_step:.3f}, each median "
            f"{statistics.median(ex_ms):.4f} (min {min(ex_ms):.4f}, max "
            f"{max(ex_ms):.4f}) against the in+out bound "
            f"{bound_ms(ex_bytes):.4f} and the schedule's byte bound "
            f"{bound_ms(sched_b):.4f}; alone {alone:.4f} ms; exchange guard "
            f"{json.dumps(e_cs.stats)}")

    counts = train_full_width(dev, cfg, full_cfg.n_layers, tr["local_ranks"],
                              tr, label, then=exchange_alone)
    for mesh, mlabel in ((tr["local_ranks"], "EP over data (8)"),
                         (TRAIN_MESH, "(pod 2, data 4), EP over pod (2)")):
        phase_train_smoke_reference(dev, tr["arch"], f"MoE smoke, {mlabel}",
                                    mesh=mesh, seq_len=32)
    log(f"phase moe train: wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# recurrent training
# ---------------------------------------------------------------------------
MODEL_KERNELS = ("wkv", "ssm_scan", "rmsnorm", "flash_attention")


def phase_train_recurrent(dev) -> tuple[dict, dict]:
    """Phase 5r: each of TRAIN_RECURRENT's models through the ZeRO-3
    trainer at full width (`train_full_width`), one rank's pass profiled,
    then its smoke-size trainer on the card against the CPU (module
    docstring). Returns the full-width runs' kernel launches, summed, and
    FT_ARCH's run (its depth, losses and fused_reduce launches: phase
    ft's baseline)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    tr = TRAIN_RECURRENT
    total: dict = {}
    baseline: dict = {}
    for arch, layers in tr["runs"]:
        full_cfg = get_config(arch)
        cfg = (full_cfg if layers is None
               else dataclasses.replace(full_cfg, n_layers=layers))

        def keep(res, _ex, arch=arch, layers=cfg.n_layers):
            if arch == FT_ARCH:
                baseline.update(layers=layers, losses=list(res["losses"]))
        counts = train_full_width(dev, cfg, full_cfg.n_layers,
                                  tr["local_ranks"], tr,
                                  f"train [recurrent, {arch}]", then=keep)
        if arch == FT_ARCH:
            baseline["fused_reduce"] = counts["fused_reduce"]
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        recurrent_profile(dev, build(cfg), tr["seq_len"])
        phase_train_smoke_reference(dev, arch, f"recurrent smoke, {arch}")
    log(f"phase recurrent train: wall {time.perf_counter() - t_phase:.1f} s")
    return total, baseline


def recurrent_profile(dev, api, seq_len: int) -> None:
    """Where one rank's forward and backward goes: `api`'s model at the
    trainer's shapes (one row of `seq_len` tokens, random bf16 weights,
    remat on), one warm-up pass, then one under torch.profiler. Prints
    the wall time, the kernels launched, the device's busy time (the
    union of kernel, copy and set intervals in the trace) and its share
    of the wall time, and the kernels that take most device time."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = api.cfg
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    leaves = [t.requires_grad_(True) for t in _tensors(params)]
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, seq_len + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fwd_bwd():
        loss = api.loss_fn(params, batch, remat=True)
        torch.autograd.grad(loss, leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "train_trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    del params, leaves
    torch.cuda.empty_cache()
    dev_events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev_events if e["cat"] == "kernel"]
    label = f"train profile: {cfg.name}, one rank's forward and backward"
    if not kernels:
        log(f"{label}: wall {wall_us / 1e3:.1f} ms; the trace holds no "
            f"kernel: device time not measured")
        return
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev_events)
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    log(f"{label}: wall {wall_us / 1e3:.1f} ms (profiled), {len(kernels)} "
        f"kernels, device busy {busy / 1e3:.2f} ms ({busy / wall_us:.1%} "
        f"of wall), {wall_us / len(kernels):.1f} us of wall a kernel")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:5]:
        log(f"{label}: {us / 1e3:.2f} ms in {count} x {name[:90]}")


# ---------------------------------------------------------------------------
# the last three configurations' training
# ---------------------------------------------------------------------------
def family_reckon_bytes(cfg, n: int) -> int:
    """The per-leaf trainer's memory reckoning of `cfg` on n ranks (phases
    5r and 5f print it beside the peak): the ZeRO-3 state
    (`_state_bytes`), the ranks' bf16 gradient rows (n · 2 B a parameter)
    and one gathered bf16 copy, before any temporary."""
    import torch
    from repro_torch.models.registry import build
    from repro_torch.models.tree import tree_items
    params = sum(math.prod(t.shape) for _, t in tree_items(
        build(cfg).params_spec(torch.bfloat16)))
    return _state_bytes(cfg, n) + (2 * n + 2) * params


def train_full_width(dev, cfg, full_layers: int, n: int, tr: dict,
                     label: str, then=None) -> dict:
    """`cfg` (depth cut from `full_layers` where it differs) through the
    ZeRO-3 trainer on n local ranks from random bf16 weights, `tr`'s
    steps, seq, global batch and lr, per leaf with
    `SyncConfig(strategy="plan", bucket_bytes=0)`, every launch count
    zeroed just before and read just after. Checks finite losses falling
    at that lr, a peak under TRAIN_PEAK_GIB, the exact fused_reduce
    launches (`level_launches`; a MoE model's EP over "data" with its
    exchanges', `moe_launches`), no model kernel and no guard failure;
    prints them, the step time and its parts beside `train_bounds`. Then
    `then(res, ex)`, where given, while the run's state is alive. Returns
    the launches."""
    import torch
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import AUDIO_FRAMES, PHASES
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.registry import build

    steps = tr["steps"]
    L = cfg.n_layers
    sync = SyncConfig(strategy="plan", bucket_bytes=0)
    torch.empty(1, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    api = build(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with ExchangeRecorder() as ex, RouteRecorder() as routes:
        res = train_run(api, params, n, tr["lr"], steps, tr["seq_len"],
                        tr["global_batch"], sync=sync)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    by_kernel = dict(ops.ATTENTION_LAUNCHES)
    del params
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    step = res["step"]
    shards = res["state"]["params"]
    losses, gnorms = res["losses"], res["gnorms"]
    (plan,) = step.plans
    cs = plan.schedule.inner
    largest = max(shards, key=lambda t: t.numel())
    reckon = family_reckon_bytes(cfg, n)
    log(f"{label}: {cfg.family}, layers={L} (of {full_layers})"
        + (f" + {cfg.n_encoder_layers} encoder layers, "
           f"{AUDIO_FRAMES} stub frames"
           if cfg.family == "audio" else "")
        + f" d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab}"
        + (f" experts {cfg.n_experts} top {cfg.top_k} shared "
           f"{cfg.n_shared_experts} d_ff_expert {cfg.d_ff_expert} windows "
           f"{cfg.window_pattern}"
           if cfg.n_experts else "")
        + (f" M-RoPE sections {cfg.mrope_sections}"
           if cfg.mrope_sections else "")
        + (f" ssm {cfg.ssm_expand * cfg.d_model} x {cfg.ssm_state}"
           f" windows {cfg.window_pattern}"
           if cfg.family == "hybrid" else "")
        + f"; {sum(t.numel() for t in shards) / 1e6:.1f} M parameters "
        f"(padded) in {len(shards)} leaves, the largest "
        f"{largest.numel() / 1e6:.1f} M; {n} local ranks, seq "
        f"{tr['seq_len']}, global batch {tr['global_batch']}, lr "
        f"{tr['lr']}; sync plan {cs.describe()}"
        + (f"; EP over {step.ep}, exchange "
           f"{step.ep_schedule.inner.describe()}" if step.ep else "")
        + f"; losses {losses}; gnorms {gnorms}; wall {wall:.1f} s; peak "
        f"memory {peak / 2**30:.2f} GiB (reckoned {reckon / 2**30:.2f} "
        f"GiB before temporaries; {reserved / 2**30:.2f} GiB reserved)")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"{label}: non-finite loss or gnorm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall at lr {tr['lr']}: "
             f"{losses}")
    if peak / 2**30 >= TRAIN_PEAK_GIB:
        fail(f"{label}: peak memory {peak / 2**30:.2f} GiB, not under "
             f"{TRAIN_PEAK_GIB}")
    if cfg.n_experts:
        per_step = {"forward": 2 * L, "recompute": 2 * L,
                    "backward": 2 * L}
        if (step.ep != ("data", n) or step.ep_schedule is None
                or res["ep_exchanges"] != [per_step] * steps):
            fail(f"{label}: EP {step.ep}, schedule {step.ep_schedule}, "
                 f"exchanges {res['ep_exchanges']}, expected {per_step} a "
                 f"step over ('data', {n})")
        n_ex = 6 * L * steps
        want = {"fused_reduce": moe_launches(step, len(shards), steps,
                                             n_ex)["fused_reduce"]}
        ex_launches = sum(c["launches"] for c in ex.calls)
        drops, margin = routes.per_step(steps, L, n)
        ex_ms = ex.ms()
        tokens = tr["seq_len"] * tr["global_batch"] // n
        log(f"{label}: {n_ex} exchanges of {ex.calls[0]['shape']} "
            f"{ex.calls[0]['dtype']}, {ex_launches} fused_reduce "
            f"launches in them ({exchange_folds(step)} an exchange), "
            f"device ms each median {statistics.median(ex_ms):.4f}; "
            f"{cfg.n_experts // n} experts a rank, capacity "
            f"{moe_capacity(tokens, cfg.top_k, cfg.n_experts, 1.25)} a "
            f"rank's {tokens} tokens; slots dropped a step {drops} of "
            f"{n * L * tokens * cfg.top_k}; smallest top-k margin "
            f"{margin:.3e}")
        if (len(ex.calls) != n_ex
                or ex_launches != n_ex * exchange_folds(step)):
            fail(f"{label}: {len(ex.calls)} exchanges launching "
                 f"{ex_launches}, expected {n_ex} of "
                 f"{exchange_folds(step)}")
    else:
        want = level_launches(step, len(shards), steps)
        if ex.calls or routes.calls:
            fail(f"{label}: {len(ex.calls)} exchanges, "
                 f"{len(routes.calls)} routes in a model without MoE")
    log(f"{label}: launches {json.dumps(counts)} (expected {want}: "
        f"{steps} steps x {len(shards)} leaves x the gather's and "
        f"reduce-scatter's fold phases"
        + (" + the exchanges'" if step.ep else "")
        + f"); attention kernels {json.dumps(by_kernel)}; guard "
        f"{json.dumps(plan.schedule.stats)}")
    if {k: c for k, c in counts.items() if c} != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if any(counts[k] for k in MODEL_KERNELS) or any(by_kernel.values()):
        fail(f"{label}: the training step launched a model kernel: "
             f"{counts} {by_kernel}")
    for sc in (plan.schedule, step.ep_schedule):
        if sc is not None and (sc.demotions or sc.stats["failures"]):
            fail(f"{label}: guard {sc.stats}, {sc.demotions} "
                 "demotion(s)")
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    parts = {kk: statistics.median(pm[kk] for pm in res["phase_ms"][1:])
             for kk in PHASES}
    bounds = train_bounds(cfg, cs, shards, n, tr["seq_len"],
                          tr["global_batch"], step, plan)
    log(f"{label}: step time median of steps 2-{steps} {step_ms:.1f} ms "
        f"(first {res['step_s'][0] * 1e3:.1f} ms; steps "
        f"{[round(v * 1e3, 1) for v in res['step_s']]}); device parts "
        + ", ".join(f"{kk} {parts[kk]:.2f} ms (bound {bounds[kk]:.2f})"
                    for kk in PHASES)
        + f"; sum {sum(parts.values()):.2f} ms; one rank's forward and "
        f"backward bound: bytes {bounds['rank_bytes_ms']:.3f} ms, "
        f"products {bounds['rank_flops_ms']:.3f} ms")
    if then is not None:
        then(res, ex)
    del res, shards, step, largest
    torch.cuda.empty_cache()
    return counts


def phase_train_family(dev) -> dict:
    """Phase 5f: each of TRAIN_FAMILY's models through the ZeRO-3 trainer
    at full width (`train_full_width`), then its smoke-size trainer on
    the card against the CPU (module docstring). Returns the full-width
    runs' kernel launches, summed."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    tr = TRAIN_FAMILY
    total: dict = {}
    for arch, layers, n in tr["runs"]:
        full_cfg = get_config(arch)
        cfg = (full_cfg if layers is None else dataclasses.replace(
            full_cfg, n_layers=layers,
            n_encoder_layers=min(layers, full_cfg.n_encoder_layers)))
        counts = train_full_width(dev, cfg, full_cfg.n_layers, n, tr,
                                  f"train [family, {arch}]")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        phase_train_smoke_reference(dev, arch, f"family smoke, {arch}")
    log(f"phase family train: wall {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_train_smoke_reference(dev, arch: str, label: str, mesh=8,
                                seq_len: int = 48) -> None:
    """`arch`'s trainer at smoke size (REFERENCE_CFG's overrides) in f32
    on the card against the same code on the CPU, per leaf on the local
    mesh `mesh`, from one state and the same `seq_len`-token batches
    (qwen2-vl's three position streams drawn apart in [0, 2048), so
    M-RoPE's h and w sections turn): TRAIN_SMOKE_STEPS steps, per-step
    loss and gnorm within 1e-4 relative, the final shards as
    `shard_drift` says, the same MoE slots dropped on both,
    fused_reduce alone launched exactly on the card (`level_launches`;
    with an EP step's exchanges, `moe_launches`) and nothing on the
    CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import ops
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build

    t0 = time.perf_counter()
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              **REFERENCE_CFG.get(arch, {}))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
    lr, steps = TRAIN["lr"], TRAIN_SMOKE_STEPS

    def apart(batch, s):
        if "mrope_positions" not in batch:
            return batch
        rng = np.random.default_rng(100 + s)
        return {**batch, "mrope_positions": rng.integers(
            0, 2048, batch["mrope_positions"].shape)}
    sync = SyncConfig(strategy="plan", bucket_bytes=0)
    runs, counts, drops = {}, {}, {}
    for where in ("cpu", dev):
        ops.reset_launches()
        with RouteRecorder() as routes:
            runs[str(where)] = train_run(api, _to(params, where), mesh, lr,
                                         steps, seq_len,
                                         TRAIN["global_batch"], sync=sync,
                                         param_dtype=torch.float32,
                                         edit=apart)
        counts[str(where)] = {k: c for k, c in ops.LAUNCHES.items() if c}
        drops[str(where)] = (routes.per_step(steps, cfg.n_layers, 8)
                             if cfg.n_experts else ([], 0.0))
    card, cpu = runs[str(dev)], runs["cpu"]
    step = card["step"]
    leaves = len(card["state"]["params"])
    want = ({"fused_reduce": moe_launches(step, leaves, steps, 6
                                          * cfg.n_layers * steps)
             ["fused_reduce"]} if step.ep
            else level_launches(step, leaves, steps))
    metric_err = max(abs(g - c) / abs(c) for kk in ("losses", "gnorms")
                     for g, c in zip(card[kk], cpu[kk]))
    far, total, worst = shard_drift([t.cpu() for t in card["state"]["params"]],
                                    cpu["state"]["params"], lr, steps)
    log(f"train [{label}]: f32 {steps} steps card vs CPU"
        + (f", EP {step.ep}, exchange {step.ep_schedule.inner.describe()}"
           if step.ep else "") + f": losses "
        f"{card['losses']} / {cpu['losses']}, gnorms {card['gnorms']} / "
        f"{cpu['gnorms']}; rel err {metric_err:.2e}"
        + (f"; slots dropped a step {drops[str(dev)][0]} / "
           f"{drops['cpu'][0]}, smallest top-k margin "
           f"{drops[str(dev)][1]:.3e} / {drops['cpu'][1]:.3e}"
           if cfg.n_experts else "")
        + f"; final shards: {far} of {total} elements past 1e-4 of their "
        f"leaf's largest |value|, the farthest {worst:.3f} of 2·lr·steps; "
        f"card launches {counts[str(dev)]} (expected {want}); wall "
        f"{time.perf_counter() - t0:.1f} s")
    if not (metric_err <= 1e-4 and far <= 1e-4 * total and worst <= 1.0):
        fail(f"the card's smoke-size {arch} trainer [{label}] disagrees "
             f"with the CPU run: {metric_err:.2e}, {far} of {total} shard "
             f"elements, {worst:.3f}")
    if drops[str(dev)][0] != drops["cpu"][0]:
        fail(f"{arch} smoke [{label}]: drops {drops}")
    if counts[str(dev)] != want:
        fail(f"{arch} smoke [{label}]: card launches {counts[str(dev)]}, "
             f"expected {want}")
    if counts["cpu"]:
        fail(f"{arch} smoke [{label}]: the CPU run launched {counts['cpu']}")


# ---------------------------------------------------------------------------
# the checkpointed trainer
# ---------------------------------------------------------------------------
class CheckpointRecorder:
    """Spies on `CheckpointManager`: after each write, the save's bytes,
    host-snapshot and write-plus-CRC seconds (`saves`); around each
    restore, the device memory live before it and the device peak during
    it (the peak statistics are reset before it; the peak before it is
    kept in `peak_before`), with the restore's checksum, read and copy
    seconds (`restores`)."""

    def __init__(self):
        from repro_torch.checkpoint.store import CheckpointManager
        self.cls = CheckpointManager
        self.real = (CheckpointManager._write, CheckpointManager.restore)
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        self.peak_before = 0

    def __enter__(self):
        import torch
        real_write, real_restore = self.real
        rec = self

        def write(mgr, step, host):
            real_write(mgr, step, host)
            rec.saves.append(dict(mgr.last_save))

        def restore(mgr, like, step=None):
            torch.cuda.synchronize()
            rec.peak_before = max(rec.peak_before,
                                  torch.cuda.max_memory_allocated())
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real_restore(mgr, like, step)
            torch.cuda.synchronize()
            rec.restores.append({
                "live": live, "peak": torch.cuda.max_memory_allocated(),
                "seconds": time.perf_counter() - t0, **mgr.last_restore})
            return out
        self.cls._write, self.cls.restore = write, restore
        return self

    def __exit__(self, *exc):
        self.cls._write, self.cls.restore = self.real


def ft_launches(out) -> tuple[int, int, int]:
    """(fused_reduce launches of one step call, of one gather launch, of
    one scatter launch) of a `run_training` result: each all-gather's fold
    phases, each reduce-scatter's, a leaf each per leaf, a bucket each
    bucketed."""
    (plan,) = out["plans"]
    cs = plan.schedule.inner
    step = out["step"]
    rs = sum(len(st.folds) for st in family_steps(cs, "reduce_scatter"))
    ag = sum(len(st.folds) for st in family_steps(cs, "allgather"))
    if step.bucket_plan is None:
        n_ag = n_rs = len(out["state"]["params"])
    else:
        n_ag, n_rs = len(step.gather_buckets), len(step.scatter_buckets)
    return n_ag * ag + n_rs * rs, ag, rs


def _gbps(nbytes: float, seconds: float) -> str:
    return f"{seconds:.3f} s ({nbytes / seconds / 1e9:.2f} GB/s)" \
        if seconds > 0 else f"{seconds:.3f} s"


def _state_bytes(cfg, n: int) -> int:
    """The bytes of the trainer's ZeRO-3 state of `cfg` on n ranks:
    shards in each leaf's dtype (bf16, or f32 where the model keeps it so:
    hymba-1.5b's SSM decay, skip and step leaves) and f32 m and v, each
    leaf padded to a multiple of n."""
    import torch
    from repro_torch.models.registry import build
    from repro_torch.models.tree import tree_items
    return sum(-(-math.prod(t.shape) // n) * n * (t.dtype.itemsize + 4 + 4)
               for _, t in tree_items(build(cfg).params_spec(
                   torch.bfloat16))) + 4


# ---------------------------------------------------------------------------
# Phase mp: the process mesh (one process a rank over torch.distributed)
# ---------------------------------------------------------------------------
def mp_schedules(n: int = MP_RANKS):
    """Phase mp (a)'s cases for n ranks, built alike in the parent and in
    every rank: (label, family, size, schedule) for GenTree, cps and ring
    on single_switch(n) and, for an even n of 4 or more,
    symmetric_tree(2, n / 2), at MP_SIZES (family "allreduce": its
    allreduce, reduce_scatter and all_gather), and the planner's
    all-to-all and p2p schedules (the flat ones, once a size)."""
    from repro_torch.core.gentree import baseline_plan
    from repro_torch.core.lower import lower_plan
    from repro_torch.core.topology import single_switch, symmetric_tree
    from repro_torch.planner.service import default_service

    svc = default_service()
    topos = [(f"single_switch({n})", single_switch(n))]
    if n >= 4 and n % 2 == 0:
        topos.append((f"symmetric_tree(2,{n // 2})",
                      symmetric_tree(2, n // 2)))
    out, seen = [], set()
    for size, label in MP_SIZES:
        for tname, topo in topos:
            for plan in MP_PLANS:
                cs = (svc.get_executable(topo, size * 4).schedule
                      if plan == "gentree" else
                      lower_plan(baseline_plan(plan, topo, float(size))))
                out.append((f"{plan} {tname} {label}", "allreduce", size,
                            cs))
            for family in ("all_to_all", "p2p"):
                cs = svc.get_family_executable(family, "x", n, size,
                                               topo=topo).schedule
                if (id(cs), size) not in seen:
                    seen.add((id(cs), size))
                    out.append((f"{family} {tname} {label}", family, size,
                                cs))
    return out


def mp_row(size: int, seed: int, r: int, dev):
    """Rank r's input of a phase-mp case: its own generator, so a rank
    makes its row alone and the parent all of them."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed * 1009 + r)
    return torch.randn(size, generator=g, device=dev)


def mp_calls(family: str):
    """The entry points a case runs, each (name, uses the previous
    result): a reduce-scatter's shard feeds the all-gather."""
    if family == "allreduce":
        return (("allreduce", False), ("reduce_scatter", False),
                ("all_gather", True))
    return ((family, False),)


MP_LOCAL = {"allreduce": "run_local",
            "reduce_scatter": "run_local_reduce_scatter",
            "all_gather": "run_local_all_gather",
            "all_to_all": "run_local_all_to_all", "p2p": "run_local_p2p"}


def mp_exec_worker(pm) -> dict:
    """Phase mp (a) and (c) as one rank of the 8-process mesh: every case
    of `mp_schedules` in f32 and each wire through the guard, each call's
    result digest and its kernel launches beside `dist_launches`; the
    f32 and fp8 AllReduces at the gradient size timed once more (the
    slowest rank's host time to a synchronize, each call started
    together); then `observe_sync_probe` and `measure_dist_cps`."""
    import torch
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.core.lower import guard_schedule
    from repro_torch.kernels import ops
    from repro_torch.core.transport import all_gather_rows
    from repro_torch.launch.train import observe_sync_probe, params_digest
    from repro_torch.planner.calibrate import measure_dist_cps
    from repro_torch.planner.service import default_service

    dev, ax = pm.device, pm.axis_names[0]
    m = pm.index(ax)
    everyone = pm.line(pm.axis_names)
    ops.reset_launches()
    out = {"digests": {}, "launches": {}, "expected": {}, "ms": {},
           "demotions": 0}
    for ci, (label, family, size, cs) in enumerate(mp_schedules(pm.size)):
        x = mp_row(size, ci, pm.rank, dev)
        for wire in (None, "bf16", "fp8", "int8"):
            w = cs.with_wire(None if wire is None else PRECISIONS[wire])
            sched = guard_schedule(w)
            prev = None
            for name, chained in mp_calls(family):
                before = dict(ops.LAUNCHES)
                got = getattr(sched, name)(prev if chained else x, ax, pm)
                torch.cuda.synchronize()
                key = (label, wire or "f32", name)
                out["launches"][key] = {k: ops.LAUNCHES[k] - before[k]
                                        for k in EXECUTOR_KERNELS}
                out["expected"][key] = w.dist_launches(name, m)
                out["digests"][key] = params_digest([got])
                prev = got
            if size >= 1 << 24 and family == "allreduce" \
                    and wire in (None, "fp8"):
                all_gather_rows(pm, everyone, x[:1])
                t0 = time.perf_counter()
                sched.allreduce(x, ax, pm)
                torch.cuda.synchronize()
                mine = torch.tensor(time.perf_counter() - t0,
                                    dtype=torch.float64, device=dev)
                out["ms"][(label, wire or "f32")] = 1e3 * float(
                    all_gather_rows(pm, everyone, mine).max())
            out["demotions"] += sched.demotions + sched.stats["failures"]
            del prev, got
        del x
        torch.cuda.empty_cache()
    out["planned"] = mp_planned_worker(pm, everyone)
    lines = []
    out["probe"] = observe_sync_probe(default_service(), pm, None,
                                      MP_PROBE_FLOATS, lines.append)
    out["probe_lines"] = lines
    out["cps"] = [a.tolist() for a in measure_dist_cps(
        MP_CPS["ns"], MP_CPS["sizes"], pm)]
    out["totals"] = dict(ops.LAUNCHES)
    out["transport"] = pm.transport
    return out


MP_PLANNED_LABELS = tuple(label for label, _ in MP_PLANNED) + (
    "int8 cps", "sync int8 cps")


def mp_planned_run(label: str, x, ax: str, mesh, svc):
    """One call of phase mp (a'): `allreduce_planned`'s route `label` on
    the service `svc`, the int8 CPS AllReduce, or `sync_gradients` with
    `compress="int8"` on cps; x is the local mesh's (n, size) rows
    (`mesh` None) or this rank's (size,). Returns (result, stats)."""
    from repro_torch.core import collectives as C
    from repro_torch.core.bucketing import BucketConfig
    from repro_torch.core.sync import (SyncConfig, allreduce_int8_cps,
                                       sync_gradients)

    if label == "int8 cps":
        return allreduce_int8_cps(x, ax, mesh=mesh), {}
    if label == "sync int8 cps":
        n = x.shape[0] if mesh is None else mesh.axis_size(ax)
        return sync_gradients({"g": x}, [(ax, n)], SyncConfig(
            strategy="cps", compress="int8"), mesh=mesh)["g"], {}
    kw = dict(dict(MP_PLANNED)[label])
    if kw.pop("bucketing", False):
        kw["bucketing"] = BucketConfig()
    st = {}
    got = C.allreduce_planned(x, ax, service=svc, stats=st, mesh=mesh,
                              **kw)
    return got, st


def mp_planned_expected(label: str, st: dict, size: int, ax: str, pm,
                        svc) -> dict:
    """The kernel launches one rank of `pm` makes in an (a') call: one
    fused_reduce for the int8 CPS fold (its gather is copies); the
    schedule's `dist_launches` for the plan (at its wire), a bucket's
    reduce-scatter and all-gather (or its AllReduce without canonical
    halves) for each bucket."""
    from repro_torch.core.bucketing import BucketConfig
    from repro_torch.core.cost_model import PRECISIONS

    if label in ("int8 cps", "sync int8 cps"):
        return {"fused_reduce": 1}
    m, n = pm.index(ax), pm.axis_size(ax)
    out: dict = {}

    def add(cs, entry, times=1):
        for k, v in cs.dist_launches(entry, m).items():
            out[k] = out.get(k, 0) + v * times
    if st["mode"] == "bucketed":
        cs = svc.get_bucket_plan([(ax, n)], float(size), dtype="float32",
                                 config=BucketConfig()).axis_plans[0] \
            .schedule
        for entry in (("reduce_scatter", "all_gather") if st["halves"]
                      else ("allreduce",)):
            add(cs, entry, st["num_buckets"])
        return out
    cs = svc.get_axis_executable(ax, n, float(size)).schedule
    if st["precision"] != "f32":
        cs = cs.with_wire(PRECISIONS[st["precision"]])
    add(cs, "allreduce")
    return out


def mp_planned_worker(pm, everyone) -> dict:
    """Phase mp (a') as one rank: every MP_PLANNED_LABELS call at
    MP_SIZES (a service of its own, the parent's twin), its result digest,
    stats and launches beside the expected; at the gradient size the call
    again, timed (the slowest rank's host ms, started together)."""
    import torch
    from repro_torch.core.transport import all_gather_rows
    from repro_torch.kernels import ops
    from repro_torch.launch.train import params_digest
    from repro_torch.planner.service import PlannerService

    ax = pm.axis_names[0]
    svc = PlannerService()
    out = {}
    for si, (size, slabel) in enumerate(MP_SIZES):
        x = mp_row(size, 100 + si, pm.rank, pm.device)
        for label in MP_PLANNED_LABELS:
            before = dict(ops.LAUNCHES)
            got, st = mp_planned_run(label, x, ax, pm, svc)
            torch.cuda.synchronize()
            rec = {"digest": params_digest([got]), "stats": st,
                   "launches": {k: ops.LAUNCHES[k] - before[k]
                                for k in EXECUTOR_KERNELS},
                   "expected": mp_planned_expected(label, st, size, ax, pm,
                                                   svc)}
            del got
            if size >= 1 << 24:
                all_gather_rows(pm, everyone, x[:1])
                t0 = time.perf_counter()
                mp_planned_run(label, x, ax, pm, svc)
                torch.cuda.synchronize()
                mine = torch.tensor(time.perf_counter() - t0,
                                    dtype=torch.float64, device=pm.device)
                rec["ms"] = 1e3 * float(all_gather_rows(pm, everyone,
                                                        mine).max())
            out[(label, slabel)] = rec
        del x
    return out


def mp_planned_want(dev, n: int) -> dict:
    """Phase mp (a')'s answers on the n-rank local mesh on this card:
    each call's row digests by (label, size label, rank) and its stats,
    on a service of this process's own; each result within the wire's
    budget (f32 1e-6) of the exact column sum."""
    import torch
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.launch.train import params_digest
    from repro_torch.planner.service import PlannerService

    svc = PlannerService()
    want = {}
    for si, (size, slabel) in enumerate(MP_SIZES):
        X = torch.stack([mp_row(size, 100 + si, r, dev) for r in range(n)])
        exact = X.double().sum(dim=0)
        scale = float(exact.abs().max())
        for label in MP_PLANNED_LABELS:
            got, st = mp_planned_run(label, X, "data", None, svc)
            prec = ("int8" if "int8" in label
                    else st.get("precision", "f32"))
            err = float((got.double() - exact).abs().max()) / scale
            budget = (1e-6 if prec == "f32"
                      else PRECISIONS[prec].error_budget)
            if not err <= budget:
                fail(f"mp (a') {label} {slabel}: the local mesh's rel err "
                     f"{err:.3e} over {budget}")
            want[(label, slabel)] = {
                "stats": st, "err": err,
                "digests": [params_digest([got[r]]) for r in range(n)]}
            del got
        del X, exact
    torch.cuda.empty_cache()
    return want


def mp_check_planned(ranks: list, want: dict) -> None:
    """Phase mp (a')'s checks and lines (the ranks' launches are in the
    executor's totals already)."""
    for key, w in want.items():
        for r, res in enumerate(ranks):
            got = res["planned"][key]
            if got["digest"] != w["digests"][r]:
                fail(f"mp (a') {key} rank {r}: the result differs from the "
                     "local mesh's row")
            if got["stats"] != w["stats"]:
                fail(f"mp (a') {key} rank {r}: stats {got['stats']}, the "
                     f"local mesh's {w['stats']}")
            exp = {k: got["expected"].get(k, 0) for k in got["launches"]}
            if got["launches"] != exp or not any(got["launches"].values()):
                fail(f"mp (a') {key} rank {r}: launches {got['launches']}, "
                     f"expected {exp}")
        res0 = ranks[0]["planned"][key]
        log(f"mp (a') {key[0]} {key[1]}: {len(ranks)} ranks equal the "
            f"local mesh's rows bit for bit; stats {json.dumps(w['stats'])};"
            f" rel err {w['err']:.2e}; launches a rank "
            f"{json.dumps({k: v for k, v in res0['launches'].items() if v})}"
            + (f"; {res0['ms']:.3f} ms ({ranks[0]['transport']}: host "
               "staging, not links)" if "ms" in res0 else ""))


def mp_serve_worker(pm, sc: dict) -> dict:
    """Phase mp (e) as one rank of the ("model", n) process mesh: `serve`
    on it (rank 0 serves), its launches beside the expected (each rank
    the decode schedule's `dist_launches` SERVE_SCHEDULE_RUNS times, rank
    0 the model kernels its forwards run), the peak."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    lines = []
    t0 = time.perf_counter()
    res = serve(ServeConfig(**sc, device=str(pm.device)), smoke=False,
                mesh=pm, on_log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched = res["tp_schedule"]
    exp = {k: v * SERVE_SCHEDULE_RUNS for k, v in
           sched.dist_launches("allreduce", pm.index("model")).items()}
    if pm.rank == 0:
        exp.update(expected_launches(res["config"], sc["max_new"]))
    return {"tokens": res["tokens"], "err": res["self_check_err"],
            "timings": res["timings"], "lines": lines,
            "launches": dict(ops.LAUNCHES),
            "attention": dict(ops.ATTENTION_LAUNCHES),
            "attention_expected": attention_launches(res["config"],
                                                     sc["max_new"]),
            "expected": exp, "peak": torch.cuda.max_memory_allocated(),
            "wall": wall, "failures": sched.stats["failures"]
            + sched.demotions, "transport": pm.transport}


def mp_check_serve(ranks: list, want_tokens, totals: dict) -> None:
    """Phase mp (e)'s checks and lines; adds the ranks' launches."""
    arch = MP_SERVE_ARCH
    for r, res in enumerate(ranks):
        if not (res["err"] is not None and res["err"] < 1e-5):
            fail(f"mp serve rank {r}: self-check rel err {res['err']}")
        if res["failures"]:
            fail(f"mp serve rank {r}: the decode schedule failed or was "
                 "demoted")
        exp = {k: res["expected"].get(k, 0) for k in res["launches"]}
        if res["launches"] != exp:
            fail(f"mp serve rank {r}: launches {res['launches']}, expected "
                 f"{exp}")
        for k, v in res["launches"].items():
            totals[k] += v
        if r and res["tokens"] is not None:
            fail(f"mp serve rank {r} served tokens; rank 0 alone serves")
    r0 = ranks[0]
    if r0["attention"] != r0["attention_expected"]:
        fail(f"mp serve: rank 0 ran attention kernels {r0['attention']}, "
             f"expected {r0['attention_expected']}")
    import numpy as np
    if r0["tokens"] is None or not np.array_equal(r0["tokens"],
                                                  want_tokens):
        fail(f"mp serve: rank 0's tokens differ from the local-mesh "
             f"server's")
    for line in r0["lines"]:
        log(f"mp serve [{arch}, {r0['transport']}]: {line}")
    tm = r0["timings"]
    errs = ", ".join(f"{res['err']:.2e}" for res in ranks)
    log(f"mp serve [{arch}, {r0['transport']}]: {len(ranks)} processes, "
        f"self-check rel err by rank {errs}; "
        f"the decode AllReduce {tm['allreduce_s'] * 1e3:.3f} ms (the "
        f"slowest rank's median, observed as host_staged: host staging, "
        f"not links); rank 0's {r0['tokens'].shape[1]} tokens a row equal "
        f"the local-mesh server's; prefill {tm['prefill_s'] * 1e3:.1f} ms, "
        f"decode median {tm['decode_median_s'] * 1e3:.1f} ms; peaks GiB "
        f"{[round(res['peak'] / 2**30, 2) for res in ranks]}; launches "
        f"rank 0 {json.dumps({k: v for k, v in r0['launches'].items() if v})}"
        f"; wall {r0['wall']:.1f} s")


def mp_train_run(mesh, layers_cfg: dict, sync_kw: dict, dev,
                 digest: bool = False) -> dict:
    """MP_TRAIN's run on `mesh` (a rank count or (axis, size) pairs: the
    local mesh; or a `ProcessMesh`), from the same seeded weights and
    batches: `train_run`'s result, the launches, the peak device memory;
    with `digest`, step 1's gathered-copy checksum."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build

    cfg = get_config(layers_cfg["arch"])
    import dataclasses
    cfg = dataclasses.replace(cfg, n_layers=layers_cfg["layers"])
    api = build(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    r = train_run(api, params, mesh, layers_cfg["lr"], layers_cfg["steps"],
                  layers_cfg["seq_len"], layers_cfg["global_batch"],
                  sync=SyncConfig(strategy="plan", **sync_kw),
                  digest=digest)
    torch.cuda.synchronize()
    r["wall_s"] = time.perf_counter() - t0
    r["launches"] = dict(ops.LAUNCHES)
    r["peak"] = torch.cuda.max_memory_allocated()
    return r


def mp_train_launches(step, pm, steps: int, leaves: int) -> dict:
    """The kernel launches one rank of a process mesh makes in `steps`
    steps of the ZeRO-3 `step` at full precision: per leaf, a gather and
    a reduce-scatter a leaf and a live axis; bucketed, one all-gather a
    gather bucket and one reduce-scatter a scatter bucket; each
    `dist_launches` at the rank's index on the plan's axis."""
    out = {k: 0 for k in TOLERANCE}

    def add(pl, entry, times):
        for k, v in pl.schedule.dist_launches(
                entry, pm.index(pl.axis)).items():
            out[k] += v * times * steps
    if step.bucket_plan is not None:
        add(step.plans[0], "all_gather", len(step.gather_buckets))
        add(step.plans[0], "reduce_scatter", len(step.scatter_buckets))
        return out
    for pl in step.plans:
        add(pl, "all_gather", leaves)
        add(pl, "reduce_scatter", leaves)
    return out


def _state_digest(state: dict) -> int:
    """`params_digest` of a ZeRO-3 state's shards and moments."""
    from repro_torch.launch.train import params_digest
    return params_digest(state["params"] + state["opt"]["m"]
                         + state["opt"]["v"])


def mp_run_record(label: str, r: dict, mesh, layers_cfg: dict) -> dict:
    """The CPU record of one `mp_train_run` on a process mesh: losses,
    gnorms, step times and parts, digests, launches beside the expected
    (an EP run's exchanges' fold phases added), peak, plans."""
    step = r["step"]
    expected = mp_train_launches(step, mesh, layers_cfg["steps"],
                                 len(r["state"]["params"]))
    ex = [e for e in r["ep_exchanges"] if e]
    if step.ep is not None:
        per = step.ep_schedule.dist_launches("all_to_all",
                                             mesh.index(step.ep[0]))
        for k, v in per.items():
            expected[k] += v * sum(sum(e.values()) for e in ex)
    return {"label": label, "losses": r["losses"], "expected": expected,
            "gnorms": r["gnorms"], "step_s": r["step_s"],
            "phase_ms": r["phase_ms"], "digest": r["digest"],
            "final": _state_digest(r["state"]), "ex": ex,
            "launches": r["launches"], "peak": r["peak"],
            "wall_s": r["wall_s"],
            "plans": [pl.schedule.describe() if pl.schedule is not None
                      else pl.strategy for pl in r["plans"]],
            "buckets": len(step.scatter_buckets)}


def mp_ft_run(pm, ckpt_dir: str) -> dict:
    """Phase mp (g) as one rank: MP_FT["model"]'s per-leaf run through
    `run_training` with a checkpoint every MP_FT["ckpt_every"] step in
    `ckpt_dir` under MP_FT's faults: the step calls, losses, the final
    state's digest, what fired, the restores, the checkpoint's bytes and
    times (the last save's, the restore's), the launches beside the
    expected (each step call's gathers and reduce-scatters; the lost
    attempt runs none), the peak."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainConfig, run_training
    from repro_torch.runtime.faults import (FaultEvent, FaultInjector,
                                            FaultPlan)

    tr = MP_FT["model"]
    tc = TrainConfig(arch=tr["arch"], steps=tr["steps"],
                     seq_len=tr["seq_len"], global_batch=tr["global_batch"],
                     lr=tr["lr"], engine="manual", sync="plan",
                     bucket_bytes=0, n_layers=tr["layers"],
                     ckpt_dir=ckpt_dir, ckpt_every=MP_FT["ckpt_every"],
                     log_every=1, device=str(pm.device))
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with FaultInjector(FaultPlan(seed=7, events=tuple(
            FaultEvent(*e) for e in MP_FT["events"]))) as inj:
        out = run_training(tc, smoke=False, mesh=pm, on_log=lines.append)
    torch.cuda.synchronize()
    mgr = out["ckpt"]
    return {"steps": out["steps"], "losses": out["losses"],
            "final": _state_digest(out["state"]),
            "fired": inj.stats()["fired"], "restarts": out["loop"].restarts,
            "resumes": [ln for ln in lines if ln.startswith("ft: resume")],
            "lines": lines, "save": dict(mgr.last_save),
            "restore": dict(mgr.last_restore),
            "launches": dict(ops.LAUNCHES),
            "expected": mp_train_launches(out["step"], pm,
                                          len(out["steps"]),
                                          len(out["state"]["params"])),
            "peak": torch.cuda.max_memory_allocated(),
            "wall_s": time.perf_counter() - t0}


def mp_train_worker(pm, runs, ckpt_dir: str | None = None) -> dict:
    """Phase mp (b) as one rank of the 4-process mesh: the MP_TRAIN runs
    `runs` (label, axes, sync), one on other axes than the mesh's on a
    second process mesh over the same processes; with `ckpt_dir`, (f)
    the MoE run, then (g)'s fault-free run and its fault loop, each run's
    state freed before the next. CPU objects only."""
    import torch
    from repro_torch.launch.mesh import init_process_mesh

    out = {"runs": []}
    for label, axes, sync_kw in runs:
        mesh = pm if tuple(axes) == pm.axes else init_process_mesh(
            axes, pm.backend, pm.device)
        r = mp_train_run(mesh, MP_TRAIN, sync_kw, pm.device, digest=True)
        out["runs"].append(mp_run_record(label, r, mesh, MP_TRAIN))
        del r
        torch.cuda.empty_cache()
    if ckpt_dir is not None:
        r = mp_train_run(pm, MP_MOE, {"bucket_bytes": 0}, pm.device)
        out["moe"] = mp_run_record("MoE, EP plan", r, pm, MP_MOE)
        del r
        torch.cuda.empty_cache()
        r = mp_train_run(pm, MP_FT["model"], {"bucket_bytes": 0}, pm.device)
        out["ft_base"] = mp_run_record("fault-free", r, pm, MP_FT["model"])
        del r
        torch.cuda.empty_cache()
        out["ft"] = mp_ft_run(pm, ckpt_dir)
        torch.cuda.empty_cache()
    return out


def mp_check_train(label: str, runs: list, want: dict, transport: str,
                   totals: dict) -> None:
    """Phase mp (b)'s checks of one trainer run against the same run on
    the local mesh, and its lines; adds the ranks' launches to
    `totals`."""
    gap = max(max(abs(a - b) / max(abs(b), 1.0)
                  for a, b in zip(r["losses"] + r["gnorms"],
                                  want["losses"] + want["gnorms"]))
              for r in runs)
    peaks = [r["peak"] for r in runs]
    log(f"mp train [{label}, {transport}]: {runs[0]['plans']}, "
        f"{runs[0]['buckets']} scatter bucket(s); losses "
        f"{runs[0]['losses']} gnorms {runs[0]['gnorms']}; local mesh "
        f"losses {want['losses']} gnorms {want['gnorms']}; step s "
        f"{[round(s, 3) for s in runs[0]['step_s']]} ({transport}; local "
        f"mesh {[round(s, 3) for s in want['step_s']]}); step parts ms "
        f"{runs[0]['phase_ms'][-1]}; peaks GiB "
        f"{[round(p / 2**30, 2) for p in peaks]} sum "
        f"{sum(peaks) / 2**30:.2f} (local mesh {want['peak'] / 2**30:.2f})")
    same = all(r["losses"] == want["losses"]
               and r["gnorms"] == want["gnorms"] for r in runs)
    log(f"mp train [{label}, {transport}]: losses and gnorms "
        + ("equal the local mesh's to every digit" if same else
           f"differ from the local mesh's by up to {gap:.3e} (relative)"))
    if not gap <= MP_TRAIN_GAP:
        fail(f"mp train [{label}]: the process mesh's losses and gnorms "
             f"differ from the local mesh's by {gap:.3e}, over "
             f"{MP_TRAIN_GAP}")
    if len({r["digest"] for r in runs}) != 1:
        fail(f"mp train [{label}]: the ranks' step-1 gathered copies "
             f"differ: {[r['digest'] for r in runs]}")
    if not runs[0]["losses"][-1] < runs[0]["losses"][0]:
        fail(f"mp train [{label}]: the loss did not fall")
    if sum(peaks) > TRAIN_PEAK_GIB * 2**30:
        fail(f"mp train [{label}]: the processes' peaks sum to "
             f"{sum(peaks) / 2**30:.2f} GiB, over {TRAIN_PEAK_GIB}")
    for rank, r in enumerate(runs):
        if r["launches"] != r["expected"] \
                or r["launches"]["fused_reduce"] <= 0:
            fail(f"mp train [{label}] rank {rank}: launches "
                 f"{r['launches']}, expected {r['expected']}")
        for k, v in r["launches"].items():
            totals[k] += v
    log(f"mp train [{label}, {transport}]: fused_reduce launches a rank "
        f"{[r['launches']['fused_reduce'] for r in runs]}, as "
        "dist_launches counts them (the local mesh's run: "
        f"{want['launches']['fused_reduce']}, one a fold phase for all "
        "ranks at once)")


def mp_exec_digests(dev, n: int) -> dict:
    """Phase mp (a)'s answers: every `mp_schedules(n)` call's `run_local`
    rows on this card, as `params_digest`s by (label, wire, entry,
    rank); `run_local`'s AllReduce within each wire's budget of the
    exact sum."""
    import torch
    from repro_torch.core.cost_model import PRECISIONS
    from repro_torch.launch.train import params_digest

    want = {}
    for ci, (label, family, size, cs) in enumerate(mp_schedules(n)):
        X = torch.stack([mp_row(size, ci, r, dev) for r in range(cs.n)])
        exact = X.double().sum(dim=0)
        scale = float(exact.abs().max())
        for wire in (None, "bf16", "fp8", "int8"):
            w = cs.with_wire(None if wire is None else PRECISIONS[wire])
            prev = None
            for name, chained in mp_calls(family):
                got = getattr(w, MP_LOCAL[name])(prev if chained else X)
                if name == "allreduce":
                    err = float((got.double() - exact).abs().max()) / scale
                    budget = (1e-6 if wire is None
                              else PRECISIONS[wire].error_budget)
                    if not err <= budget:
                        fail(f"mp {label} wire={wire}: run_local rel err "
                             f"{err:.3e} over {budget}")
                for r in range(cs.n):
                    want[(label, wire or "f32", name, r)] = params_digest(
                        [got[r]])
                prev = got
            del prev, got
        del X, exact
    torch.cuda.empty_cache()
    return want


def mp_check_exec(ranks: list, want: dict, t0: float,
                  totals: dict) -> None:
    """Phase mp (a) and (c)'s checks and lines for one executor launch;
    adds the ranks' launches to `totals`."""
    transport = ranks[0]["transport"]
    log(f"mp executor: {len(ranks)} processes, {transport}, wall "
        f"{time.perf_counter() - t0:.1f} s")
    for r, res in enumerate(ranks):
        if res["demotions"]:
            fail(f"mp executor rank {r}: {res['demotions']} guard "
                 "demotions or failures")
        for key, d in res["digests"].items():
            if d != want[key + (r,)]:
                fail(f"mp executor {key} rank {r}: the result differs "
                     f"from run_local's row")
        for key, got in res["launches"].items():
            exp = {k: res["expected"][key].get(k, 0) for k in got}
            if got != exp:
                fail(f"mp executor {key} rank {r}: launches {got}, "
                     f"expected {exp}")
        for k, v in res["totals"].items():
            totals[k] += v
    per_rank = [{k: v for k, v in res["totals"].items() if v}
                for res in ranks]
    log(f"mp executor ({transport}): {len(ranks[0]['digests'])} calls a "
        f"rank equal run_local's rows bit for bit; launches a rank "
        f"{json.dumps(per_rank)}")
    what = ("host staging, not links" if transport != "nccl"
            else "one card a rank")
    for (label, wire), ms in ranks[0]["ms"].items():
        log(f"mp executor {label} wire={wire}: allreduce {ms:.3f} ms "
            f"({transport}: {what})")
    for line in ranks[0]["probe_lines"]:
        log(f"mp probe: {line}")
    if len(ranks[0]["probe"]) != 2:
        fail(f"mp probe: {len(ranks[0]['probe'])} observations of the one "
             "live axis, expected 2 (two sizes)")
    ns, sizes, times = ranks[0]["cps"]
    log(f"mp CPS curve ({transport}): " + "; ".join(
        f"n={int(n)} S={int(s)} {t * 1e3:.3f} ms"
        for n, s, t in zip(ns, sizes, times)))


def mp_check_moe(ranks: list, want: dict) -> None:
    """Phase mp (f)'s checks beyond `mp_check_train`'s: each rank counts
    the local mesh's exchanges, 6 a MoE layer a step."""
    layers = MP_MOE["layers"]
    per_step = {"forward": 2 * layers, "recompute": 2 * layers,
                "backward": 2 * layers}
    if want["ex"] != [per_step] * MP_MOE["steps"]:
        fail(f"mp train [MoE]: the local mesh ran exchanges {want['ex']}, "
             f"expected {per_step} a step")
    for r, res in enumerate(ranks):
        if res["ex"] != want["ex"]:
            fail(f"mp train [MoE] rank {r}: exchanges {res['ex']}, the "
                 f"local mesh's {want['ex']}")
    log(f"mp train [MoE, EP plan]: each rank's exchanges a step "
        f"{json.dumps(per_step)}, the local mesh's (6 a MoE layer)")


def mp_check_ft(ranks: list, base: list, transport: str,
                totals: dict) -> None:
    """Phase mp (g)'s checks against its fault-free run on the same
    processes `base` (a record a rank), and its lines; adds both runs'
    launches."""
    want_resume = [f"ft: resume {{'step': {MP_FT['restored']}}}"]
    for r, (res, b) in enumerate(zip(ranks, base)):
        if res["steps"] != MP_FT["calls"]:
            fail(f"mp ft rank {r}: step calls {res['steps']}, expected "
                 f"{MP_FT['calls']}")
        if res["resumes"] != want_resume or res["restarts"] != 1:
            fail(f"mp ft rank {r}: restores {res['resumes']}, restarts "
                 f"{res['restarts']}; expected {want_resume}, 1")
        if res["fired"] != {"file_corrupt": 1, "device_loss": 1}:
            fail(f"mp ft rank {r}: fired {res['fired']}")
        if any(loss != b["losses"][s]
               for s, loss in zip(res["steps"], res["losses"])):
            fail(f"mp ft rank {r}: losses by step {res['losses']} differ "
                 f"from the fault-free run's {b['losses']}")
        if res["final"] != b["final"]:
            fail(f"mp ft rank {r}: the final shards and moments differ from "
                 "the fault-free run's")
        for run in (res, b):
            exp = {k: run["expected"].get(k, 0) for k in run["launches"]}
            if run["launches"] != exp or not run["launches"]["fused_reduce"]:
                fail(f"mp ft rank {r}: launches {run['launches']}, expected "
                     f"{exp}")
            for k, v in run["launches"].items():
                totals[k] += v
    for line in ranks[0]["lines"]:
        if line.startswith(("ft:", "checkpoint:", "chaos:")):
            log(f"mp ft [rank 0, {transport}]: {line}")
    saves = [res["save"] for res in ranks]
    rest = [res["restore"] for res in ranks]
    m = MP_FT["model"]
    log(f"mp ft [{transport}]: {m['arch']} at depth {m['layers']}, per "
        f"leaf; step calls {ranks[0]['steps']}, losses "
        f"{ranks[0]['losses']} (fault-free {base[0]['losses']}, wall "
        f"{base[0]['wall_s']:.1f} s); every rank restored step "
        f"{MP_FT['restored']} (rank 0's member of step "
        f"{MP_FT['events'][0][1]} corrupted) and "
        "ends on the fault-free state (shards and moments) bit for bit; "
        "checkpoint a rank: "
        + "; ".join(f"rank {r} {sv['bytes'] / 1e9:.3f} GB, snapshot "
                    f"{sv['snapshot_s']:.3f} s, write + CRC "
                    f"{_gbps(sv.get('file_bytes', sv['bytes']), sv.get('write_s', 0.0))}"
                    f", commit {sv.get('commit_s', 0.0):.3f} s, restore "
                    f"checksums {rs.get('verify_s', 0.0):.3f} s, read "
                    f"{_gbps(rs.get('bytes', 0), rs.get('read_s', 0.0))}, to "
                    f"the card {rs.get('copy_s', 0.0):.3f} s"
                    for r, (sv, rs) in enumerate(zip(saves, rest)))
        + f"; peaks GiB {[round(res['peak'] / 2**30, 2) for res in ranks]}; "
        f"wall {ranks[0]['wall_s']:.1f} s")


def phase_mp(dev, auto_ref: dict | None = None) -> dict:
    """Phase mp: the process mesh, one process a rank. (b) MP_TRAIN_RUNS,
    (f) MP_MOE and (g) MP_FT on 4 processes, (a) + (a') + (c) on 8, (e)
    the server on MP_SERVE_PROCS, every process on this card with the
    gloo backend (each round's bytes staged through pinned host memory:
    times of host staging, not links); then (d), on a machine of two
    cards or more, (a) + (c) over NCCL on as many ranks as cards (up to
    MP_RANKS), one card a rank, and with 4 cards or more the per-leaf
    run of (b) over NCCL too; with one card a line saying why not. Frees
    the parent's cached card memory first; the ranks load the kernels
    phase 1 built. Checks: every trainer run against the same run on
    the 4-rank local mesh in this process (losses and gnorms equal to
    every digit, or within MP_TRAIN_GAP, printed; the ranks' step-1
    gathered copies equal; the loss falling; each rank's launches
    `dist_launches`'; the peaks, summed under TRAIN_PEAK_GIB; the MoE
    run's exchanges the local mesh's); the fault loop's final state and
    losses equal to (b)'s per-leaf run's; every executor call's result
    on every rank equal to `run_local`'s (or the local mesh's) row on
    this card (digests), each rank's launches `dist_launches`'; the
    server's self-check on every rank and rank 0's tokens the local-mesh
    server's; (h) the auto engine on the 4 processes (`phase_mp_auto`,
    against phase auto (a)'s card run `auto_ref`). Returns the launches
    of every process, summed."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import launch

    t_phase = time.perf_counter()
    totals = {k: 0 for k in TOLERANCE}
    cards = torch.cuda.device_count()
    procs = MP_TRAIN["procs"]
    nccl_runs = list(MP_TRAIN_RUNS[:1]) if cards >= procs else []
    local, manual = {}, None
    for label, cfg_, axes, sync_kw in (
            [(label, MP_TRAIN, axes, kw)
             for label, axes, kw in MP_TRAIN_RUNS]
            + [("MoE, EP plan", MP_MOE, (("data", procs),),
                {"bucket_bytes": 0})]):
        mesh = procs if len(axes) == 1 else [tuple(a) for a in axes]
        r = mp_train_run(mesh, cfg_, sync_kw, dev)
        local[label] = {"losses": r["losses"], "gnorms": r["gnorms"],
                        "step_s": r["step_s"], "peak": r["peak"],
                        "launches": r["launches"],
                        "ex": [e for e in r["ep_exchanges"] if e]}
        for k, v in r["launches"].items():
            totals[k] += v
        del r
        torch.cuda.empty_cache()
    log(f"mp: local-mesh runs done at {time.perf_counter() - t_phase:.1f} s")
    ckpt = ROOT / "build" / "mp_ft"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    need = 3 * _state_bytes(dataclasses.replace(get_config(
        MP_FT["model"]["arch"]), n_layers=MP_FT["model"]["layers"]), procs)
    free = shutil.disk_usage(ckpt).free
    log(f"mp ft: a checkpoint {need / 3e9:.3f} GB over {procs} ranks, up to "
        f"3 on disk need {need / 1e9:.1f} GB, {free / 1e9:.1f} GB free")
    if free < need:
        fail(f"phase mp: {free / 1e9:.1f} GB free in {ckpt}, the fault "
             f"loop's checkpoints need {need / 1e9:.1f}")
    try:
        for backend, runs in (("gloo", MP_TRAIN_RUNS), ("nccl", nccl_runs)):
            if not runs:
                continue
            torch.cuda.empty_cache()
            log(f"mp: parent before spawning: "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
            t0 = time.perf_counter()
            ranks = launch(mp_train_worker, [("data", procs)],
                           backend=backend,
                           device=dev if backend == "gloo" else "cuda",
                           timeout_s=MP_TIMEOUT_S, args=(
                               runs, str(ckpt) if backend == "gloo"
                               else None))
            transport = ("gloo through the host" if backend == "gloo"
                         else "nccl")
            log(f"mp train: {procs} processes, {transport}, wall "
                f"{time.perf_counter() - t0:.1f} s")
            for i, (label, _, _) in enumerate(runs):
                mp_check_train(label, [r["runs"][i] for r in ranks],
                               local[label], transport, totals)
            if backend == "gloo":
                manual = ranks[0]["runs"][0]
                moe = [r["moe"] for r in ranks]
                mp_check_train("MoE, EP plan", moe, local["MoE, EP plan"],
                               transport, totals)
                mp_check_moe(moe, local["MoE, EP plan"])
                mp_check_ft([r["ft"] for r in ranks],
                            [r["ft_base"] for r in ranks], transport,
                            totals)
            del ranks
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if not nccl_runs:
        log(f"mp (d): the trainer over NCCL not run: this machine has "
            f"{cards} card(s), NCCL needs one a rank ({procs})")
    log(f"mp: trainers done at {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    phase_mp_auto(dev, auto_ref, manual)
    del manual
    log(f"mp: auto engine done at {time.perf_counter() - t_phase:.1f} s")

    execs = [("gloo", MP_RANKS)]
    if cards >= 2:
        execs.append(("nccl", min(cards, MP_RANKS)))
    else:
        log(f"mp (d): the executor over NCCL not run: this machine has "
            f"{cards} card(s), NCCL needs one a rank (2 or more)")
    for backend, n in execs:
        want = mp_exec_digests(dev, n)
        planned = mp_planned_want(dev, n)
        t0 = time.perf_counter()
        ranks = launch(mp_exec_worker, [("data", n)], backend=backend,
                       device=dev if backend == "gloo" else "cuda",
                       timeout_s=MP_TIMEOUT_S)
        mp_check_exec(ranks, want, t0, totals)
        mp_check_planned(ranks, planned)
        del ranks, want, planned
    log(f"mp: executors done at {time.perf_counter() - t_phase:.1f} s")

    sc = {**SERVE, "arch": MP_SERVE_ARCH}
    tokens = SERVED_TOKENS.get(MP_SERVE_ARCH)
    if tokens is None:
        from repro_torch.launch.serve import ServeConfig, serve
        tokens = serve(ServeConfig(**sc, device=str(dev)), smoke=False,
                       on_log=lambda _m: None)["tokens"]
        torch.cuda.empty_cache()
    ranks = launch(mp_serve_worker, [("model", MP_SERVE_PROCS)],
                   backend="gloo", device=dev, timeout_s=MP_TIMEOUT_S,
                   args=(sc,))
    mp_check_serve(ranks, tokens, totals)
    del ranks
    log(f"mp: launches of every process {json.dumps(totals)}")
    log(f"phase mp wall {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase auto: the auto engine (and phase mp (h), its process mesh)
# ---------------------------------------------------------------------------
def auto_smoke_run(mesh, dev, fsdp: bool = True, run: dict = AUTO_SMOKE
                   ) -> dict:
    """`run`'s (AUTO_SMOKE's) run of the auto engine on `mesh` (None: one
    device, `dev`; or a process mesh, on its device) from the seeded f32
    init drawn on the CPU: losses, gnorms, the kernel launches of its
    steps, the final parameters' local tensors and their placements (on
    the CPU)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (batch_tensors, data_config,
                                          make_train_step, place_state)
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _local

    a = run
    cfg = dataclasses.replace(smoke_config(get_config(a["arch"])),
                              **a["overrides"])
    api = build(cfg)
    params = _to(api.init_params(torch.Generator().manual_seed(0),
                                 torch.float32, "cpu"), dev)
    step, _, _ = make_train_step(api, mesh, AdamWConfig(lr=a["lr"]),
                                 fsdp=fsdp, device=dev)
    state = place_state(params, mesh, step.placements)
    del params
    data = SyntheticLM(data_config(cfg, a["seq_len"], a["global_batch"]))
    out = {"losses": [], "gnorms": []}
    ops.reset_launches()
    for s in range(a["steps"]):
        _, m = step(state, batch_tensors(data.batch_at(s), dev))
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
    out["launches"] = dict(ops.LAUNCHES)
    out["params"] = [_local(p).detach().cpu() for p in state["params"]]
    out["placements"] = [tuple(repr(q) for q in pl)
                         for pl in step.placements["params"]]
    return out


def auto_full_run(mesh, dev, layers: int = AUTO_FULL["layers"],
                  steps: int = AUTO_FULL["steps"]) -> dict:
    """AUTO_FULL's run at depth `layers` for `steps` steps of the auto
    engine on `mesh` (None: one device, `dev`; or a process mesh) from
    seeded bf16 weights drawn on the device, the peak reset before the
    draw: losses, gnorms, host-clock step times (each ending in the
    loss's copy to the host), the parts of each step (CUDA events,
    `PHASES`), the peak, the launches, the parameters (their count), the
    leaves a process holds sharded, and on a "model" axis above 1 the
    bytes this process sent over its model line each step
    (`core.transport.Line.sent`)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (batch_tensors, data_config,
                                          make_train_step, phase_ms,
                                          place_state)
    from repro_torch.models.registry import build
    from repro_torch.optim import AdamWConfig

    a = AUTO_FULL
    cfg = dataclasses.replace(get_config(a["arch"]), n_layers=layers)
    api = build(cfg)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step, _, _ = make_train_step(api, mesh, AdamWConfig(lr=a["lr"]),
                                 device=dev)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    state = place_state(params, mesh, step.placements)
    del params
    data = SyntheticLM(data_config(cfg, a["seq_len"], a["global_batch"]))
    out = {"losses": [], "gnorms": [], "step_s": [], "phase_ms": [],
           "model_bytes": []}
    line = (mesh.line("model") if mesh is not None
            and dict(mesh.axes).get("model", 1) > 1 else None)
    ops.reset_launches()
    for s in range(steps):
        t0 = time.perf_counter()
        sent = 0 if line is None else line.sent
        _, m = step(state, batch_tensors(data.batch_at(s), dev))
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["gnorms"].append(float(m["gnorm"]))
        out["phase_ms"].append(phase_ms(m))
        out["model_bytes"].append(0 if line is None else line.sent - sent)
    torch.cuda.synchronize(dev)
    out["launches"] = dict(ops.LAUNCHES)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["params"] = sum(math.prod(t.shape) for t in state["params"])
    out["sharded"] = sum(any(q.startswith("Shard") for q in
                             (repr(x) for x in pl))
                         for pl in step.placements["params"])
    del state
    torch.cuda.empty_cache()
    return out


def auto_parts(r: dict) -> dict:
    """The medians over steps 2.. of a run's step time (ms) and parts."""
    from repro_torch.launch.train import PHASES
    return {"step": statistics.median(r["step_s"][1:]) * 1e3,
            **{k: statistics.median(p[k] for p in r["phase_ms"][1:])
               for k in PHASES}}


def phase_auto(dev, baseline: dict) -> dict:
    """Phase auto: the auto engine on one card. (a) AUTO_SMOKE in f32 on
    the card and on the CPU: losses and gnorms within AUTO_CPU_TOL, no
    kernel wrapper launched (`ops.LAUNCHES` unchanged across the steps).
    (b) AUTO_FULL: its losses (finite, falling), the step on the host
    clock, its forward + backward and AdamW by CUDA events beside
    `train_bounds`' terms (`rank_bounds` over the whole batch; AdamW's 22
    bytes a parameter), its peak, and on the same line phase 5's per-leaf
    manual step from this run (`baseline`). Returns (a)'s card run, which
    phase mp (h) holds its ranks against."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    card = auto_smoke_run(None, dev)
    cpu = auto_smoke_run(None, torch.device("cpu"))
    gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        card["losses"] + card["gnorms"], cpu["losses"] + cpu["gnorms"]))
    log(f"auto (a): smoke {AUTO_SMOKE['arch']} {AUTO_SMOKE['overrides']} "
        f"f32, one card: losses {card['losses']} gnorms {card['gnorms']}; "
        f"CPU losses {cpu['losses']} gnorms {cpu['gnorms']}; largest "
        f"relative gap {gap:.3e} (bar {AUTO_CPU_TOL}); launches "
        f"{json.dumps(card['launches'])}")
    if not gap <= AUTO_CPU_TOL:
        fail(f"auto (a): the card's losses and gnorms differ from the "
             f"CPU's by {gap:.3e}, over {AUTO_CPU_TOL}")
    if any(card["launches"].values()):
        fail(f"auto (a): the auto steps launched kernels {card['launches']}")
    if not card["losses"][-1] < card["losses"][0]:
        fail(f"auto (a): the loss did not fall: {card['losses']}")
    r = auto_full_run(None, dev)
    a = AUTO_FULL
    cfg = dataclasses.replace(get_config(a["arch"]), n_layers=a["layers"])
    rank = rank_bounds(cfg, r["params"], 2, 1, a["seq_len"],
                       a["global_batch"])
    fb_bound = max(rank["rank_bytes_ms"], rank["rank_flops_ms"])
    adamw_bound = bound_ms(22 * r["params"])
    parts = auto_parts(r)
    log(f"auto (b): {cfg.name} layers={cfg.n_layers} (cut from "
        f"{get_config(a['arch']).n_layers}) bf16, {r['params'] / 1e6:.1f} M "
        f"parameters, one card, seq {a['seq_len']}, global batch "
        f"{a['global_batch']}, lr {a['lr']}: losses {r['losses']} gnorms "
        f"{r['gnorms']}; step (host clock, median of steps 2-{a['steps']}) "
        f"{parts['step']:.1f} ms (steps "
        f"{[round(x * 1e3, 1) for x in r['step_s']]}); forward + backward "
        f"{parts['forward_backward']:.2f} ms (bound {fb_bound:.2f}: bytes "
        f"{rank['rank_bytes_ms']:.3f}, products {rank['rank_flops_ms']:.3f})"
        f", AdamW {parts['adamw']:.2f} ms (bound {adamw_bound:.2f}), gather "
        f"{parts['gather']:.3f} ms and reduce-scatter "
        f"{parts['reduce_scatter']:.3f} ms (one device: none); peak "
        f"{r['peak'] / 2**30:.2f} GiB; launches {json.dumps(r['launches'])}"
        f" | phase 5's per-leaf manual step, 8 local ranks, same run: "
        f"{baseline['step_ms']:.1f} ms, parts "
        + ", ".join(f"{k} {v:.2f}" for k, v in baseline["parts"].items())
        + f" ms, peak {baseline['peak'] / 2**30:.2f} GiB")
    if not all(math.isfinite(x) for x in r["losses"] + r["gnorms"]):
        fail(f"auto (b): non-finite loss or gnorm {r['losses']} "
             f"{r['gnorms']}")
    if not r["losses"][-1] < r["losses"][0]:
        fail(f"auto (b): the loss did not fall: {r['losses']}")
    if any(r["launches"].values()):
        fail(f"auto (b): the auto steps launched kernels {r['launches']}")
    log(f"phase auto wall {time.perf_counter() - t0:.1f} s")
    return card


def mp_auto_worker(pm) -> dict:
    """Phase mp (h) as one rank: AUTO_SMOKE with FSDP and with ZeRO-1,
    then AUTO_FULL at MP_TRAIN's depth with FSDP. CPU objects only."""
    import torch
    out = {label: auto_smoke_run(pm, pm.device, fsdp=fsdp)
           for label, fsdp in (("FSDP", True), ("ZeRO-1", False))}
    torch.cuda.empty_cache()
    out["full"] = auto_full_run(pm, pm.device, MP_TRAIN["layers"])
    return out


def _auto_slice(w, placements, coords, sizes):
    """A rank's slice of the whole leaf `w` at its placements (reprs)."""
    for c, n, pl in zip(coords, sizes, placements):
        if pl.startswith("Shard"):
            dim = int(pl[pl.index("dim=") + 4:].rstrip(")"))
            size = w.shape[dim] // n
            w = w.narrow(dim, c * size, size)
    return w


def phase_mp_auto(dev, ref: dict | None, manual: dict | None) -> None:
    """Phase mp (h): the auto engine on MP_TRAIN["procs"] processes over
    gloo through the host (`mp_auto_worker`), then over NCCL with one
    card a rank where the machine has two cards or more (as many ranks
    as cards, up to MP_TRAIN["procs"]; else a line saying why not).
    Checks: each rank's AUTO_SMOKE losses and gnorms within AUTO_MP_TOL
    of (a)'s card run `ref` (run here when None), its final local
    tensors its slice of (a)'s within AUTO_MP_PARAM_TOL, with FSDP and
    ZeRO-1; no kernel launched; AUTO_FULL's losses finite and falling,
    equal on every rank. Prints each process's AUTO_FULL step,
    its parts and its peak, beside (b)'s per-leaf manual step on the
    same processes (`manual`: rank 0's step times, parts and peak)."""
    import torch
    from repro_torch.launch.mesh import coords_of, launch

    t0 = time.perf_counter()
    procs = MP_TRAIN["procs"]
    if ref is None:
        ref = auto_smoke_run(None, dev)
    cards = torch.cuda.device_count()
    backends = [("gloo", dev, procs)] + (
        [("nccl", "cuda", min(cards, procs))] if cards >= 2 else [])
    for backend, where, procs in backends:
        t1 = time.perf_counter()
        ranks = launch(mp_auto_worker, [("data", procs)], backend=backend,
                       device=where, timeout_s=MP_TIMEOUT_S)
        transport = ("gloo through the host" if backend == "gloo"
                     else "nccl")
        log(f"mp auto (h): {procs} processes, {transport}, wall "
            f"{time.perf_counter() - t1:.1f} s")
        for label in ("FSDP", "ZeRO-1"):
            runs = [r[label] for r in ranks]
            gap = max(abs(a - b) / max(abs(b), 1e-30)
                      for r in runs for a, b in zip(
                          r["losses"] + r["gnorms"],
                          ref["losses"] + ref["gnorms"]))
            pgap = 0.0
            for rank, r in enumerate(runs):
                coords = coords_of(rank, [procs])
                for p, w, pl in zip(r["params"], ref["params"],
                                    r["placements"]):
                    w = _auto_slice(w, pl, coords, [procs])
                    if p.shape != w.shape:
                        fail(f"mp auto (h) [{label}] rank {rank}: a local "
                             f"tensor {tuple(p.shape)}, its slice "
                             f"{tuple(w.shape)}")
                    pgap = max(pgap, float((p - w).abs().max()
                                           / w.abs().max()))
            sharded = sum(any(q.startswith("Shard") for q in pl)
                          for pl in runs[0]["placements"])
            log(f"mp auto (h) [smoke {label}, {transport}]: rank 0 losses "
                f"{runs[0]['losses']} gnorms {runs[0]['gnorms']}; one card "
                f"(a) losses {ref['losses']} gnorms {ref['gnorms']}; largest "
                f"relative gap over the ranks {gap:.3e} (bar {AUTO_MP_TOL}); "
                f"{sharded} of {len(runs[0]['placements'])} parameter leaves "
                f"sharded; the ranks' local tensors against their slices "
                f"of (a)'s {pgap:.3e} of the largest |value| (bar "
                f"{AUTO_MP_PARAM_TOL})")
            if not gap <= AUTO_MP_TOL:
                fail(f"mp auto (h) [{label}]: the ranks' losses and gnorms "
                     f"differ from (a)'s by {gap:.3e}, over {AUTO_MP_TOL}")
            if not pgap <= AUTO_MP_PARAM_TOL:
                fail(f"mp auto (h) [{label}]: the ranks' parameters differ "
                     f"from their slices of (a)'s by {pgap:.3e}")
            if any(v for r in runs for v in r["launches"].values()):
                fail(f"mp auto (h) [{label}]: kernels launched "
                     f"{[r['launches'] for r in runs]}")
        full = [r["full"] for r in ranks]
        if backend == "gloo":
            MP_AUTO_PEAKS[:] = [f["peak"] for f in full]
        if any(f["losses"] != full[0]["losses"] for f in full) \
                or not all(math.isfinite(x) for x in full[0]["losses"]) \
                or not full[0]["losses"][-1] < full[0]["losses"][0]:
            fail(f"mp auto (h) [full]: losses {[f['losses'] for f in full]}")
        if any(v for f in full for v in f["launches"].values()):
            fail(f"mp auto (h) [full]: kernels launched "
                 f"{[f['launches'] for f in full]}")
        man = ""
        if manual is not None and backend == "gloo":
            mp_ = {k: v for k, v in manual["phase_ms"][-1].items()}
            man = (f" | (b)'s per-leaf manual step on the same processes "
                   f"({transport}: host staging, not links): step "
                   f"{statistics.median(manual['step_s'][1:]) * 1e3:.1f} "
                   f"ms, parts of its last step "
                   + ", ".join(f"{k} {v:.1f}" for k, v in mp_.items())
                   + f" ms, peak {manual['peak'] / 2**30:.2f} GiB")
        for rank, f in enumerate(full):
            parts = auto_parts(f)
            log(f"mp auto (h) [full {AUTO_FULL['arch']} depth "
                f"{MP_TRAIN['layers']}, FSDP, {transport}"
                + (": host staging, not links" if backend == "gloo" else "")
                + f"] rank {rank}: {f['sharded']} leaves sharded; losses "
                f"{f['losses']}; step {parts['step']:.1f} ms (steps "
                f"{[round(x * 1e3, 1) for x in f['step_s']]}); gather "
                f"{parts['gather']:.1f} ms, forward + backward "
                f"{parts['forward_backward']:.1f} ms, reduce-scatter "
                f"{parts['reduce_scatter']:.1f} ms, AdamW "
                f"{parts['adamw']:.1f} ms; peak {f['peak'] / 2**30:.2f} GiB"
                + (man if rank == 0 else ""))
        del ranks
    if cards < 2:
        log(f"mp auto (h): the auto engine over NCCL not run: this machine "
            f"has {cards} card(s), NCCL needs one a rank (2 or more)")
    log(f"mp auto (h) wall {time.perf_counter() - t0:.1f} s")


def tp_worker(pm) -> dict:
    """Phase tp as one rank of the first of TP_MESHES: TP_SMOKE on each of
    TP_MESHES (the others on process meshes of their own over the same
    processes), then AUTO_FULL at MP_TRAIN's depth for TP_FULL_STEPS
    steps. CPU objects only."""
    import torch
    from repro_torch.launch.mesh import init_process_mesh
    out = {}
    for axes in TP_MESHES:
        mesh = pm if tuple(axes) == pm.axes else init_process_mesh(
            axes, pm.backend, pm.device)
        out[axes] = auto_smoke_run(mesh, pm.device, run=TP_SMOKE)
    torch.cuda.empty_cache()
    out["full"] = auto_full_run(pm, pm.device, MP_TRAIN["layers"],
                                TP_FULL_STEPS)
    return out


def phase_tp(dev) -> None:
    """Phase tp: tensor parallelism on the auto engine's "model" axis
    (`make_train_step` on a (data, model) process mesh: each rank
    multiplies its slice of each "model"-sharded weight, its partial
    products summed over its model line through `core.transport`), 4
    processes on this card over gloo through the host (`tp_worker`),
    then over NCCL with one card a rank where the machine has four cards
    or more (else a line saying why not). Checks: (a) each rank's
    TP_SMOKE losses and gnorms within TP_TOL of the same model's run on
    one card, on each of TP_MESHES, and "model" sharding some leaves; (b)
    the full-width step's losses finite and equal on every rank, its
    peak under each process's of mp (h)'s FSDP run (MP_AUTO_PEAKS) where
    that ran; no kernel launched. Prints each process's (b) step, its
    parts, its peak beside mp (h)'s and the bytes it sent over its model
    line a step."""
    import torch
    from repro_torch.launch.mesh import launch

    t0 = time.perf_counter()
    ref = auto_smoke_run(None, dev, run=TP_SMOKE)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    procs = math.prod(s for _, s in TP_MESHES[0])
    backends = [("gloo", dev)] + ([("nccl", "cuda")] if cards >= procs
                                  else [])
    for backend, where in backends:
        t1 = time.perf_counter()
        ranks = launch(tp_worker, TP_MESHES[0], backend=backend,
                       device=where, timeout_s=MP_TIMEOUT_S)
        transport = ("gloo through the host" if backend == "gloo"
                     else "nccl")
        log(f"tp: {procs} processes, {transport}, wall "
            f"{time.perf_counter() - t1:.1f} s")
        for axes in TP_MESHES:
            runs = [r[axes] for r in ranks]
            gap = max(abs(a - b) / max(abs(b), 1e-30)
                      for r in runs for a, b in zip(
                          r["losses"] + r["gnorms"],
                          ref["losses"] + ref["gnorms"]))
            at = [a for a, _ in axes].index("model")
            tp = sum(pl[at].startswith("Shard")
                     for pl in runs[0]["placements"])
            log(f"tp (a) [smoke {TP_SMOKE['arch']} {TP_SMOKE['overrides']} "
                f"f32 on {list(axes)}, {transport}]: rank 0 losses "
                f"{runs[0]['losses']} gnorms {runs[0]['gnorms']}; one card "
                f"losses {ref['losses']} gnorms {ref['gnorms']}; largest "
                f"relative gap over the ranks {gap:.3e} (bar {TP_TOL}); "
                f"{tp} of {len(runs[0]['placements'])} parameter leaves "
                f"sharded on 'model'; launches "
                f"{json.dumps(runs[0]['launches'])}")
            if not gap <= TP_TOL:
                fail(f"tp (a) on {list(axes)}: the ranks' losses and gnorms "
                     f"differ from the one-card run's by {gap:.3e}, over "
                     f"{TP_TOL}")
            if not tp:
                fail(f"tp (a) on {list(axes)}: no leaf sharded on 'model'")
            if any(v for r in runs for v in r["launches"].values()):
                fail(f"tp (a) on {list(axes)}: kernels launched "
                     f"{[r['launches'] for r in runs]}")
        full = [r["full"] for r in ranks]
        if any(f["losses"] != full[0]["losses"] for f in full) \
                or not all(math.isfinite(x) for x in full[0]["losses"]
                           + full[0]["gnorms"]):
            fail(f"tp (b): losses {[f['losses'] for f in full]} gnorms "
                 f"{[f['gnorms'] for f in full]}")
        if any(v for f in full for v in f["launches"].values()):
            fail(f"tp (b): kernels launched {[f['launches'] for f in full]}")
        for rank, f in enumerate(full):
            parts = auto_parts(f)
            fsdp = (f"{MP_AUTO_PEAKS[rank] / 2**30:.2f} GiB"
                    if backend == "gloo" and MP_AUTO_PEAKS else "not run")
            log(f"tp (b) [full {AUTO_FULL['arch']} depth "
                f"{MP_TRAIN['layers']} of {AUTO_FULL['arch']}'s 40, bf16, "
                f"seq {AUTO_FULL['seq_len']}, batch "
                f"{AUTO_FULL['global_batch']}, {list(TP_MESHES[0])}, "
                f"{transport}"
                + (": host staging, not links" if backend == "gloo" else "")
                + f"] rank {rank}: {f['sharded']} leaves sharded; losses "
                f"{f['losses']} gnorms {f['gnorms']}; step "
                f"{parts['step']:.1f} ms (steps "
                f"{[round(x * 1e3, 1) for x in f['step_s']]}); gather "
                f"{parts['gather']:.1f} ms, forward + backward "
                f"{parts['forward_backward']:.1f} ms, reduce-scatter "
                f"{parts['reduce_scatter']:.1f} ms, AdamW "
                f"{parts['adamw']:.1f} ms; peak {f['peak'] / 2**30:.2f} GiB "
                f"(mp (h)'s FSDP on ('data', 4), same depth: {fsdp}); "
                f"sent over the model line {f['model_bytes']} bytes a step")
            if backend == "gloo" and MP_AUTO_PEAKS \
                    and not f["peak"] < MP_AUTO_PEAKS[rank]:
                fail(f"tp (b) rank {rank}: peak {f['peak'] / 2**30:.2f} GiB"
                     f", not under mp (h)'s FSDP "
                     f"{MP_AUTO_PEAKS[rank] / 2**30:.2f} GiB")
        del ranks
    if cards < procs:
        log(f"tp: the tensor-parallel step over NCCL not run: this machine "
            f"has {cards} card(s), NCCL needs one a rank ({procs})")
    log(f"phase tp wall {time.perf_counter() - t0:.1f} s")


def phase_ft(dev, baseline: dict) -> dict:
    """Phase ft: `run_training` with a checkpoint directory (the
    FaultTolerantLoop over the ZeRO-3 step; checkpoints under the ignored
    build/ of this checkout, removed after).

    (a) FT_ARCH at full width and phase 5r's depth, per leaf at
    TRAIN_RECURRENT's lr, the weights and batches of phase 5r's run of
    it, FT_FULL["steps"] steps, first
    without faults, then with a checkpoint every FT_FULL["ckpt_every"]
    under two faults, each a step past the newest checkpoint: a device
    loss at the start of step FT_FULL["loss_at"] (before its first
    launch), restored in place and replayed; then a corrupted payload at
    reduce-scatter FT_FULL["scatter"] of that step's second attempt, so
    the step stops part-way through its reduce-scatters, restored and
    replayed again. The step calls must be FT_FULL["calls"]; each call's
    loss must equal the fault-free run's of its step index, and that
    run's first steps phase 5r's (`baseline`), to every digit;
    fused_reduce must launch exactly the step calls' launches plus the
    launches of the attempt cut off (its gathers and the scatters before
    the corrupted one), and the fault-free run the step calls' alone (as
    many a step as phase 5r's run). Prints the
    checkpoint's bytes, the host snapshot (what blocks the step), the
    write with its CRC, the restore's checksum pass, read and copy to the
    device (each with its GB/s), the device memory before and the peak
    during the restore, the disk's free space and the host's memory.

    (b) The smoke soak: stablelm-12b at smoke size, bf16, 8 ranks,
    bucketed at TRAIN_SMOKE_BUCKET_BYTES, FT_SOAK's steps and plan plus
    its payload corruption, against the same run without faults: the
    same final state bit for bit, every step's loss equal, the step calls
    FT_SOAK["calls"], 3 restarts, 1 checkpoint fallback, 1 guarded
    failure, no degraded level left, no demotion; fused_reduce launched
    exactly the step calls' launches (plus, in the faulted run, the
    gathers before the corrupted payload). Returns the launch counts of
    the four runs (each zeroed just before its run, read just after)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainConfig, run_training
    from repro_torch.planner.service import default_service
    from repro_torch.runtime.faults import (FaultEvent, FaultInjector,
                                            FaultPlan)
    from repro_torch.runtime.metrics import default_metrics

    t_phase = time.perf_counter()
    tr = TRAIN
    ft = TRAIN_RECURRENT
    counts = dict.fromkeys(ops.LAUNCHES, 0)
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ft_", dir=root))

    def run(tc, events, label):
        """One run of `tc` under a plan of `events`, its launches counted;
        returns the result, what fired and the log lines."""
        lines = []
        torch.cuda.synchronize()
        ops.reset_launches()
        with FaultInjector(FaultPlan(seed=7, events=tuple(events))) as inj:
            out = run_training(tc, smoke=tc.n_layers is None,
                               on_log=lambda m: (lines.append(m),
                                                 log(f"ft [{label}]: {m}")))
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        for name, c in got.items():
            counts[name] += c
        return out, inj.stats()["fired"], lines, got

    try:
        # (a) full width
        cfg = dataclasses.replace(get_config(FT_ARCH),
                                  n_layers=baseline["layers"])
        need = _state_bytes(cfg, ft["local_ranks"])
        free = shutil.disk_usage(work).free
        with open("/proc/meminfo") as f:
            mem = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}
        log(f"ft [full width]: {FT_ARCH} at depth {cfg.n_layers} of "
            f"{get_config(FT_ARCH).n_layers}, phase 5r's run; checkpoint of "
            f"{need / 1e9:.3f} GB; up to 3 on"
            f" disk (keep=2 and a .tmp_ dir) need {3 * need / 1e9:.1f} GB, "
            f"{free / 1e9:.1f} GB free in {work}; host memory "
            f"{mem.get('MemAvailable', 0) / 2**30:.1f} GiB available of "
            f"{mem.get('MemTotal', 0) / 2**30:.1f}")
        if free < 3 * need:
            fail(f"phase ft: {free / 1e9:.1f} GB free in {work}, the "
                 f"full-width checkpoints need {3 * need / 1e9:.1f}")
        tc = TrainConfig(
            arch=FT_ARCH, steps=FT_FULL["steps"], seq_len=ft["seq_len"],
            global_batch=ft["global_batch"], lr=ft["lr"], engine="manual",
            sync="plan", bucket_bytes=0, n_layers=baseline["layers"],
            local_ranks=ft["local_ranks"], log_every=1)
        clean, _, _, got_clean = run(tc, [], "full width, fault-free")
        per_call, per_gather, per_scatter = ft_launches(clean)
        n_leaves = len(clean["state"]["params"])
        want_loss = dict(zip(clean["steps"], clean["losses"]))
        want_clean = FT_FULL["steps"] * per_call
        del clean
        torch.cuda.empty_cache()
        # each completed step call runs n_leaves guarded gathers, then
        # n_leaves guarded reduce-scatters; the lost attempt runs none
        ordinal = FT_FULL["after"] * 2 * n_leaves + n_leaves \
            + FT_FULL["scatter"]
        tc = dataclasses.replace(tc, ckpt_dir=str(work / "full"),
                                 ckpt_every=FT_FULL["ckpt_every"])
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with CheckpointRecorder() as rec:
            out, fired, lines, got = run(
                tc, [FaultEvent("device_loss", FT_FULL["loss_at"]),
                     FaultEvent("payload_corrupt", ordinal)], "full width")
        wall = time.perf_counter() - t0
        peak = max(rec.peak_before, torch.cuda.max_memory_allocated(dev))
        calls = len(out["steps"])
        cut = n_leaves * per_gather + FT_FULL["scatter"] * per_scatter
        want = calls * per_call + cut
        final = sorted(os.listdir(work / "full"))
        (plan,) = out["plans"]
        log(f"ft [full width]: step calls {out['steps']}, losses "
            f"{out['losses']}; the fault-free run's by step {want_loss}; "
            f"phase 5r's {FT_ARCH} run {baseline['losses']}; fired "
            f"{fired} (the payload at guarded launch {ordinal}: "
            f"reduce-scatter {FT_FULL['scatter']} of {n_leaves}); restarts "
            f"{out['loop'].restarts}; guard {plan.schedule.stats}, "
            f"demotions {plan.schedule.demotions}; directory {final}; wall "
            f"{wall:.1f} s; run peak {peak / 2**30:.2f} GiB")
        log(f"ft [full width]: fused_reduce launches {got['fused_reduce']}, "
            f"expected {want} = {calls} step calls x {per_call} + {cut} of "
            f"the attempt cut off ({n_leaves} gathers x {per_gather} + "
            f"{FT_FULL['scatter']} scatters x {per_scatter}; the device "
            f"loss fires before its step's first launch); fault-free "
            f"{got_clean['fused_reduce']}, expected {FT_FULL['steps']} x "
            f"{per_call} = {want_clean} (phase 5r's {baseline['fused_reduce']}"
            f" for {ft['steps']} steps); launches {json.dumps(got)}")
        if out["steps"] != FT_FULL["calls"] \
                or fired != {"device_loss": 1, "payload_corrupt": 1} \
                or out["loop"].restarts != 2 or plan.schedule.demotions:
            fail(f"phase ft [full width]: step calls {out['steps']}, fired "
                 f"{fired}, {out['loop'].restarts} restart(s), demotions "
                 f"{plan.schedule.demotions}")
        resumes = [m for m in lines if m.startswith("ft: resume")]
        if resumes != [f"ft: resume {{'step': {FT_FULL['ckpt_every']}}}"] * 2 \
                or final != ["LATEST", f"step_{FT_FULL['ckpt_every']:08d}",
                             f"step_{FT_FULL['steps']:08d}"]:
            fail(f"phase ft [full width]: restores {resumes}, the directory "
                 f"holds {final}")
        if any(loss != want_loss[s] for s, loss in
               zip(out["steps"], out["losses"], strict=True)) \
                or [want_loss[s] for s in range(len(baseline["losses"]))] \
                != baseline["losses"]:
            fail(f"phase ft [full width]: losses {out['losses']} at steps "
                 f"{out['steps']} are not the fault-free {want_loss}, or "
                 f"those not phase 5r's {baseline['losses']}, to every digit")
        if got["fused_reduce"] != want or any(
                c for k, c in got.items() if k != "fused_reduce") \
                or got_clean["fused_reduce"] != want_clean \
                or ft["steps"] * per_call != baseline["fused_reduce"]:
            fail(f"phase ft [full width]: launches {got} / fault-free "
                 f"{got_clean}, expected {want} / {want_clean} fused_reduce "
                 f"and no other kernel")
        sv = rec.saves
        rs = rec.restores
        if len(sv) != 3 or len(rs) != 2:
            fail(f"phase ft [full width]: {len(sv)} saves and {len(rs)} "
                 f"restores, expected 3 and 2")
        for s_ in sv:
            log(f"ft [full width]: save at step {s_['step']}: "
                f"{s_['bytes'] / 1e9:.3f} GB of leaves ({s_['file_bytes']} "
                f"bytes on disk); host snapshot "
                f"{_gbps(s_['bytes'], s_['snapshot_s'])}; write + CRC "
                f"{_gbps(s_['file_bytes'], s_['write_s'])}")
        for r in rs:
            log(f"ft [full width]: restore of step {r['step']}: "
                f"{r['bytes'] / 1e9:.3f} GB in {r['seconds']:.3f} s: "
                f"checksum pass {_gbps(r['bytes'], r['verify_s'])}, read "
                f"{_gbps(r['bytes'], r['read_s'])}, to the device "
                f"{_gbps(r['bytes'], r['copy_s'])}; device memory "
                f"{r['live'] / 2**30:.2f} GiB before, peak "
                f"{r['peak'] / 2**30:.2f} GiB during (in place: "
                f"+{(r['peak'] - r['live']) / 2**20:.1f} MiB)")
        if sv[0]["bytes"] != need:
            fail(f"phase ft: a checkpoint holds {sv[0]['bytes']} bytes of "
                 f"leaves, the state {need}")
        del out, rec
        torch.cuda.empty_cache()

        # (b) the smoke soak
        base = dict(arch=tr["arch"], steps=FT_SOAK["steps"], seq_len=32,
                    global_batch=tr["global_batch"], lr=TRAIN["lr"],
                    engine="manual", sync="plan",
                    bucket_bytes=TRAIN_SMOKE_BUCKET_BYTES,
                    local_ranks=tr["local_ranks"],
                    ckpt_every=FT_SOAK["ckpt_every"], log_every=1000)
        clean, _, _, got_clean = run(
            TrainConfig(**base, ckpt_dir=str(work / "clean")), [],
            "soak, fault-free")
        per_call, per_gather, _ = ft_launches(clean)
        step = clean["step"]
        ordinal = FT_SOAK["after"] * (len(step.gather_buckets)
                                      + len(step.scatter_buckets)) \
            + FT_SOAK["bucket"]
        events = [FaultEvent(*e) for e in FT_SOAK["events"]] \
            + [FaultEvent("payload_corrupt", ordinal)]
        names = ("ft_restarts_total", "ckpt_restore_fallbacks_total",
                 "guarded_failures_total")
        before = {k: default_metrics().counter(k).value for k in names}
        chaos, fired, _, got_chaos = run(
            TrainConfig(**base, ckpt_dir=str(work / "chaos")), events,
            "soak, faulted")
        delta = {k: default_metrics().counter(k).value - before[k]
                 for k in names}
        degraded = default_service().degraded()
        (plan,) = chaos["plans"]
        same = all(torch.equal(a, b) for a, b in zip(
            chaos["state"]["params"] + chaos["state"]["opt"]["m"]
            + chaos["state"]["opt"]["v"] + [chaos["state"]["opt"]["step"]],
            clean["state"]["params"] + clean["state"]["opt"]["m"]
            + clean["state"]["opt"]["v"] + [clean["state"]["opt"]["step"]],
            strict=True))
        want_loss = dict(zip(clean["steps"], clean["losses"]))
        want_clean = FT_SOAK["steps"] * per_call
        want_chaos = len(FT_SOAK["calls"]) * per_call \
            + FT_SOAK["bucket"] * per_gather
        log(f"ft [soak]: {len(step.gather_buckets)} gather and "
            f"{len(step.scatter_buckets)} scatter buckets; payload "
            f"corruption at guarded launch {ordinal}; fired {fired}; step "
            f"calls {chaos['steps']}; counters {delta}; degraded after "
            f"{degraded}; guard {plan.schedule.stats}, demotions "
            f"{plan.schedule.demotions}; final state "
            f"{'equal' if same else 'DIFFERS'} to the fault-free run's; "
            f"fused_reduce launches {got_clean['fused_reduce']} fault-free "
            f"(expected {FT_SOAK['steps']} x {per_call} = {want_clean}), "
            f"{got_chaos['fused_reduce']} faulted (expected "
            f"{len(FT_SOAK['calls'])} step calls x {per_call} + "
            f"{FT_SOAK['bucket']} gathers x {per_gather} before the "
            f"corrupted payload = {want_chaos})")
        if not same or any(loss != want_loss[s] for s, loss in
                           zip(chaos["steps"], chaos["losses"])):
            fail("phase ft [soak]: the faulted run does not end on the "
                 "fault-free run's state and losses bit for bit")
        if chaos["steps"] != FT_SOAK["calls"] or delta[names[0]] < 3 \
                or delta[names[1]] < 1 or delta[names[2]] < 1:
            fail(f"phase ft [soak]: step calls {chaos['steps']}, counters "
                 f"{delta}")
        if degraded or plan.schedule.demotions:
            fail(f"phase ft [soak]: degraded {degraded}, demotions "
                 f"{plan.schedule.demotions}")
        if got_clean["fused_reduce"] != want_clean \
                or got_chaos["fused_reduce"] != want_chaos:
            fail(f"phase ft [soak]: fused_reduce launched "
                 f"{got_clean['fused_reduce']} / {got_chaos['fused_reduce']}"
                 f", expected {want_clean} / {want_chaos}")
        del clean, chaos
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase ft: wall {time.perf_counter() - t_phase:.1f} s")
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


def phase_serve_all(dev, recorder, t0: float) -> dict:
    """Phase 4: each of SERVE_ARCHS served (depth cut as SERVE_LAYERS
    says) and its decode profiled, the long requests (the whisper one
    through the model API), then each smoke-size model card against CPU;
    returns the kernel launches of the served runs, summed."""
    from repro_torch.kernels import ops
    served = dict.fromkeys([*TOLERANCE, *ops.ATTENTION_LAUNCHES], 0)
    for arch in SERVE_ARCHS:
        sc = {**SERVE, "arch": arch, "n_layers": SERVE_LAYERS.get(arch)}
        for name, n in phase_serve(dev, recorder, sc).items():
            served[name] += n
        phase_decode_profile(dev, arch)
        log(f"phase serve {arch} done at {time.perf_counter() - t0:.1f} s")
    for sc in (LONG, LONG_GEMMA3):
        for name, n in phase_serve(dev, recorder, sc).items():
            served[name] += n
        log(f"phase serve long {sc['arch']} done at "
            f"{time.perf_counter() - t0:.1f} s")
    for name, n in phase_whisper_long(dev, recorder).items():
        served[name] += n
    log(f"phase serve long {WHISPER_LONG['arch']} done at "
        f"{time.perf_counter() - t0:.1f} s")
    for arch in SERVE_ARCHS:
        phase_model_reference(dev, arch)
    log(f"phase serve smoke models done at {time.perf_counter() - t0:.1f} s")
    return served


# ---------------------------------------------------------------------------
# the census and the dry run
# ---------------------------------------------------------------------------
def start_dryrun(src: Path) -> subprocess.Popen:
    """`python -m repro_torch.launch.dryrun --all` on the meta device, in
    a process of its own with no card visible (CUDA_VISIBLE_DEVICES
    empty), one CPU thread at the lowest priority (the card's phases are
    host-bound too), its JSON into DRYRUN_DIR; it runs beside the card's
    phases, and phase census waits for it. Killed at exit if it is still
    running."""
    import atexit
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    out = open(DRYRUN_DIR / "dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--json", str(DRYRUN_DIR / "dryrun.json")], env=env, stdout=out,
        stderr=subprocess.STDOUT, cwd=str(ROOT),
        preexec_fn=lambda: os.nice(19))
    proc.started = time.perf_counter()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    atexit.register(stop)
    return proc


def census_leaf_payloads(step, numels, elem: int) -> int:
    """Per-rank payload bytes of one per-leaf step's all-gathers (the same
    for its reduce-scatters) on one axis, by `level_bytes`' reckoning:
    each leaf padded to its plan's multiple (a schedule's block count, a
    flat label's `_pad_multiple`)."""
    from repro_torch.core import collectives as C
    (pl,) = step.plans
    n = dict(step.mesh)[pl.axis]
    mult = (pl.schedule.num_blocks if pl.strategy == "plan"
            else C._pad_multiple(n, pl.strategy))
    return sum(-(-m // mult) * mult for m in numels) * elem


def phase_census(dev, dryrun) -> dict:
    """Phase census (`repro_torch.launch.analysis`). (a) Phase 5's
    per-leaf stablelm-12b step (TRAIN: full width, 2 layers, 8 ranks) on
    the card: two steps without a census, then one inside `census(8)`:
    its collectives must be one all-gather and one reduce-scatter a leaf
    and the two metrics' pmeans, their per-rank payloads each leaf padded
    as `level_bytes` pads it, exactly; the launches of the censused step
    must equal the step's before; prints the census's FLOPs a rank
    against `train_bounds`' product count, its peak live bytes (plus what
    was allocated before) against `torch.cuda.max_memory_allocated()`,
    and the step's time without and with the census. (b) One decode step
    of the served stablelm-12b at full width (SERVE's batch and cache)
    on the card, censused: its kernel work beside its FLOPs and bytes;
    and one decode step of each CENSUS_DECODE_ARCHS model at smoke size
    in f32 on the card and on the CPU: the kernel work (calls, FLOPs,
    bytes) must be equal. (c) The dry run on the meta device
    (`start_dryrun`, running since the start): waits for it, fails if it
    failed, prints one line a cell. Returns the launch counts of (a) and
    (b)'s card runs."""
    import dataclasses

    import torch
    from repro_torch.configs import all_cells, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis
    from repro_torch.launch.dryrun import cell_line
    from repro_torch.launch.serve import step_batch
    from repro_torch.launch.train import (batch_tensors, data_config,
                                          make_manual_train_step,
                                          shard_params_zero3)
    from repro_torch.models.config import smoke_config
    from repro_torch.models.registry import build
    from repro_torch.models.tree import tree_items
    from repro_torch.optim import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    totals = {k: 0 for k in ops.LAUNCHES}
    tr = TRAIN
    cfg = dataclasses.replace(get_config(tr["arch"]), n_layers=tr["layers"])
    n = tr["local_ranks"]
    api = build(cfg)
    torch.cuda.empty_cache()
    shards = shard_params_zero3(api.init_params(
        torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev), n)
    state = {"params": shards, "opt": adamw_init(shards)}
    step = make_manual_train_step(api, n, AdamWConfig(lr=TRAIN_FALL_LRS[0]),
                                  device=dev)
    data = SyntheticLM(data_config(cfg, tr["seq_len"], tr["global_batch"]))
    numels = [math.prod(t.shape) for _, t in tree_items(api.params_spec())]
    times, launches = [], []
    for s in range(3):
        batch = batch_tensors(data.batch_at(s), dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        if s == 2:
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with (analysis.census(n) if s == 2 else contextlib.nullcontext()
              ) as c:
            state, m = step(state, batch)
            loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(ops.LAUNCHES))
        for k, v in ops.LAUNCHES.items():
            totals[k] += v
    peak = torch.cuda.max_memory_allocated(dev)
    st = c.stats()
    leaves = len(shards)
    payload = census_leaf_payloads(step, numels, shards[0].element_size())
    want_counts = {"all-gather": leaves, "reduce-scatter": leaves,
                   "all-reduce": 2}
    want_payload = {"all-gather": float(payload),
                    "reduce-scatter": float(payload), "all-reduce": 8.0}
    (plan,) = step.plans
    bounds = train_bounds(cfg, plan.schedule.inner, shards, n, tr["seq_len"],
                          tr["global_batch"], step, plan)
    log(f"census [train]: {cfg.name} layers={cfg.n_layers}, {n} ranks, "
        f"per leaf ({leaves} leaves); collectives {json.dumps(st.coll_counts)}"
        f" payload a rank {json.dumps(st.coll_payload_by_kind)} against "
        f"level_bytes' padded leaves {json.dumps(want_payload)}; wire bytes "
        f"{json.dumps(st.coll_by_kind)}; FLOPs a rank {st.flops:.6e} against "
        f"train_bounds' product count {bounds['rank_flops']:.6e} (ratio "
        f"{st.flops / bounds['rank_flops']:.4f}); HBM bytes a rank "
        f"{st.hbm_bytes:.6e}; kernel work {json.dumps(c.kernel_work())}; "
        f"peak live bytes {c.peak_bytes / 2**30:.3f} GiB + {base / 2**30:.3f}"
        f" GiB allocated before = {(c.peak_bytes + base) / 2**30:.3f} GiB "
        f"against max_memory_allocated {peak / 2**30:.3f} GiB (margin "
        f"{(peak - c.peak_bytes - base) / 2**30:+.3f} GiB); step time "
        f"without the census {times[1]:.1f} ms (first {times[0]:.1f} ms), "
        f"with it {times[2]:.1f} ms ({times[2] / times[1] - 1:+.1%}); "
        f"loss {loss:.4f}; launches {json.dumps(launches)}")
    if st.coll_counts != want_counts \
            or st.coll_payload_by_kind != want_payload:
        fail(f"census [train]: collectives {st.coll_counts} "
             f"{st.coll_payload_by_kind}, expected {want_counts} "
             f"{want_payload}")
    if launches[2] != launches[1] or not math.isfinite(loss):
        fail(f"census [train]: the censused step launched {launches[2]}, "
             f"the step before {launches[1]}; loss {loss}")
    del state, shards, step, m, c
    torch.cuda.empty_cache()

    # (b) decode steps
    sv = build(get_config("stablelm-12b"))
    params = sv.init_params(torch.Generator(device=dev).manual_seed(0),
                            torch.bfloat16, dev)
    B = SERVE["batch"]
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        cache = sv.init_cache(B, SERVE["cache_len"], torch.bfloat16, dev)
        cache["pos"].fill_(SERVE["prompt_len"])
        ops.reset_launches()
        with analysis.census() as c:
            logits, cache = sv.decode_step(params, cache, {"tokens": tok})
        torch.cuda.synchronize()
    for k, v in ops.LAUNCHES.items():
        totals[k] += v
    st = c.stats()
    log(f"census [decode]: stablelm-12b full width, batch {B}, cache "
        f"{SERVE['cache_len']}: FLOPs {st.flops:.6e}, HBM bytes "
        f"{st.hbm_bytes:.6e}, kernel work {json.dumps(c.kernel_work())}, "
        f"launches {json.dumps(dict(ops.LAUNCHES))}")
    got = c.kernel_work()
    if got["rmsnorm"][0] != ops.LAUNCHES["rmsnorm"] \
            or got["flash_attention"][0] != ops.LAUNCHES["flash_attention"]:
        fail(f"census [decode]: kernel calls {got} against launches "
             f"{ops.LAUNCHES}")
    del params, cache, logits, c
    torch.cuda.empty_cache()
    for arch in CENSUS_DECODE_ARCHS:
        api = build(smoke_config(get_config(arch)))
        params = api.init_params(torch.Generator().manual_seed(0),
                                 torch.float32, "cpu")
        batch = reference_batch(api.cfg, 2, 8)
        work = {}
        for where in ("cpu", dev):
            p = _to(params, where)
            with torch.inference_mode():
                logits, cache = api.prefill(p, _to(batch, where), 16)
                tok = logits[:, -1].argmax(dim=-1)
                b = step_batch(api.cfg, p, tok)
                ops.reset_launches()
                with analysis.census() as c:
                    api.decode_step(p, cache, b)
            if str(where) != "cpu":
                for k, v in ops.LAUNCHES.items():
                    totals[k] += v
            work[str(where)] = c.kernel_work()
        log(f"census [decode smoke {arch}]: kernel work card "
            f"{json.dumps(work[str(dev)])}, CPU {json.dumps(work['cpu'])}")
        if work["cpu"] != work[str(dev)] or not work["cpu"]:
            fail(f"census [decode smoke {arch}]: the card's kernel work "
                 f"differs from the CPU's")

    # (c) the dry run
    ended = dryrun.poll() is not None
    t_wait = time.perf_counter()
    left = max(1.0, DRYRUN_BUDGET_S - (t_wait - dryrun.started))
    try:
        rc = dryrun.wait(timeout=left)
    except subprocess.TimeoutExpired:
        fail(f"the dry run did not finish within {DRYRUN_BUDGET_S} s of "
             f"its start; see {DRYRUN_DIR / 'dryrun.log'}")
    if rc != 0:
        fail(f"the dry run failed (exit {rc}); see "
             f"{DRYRUN_DIR / 'dryrun.log'}")
    doc = json.loads((DRYRUN_DIR / "dryrun.json").read_text())
    cells = doc["results"]
    for r in cells:
        log(f"dryrun: [skip] {r['arch']} × {r['shape']}" if "skipped" in r
            else "dryrun: " + cell_line(r))
    ran = [r for r in cells if "hlo_flops" in r]
    log(f"dryrun: {len(ran)} cells run on meta, "
        f"{len(cells) - len(ran)} documented skips, "
        f"{sum(r['run_s'] for r in ran):.1f} s of cell time; "
        + ("it had ended before this phase" if ended else
           f"this phase waited {time.perf_counter() - t_wait:.1f} s for "
           f"it, {time.perf_counter() - dryrun.started:.1f} s from its "
           "start"))
    supported = sum(ok for *_, ok in all_cells())
    if len(ran) != supported or any("error" in r for r in cells):
        fail(f"the dry run ran {len(ran)} cells, expected {supported}")
    log(f"phase census wall {time.perf_counter() - t_phase:.1f} s")
    return totals


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
    ap.add_argument("--planner", action="store_true",
                    help="build the kernels and run the planner phase "
                    "alone (Fig. 4, calibration, skew, step plans), then "
                    "stop: no result line")
    ap.add_argument("--flat", action="store_true",
                    help="build the kernels and run the flat collectives "
                    "phase alone, then stop: no result line")
    ap.add_argument("--serve", action="store_true",
                    help="build the kernels, run the model kernels' rows of "
                    "phase 2 (FLASH_GRID, the rmsnorm rows) and phase 4 "
                    "alone, then stop: no result line")
    ap.add_argument("--ft", action="store_true",
                    help="build the kernels, run phase 5r (whose FT_ARCH "
                    "run phase ft (a) replays) and phase ft, then stop: "
                    "no result line")
    ap.add_argument("--moe-train", action="store_true",
                    help="build the kernels and run phase 5m (MoE training "
                    "at full width, then smoke-size card against CPU) "
                    "alone, then stop: no result line")
    ap.add_argument("--recurrent-train", action="store_true",
                    help="build the kernels and run phase 5r (rwkv6-1.6b "
                    "and hymba-1.5b training at full width, then smoke-size "
                    "card against CPU) alone, then stop: no result line")
    ap.add_argument("--family-train", action="store_true",
                    help="build the kernels and run phase 5f (qwen2-vl-7b, "
                    "whisper-large-v3 and mixtral-8x22b training at full "
                    "width, then smoke-size card against CPU) alone, then "
                    "stop: no result line")
    ap.add_argument("--mp", action="store_true",
                    help="build the kernels and run phase mp (the process "
                    "mesh: 8 and 4 processes on this card over gloo "
                    "through the host; over NCCL too, one card a rank, "
                    "where there are two cards or more) alone, then stop: "
                    "no result line")
    ap.add_argument("--auto", action="store_true",
                    help="build the kernels, run phase 5's per-leaf run at "
                    "the first of TRAIN_FALL_LRS, phase auto and phase mp "
                    "(h) alone, then stop: no result line")
    ap.add_argument("--tp", action="store_true",
                    help="build the kernels and run phase tp (tensor "
                    "parallelism on the auto engine's 'model' axis, 4 "
                    "processes on this card over gloo) alone, then stop: "
                    "no result line")
    ap.add_argument("--census", action="store_true",
                    help="build the kernels and run phase census alone "
                    "(the dry run beside it), then stop: no result line")
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
    quick = (args.attention or args.recurrence or args.planner or args.flat
             or args.serve or args.ft or args.moe_train
             or args.recurrent_train or args.family_train or args.mp
             or args.auto or args.tp)
    dryrun = None if quick else start_dryrun(src)
    phase_build()
    log(f"phase build done at {time.perf_counter() - t0:.1f} s")
    if args.census:
        phase_census(dev, dryrun)
        log(f"phase census done at {time.perf_counter() - t0:.1f} s")
        return 0
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
    if args.planner:
        phase_planner(dev)
        log(f"phase planner done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.flat:
        log_rows(phase_flat(dev)[1])
        log(f"phase flat done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.serve:
        log_rows(model_kernel_grid(dev))
        log(f"model kernel grid done at {time.perf_counter() - t0:.1f} s")
        phase_serve_all(dev, ShapeRecorder(), t0)
        log(f"phase serve done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.moe_train:
        phase_train_moe(dev)
        log(f"phase moe train done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.recurrent_train:
        phase_train_recurrent(dev)
        log(f"phase recurrent train done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.family_train:
        phase_train_family(dev)
        log(f"phase family train done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.mp:
        phase_mp(dev)
        log(f"phase mp done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.auto:
        r = phase_train(dev, TRAIN_FALL_LRS[0], True)
        auto_ref = phase_auto(dev, {k: r[k] for k in ("step_ms", "parts",
                                                       "peak")})
        del r
        log(f"phase auto done at {time.perf_counter() - t0:.1f} s")
        phase_mp_auto(dev, auto_ref, None)
        log(f"phase mp (h) done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.tp:
        phase_tp(dev)
        log(f"phase tp done at {time.perf_counter() - t0:.1f} s")
        return 0
    if args.ft:
        phase_ft(dev, phase_train_recurrent(dev)[1])
        log(f"phase ft done at {time.perf_counter() - t0:.1f} s")
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
    flat, flat_rows = phase_flat(dev)
    log_rows(flat_rows)
    log(f"phase flat done at {time.perf_counter() - t0:.1f} s")
    planner = phase_planner(dev)
    log(f"phase planner done at {time.perf_counter() - t0:.1f} s")
    served = phase_serve_all(dev, rec_serve, t0)
    log(f"phase serve done at {time.perf_counter() - t0:.1f} s")
    trained, baseline = phase_train_all(dev)
    log(f"phase train done at {time.perf_counter() - t0:.1f} s")
    auto_ref = phase_auto(dev, baseline)
    log(f"phase auto done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_train_moe(dev).items():
        trained[name] += n
    log(f"phase moe train done at {time.perf_counter() - t0:.1f} s")
    recurrent, ft_baseline = phase_train_recurrent(dev)
    for name, n in recurrent.items():
        trained[name] += n
    log(f"phase recurrent train done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_train_family(dev).items():
        trained[name] += n
    log(f"phase family train done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_mp(dev, auto_ref).items():
        trained[name] += n
    log(f"phase mp done at {time.perf_counter() - t0:.1f} s")
    phase_tp(dev)
    log(f"phase tp done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_ft(dev, ft_baseline).items():
        trained[name] += n
    log(f"phase ft done at {time.perf_counter() - t0:.1f} s")
    for name, n in phase_census(dev, dryrun).items():
        trained[name] += n
    log(f"phase census done at {time.perf_counter() - t0:.1f} s")
    # each kernel is timed at its first launch on the main path: the
    # server's shapes where it launched the kernel, else the executor's,
    # else the families'
    main_path = {k: executor[k] + families[k] + flat[k] + planner[k]
                 + served[k] + trained[k] for k in TOLERANCE}
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
