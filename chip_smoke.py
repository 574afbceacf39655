#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on
any error:

  1. build    — compile every CUDA kernel from `src/repro_torch/kernels/
                csrc` (one nvcc per source, all at once);
  2. kernels  — each kernel against its plain PyTorch version on the card,
                over a grid of shapes, in the dense form (the TPU
                kernel's shape) and the gathered form the executor folds
                with, with its time (CUDA events), its memory bound and
                one PyTorch yardstick call where one computes the same
                function;
  3. executor — GenTree plans from the planner, lowered and run with
                `run_local` on an 8-rank local mesh (a single switch and
                the two-level tree), decode-sized and gradient-sized, in
                f32 and every compressed wire, checked against the column
                sum (f32 at 1e-6, wires within their error budget), with
                device time (CUDA events), wall time (host clock to a
                synchronize) and two bounds: the schedule's (every
                round's and fold's rows crossing memory once) and the
                function's (input read and output written once);
  4. serve    — `repro_torch.launch.serve` on stablelm-12b at full size
                (random weights), batch 4, prompt 32, 32 new tokens, cache
                128, 8 local ranks; then a few decode steps of the same
                model under torch.profiler (device busy share, kernels per
                step, weight-read bound), and a smoke-size model's logits
                on the card against the same code on the CPU.

The main path is phases 3 and 4: every launch count is zeroed just
before each of them and read just after. Every kernel must have launched
in phase 3 (the executor runs the compressed wires there) and the
fused-reduce kernel in phase 4 (the server's decode AllReduce folds
through it), with no guard demotion or failure anywhere (the guard
raises rather than demote, so a failure ends the run). The last lines
are the per-kernel JSON (launches on the main path; time, plain time,
bound and yardstick of the wrapper call of the kernel's first launch in
phase 4, or in phase 3 for a kernel phase 4 does not launch), the card's
name and power limit, and `{"ok": true, "device": {...}}`.
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
SPIN_HZ = 1.98e9                 # H100 SXM boost clock: spin cycles per s
KERNEL_LANES = (1000, 20480, 1 << 26)                 # phase 2 grid
INTO_LANES = (2560, 1 << 23)                # phase 2, gathered forms
EXEC_SIZES = ((4 * 5120, "decode 4x5120"), (1 << 26, "gradient 2^26"))
SERVE = dict(arch="stablelm-12b", batch=4, prompt_len=32, max_new=32,
             cache_len=128, local_ranks=8)
PROFILE_STEPS = 4                # decode steps traced after serving


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
    return float((a.double() - b.double()).abs().max())


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


def quantize_case(shape, wire, dev, seed=0):
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 3.0
    R, L = shape
    nt = -(-L // ref.QUANT_TILE)
    nbytes = R * (4 * L + nt * ref.QUANT_TILE + 4 * nt)

    def cmp(a, b):   # payload bytes and scales
        return max(max_abs_err(a[0].view(torch.uint8).int(),
                               b[0].view(torch.uint8).int()),
                   max_abs_err(a[1], b[1]))
    return dict(kernel=lambda: ops.quantize(x, wire),
                plain=lambda: ref.quantize_ref(x, wire),
                library=None, nbytes=nbytes, cmp=cmp)


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


def measure(case) -> dict:
    import torch
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    err = (case["cmp"] if "cmp" in case else max_abs_err)(got, want)
    del got, want
    out = {"max_abs_err": err,
           "ms": device_ms(case["kernel"]),
           "plain_ms": device_ms(case["plain"]),
           "bound_ms": bound_ms(case["nbytes"]),
           "bound_by": "bytes",
           "library_ms": (device_ms(case["library"])
                          if case["library"] is not None else None)}
    torch.cuda.synchronize()
    return out


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


def phase_kernels(dev) -> None:
    import torch
    rows = []
    for L in KERNEL_LANES:
        for dtype in (torch.float32, torch.bfloat16):
            for x in (2, 3, 8, 9):
                r = measure(fused_reduce_case((x, L), dtype, dev))
                rows.append(("fused_reduce", f"x={x} L={L} {dtype}", r))
                if r["max_abs_err"] != 0.0:
                    fail(f"fused_reduce x={x} L={L} {dtype} differs from "
                         f"its plain version by {r['max_abs_err']}")
        for wire in ("float8_e4m3fn", "int8"):
            r = measure(quantize_case((8, L), wire, dev))
            rows.append(("quantize", f"R=8 L={L} {wire}", r))
            if r["max_abs_err"] != 0.0:
                fail(f"quantize L={L} {wire} differs from its plain "
                     f"version by {r['max_abs_err']}")
            Lp = -(-L // 128) * 128
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
        torch.cuda.empty_cache()
    for name, what, r in rows:
        lib = (f" library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        log(f"kernel {name:12s} {what:38s} err {r['max_abs_err']:.1e} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms{lib}")


# wrapper → the kernel it launches (the name its launches count under)
WRAPPERS = {"fused_reduce": "fused_reduce",
            "fused_reduce_into": "fused_reduce",
            "quantize": "quantize",
            "quant_reduce": "quant_reduce",
            "quant_reduce_into": "quant_reduce"}


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


def schedule_bytes(cs, size: int, dtype) -> int:
    """Bytes one `run_local` of schedule `cs` on (n, size) rows of `dtype`
    must move if every step's data crosses device memory once: the input
    copied into the working buffer; per round each live payload row read
    and written to staging at wire width (fp8/int8: the quantized row and
    its f32 scales); per fold each live operand and resident partial read
    and the result row written."""
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
    total = 2 * cs.n * cs.num_blocks * chunk * elem
    for st in cs.rs + cs.ag:
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
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was never launched by the executor")
    return counts


def phase_serve(dev, recorder) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, serve

    ops.reset_launches()
    t0 = time.perf_counter()
    with recorder:
        res = serve(ServeConfig(**SERVE, device=str(dev)), smoke=False,
                    on_log=log)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    cfg = res["config"]
    log(f"serve: {cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab}; launches {json.dumps(counts)}; "
        f"demotions {res['tp_schedule'].demotions}; timings "
        f"{json.dumps(res['timings'])}; wall {wall:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    if counts["fused_reduce"] <= 0:
        fail("serve launched no fused_reduce kernel")
    if res["tp_schedule"].demotions or res["tp_schedule"].stats["failures"]:
        fail(f"serve's decode schedule was demoted "
             f"{res['tp_schedule'].demotions} time(s) or failed")
    if not res["self_check_err"] < 1e-5:
        fail(f"serve self-check rel err {res['self_check_err']}")
    toks = res["tokens"]
    want = (SERVE["batch"], SERVE["max_new"])
    if toks.shape != want or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"serve produced tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    del res
    torch.cuda.empty_cache()
    return counts


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_decode_profile(dev) -> None:
    """Where a decode step's time goes: the full-size model of phase 4,
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

    cfg = get_config(SERVE["arch"])
    api = build(cfg)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev)
    weight_bytes = sum(t.numel() * t.element_size()
                       for lp in params["layers"] for d in lp.values()
                       for t in (d.values() if isinstance(d, dict) else [d]))
    weight_bytes += sum(params[k].numel() * params[k].element_size()
                        for k in ("ln_f", "lm_head") if k in params)
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
        log(f"decode profile: {PROFILE_STEPS} steps, wall "
            f"{wall_us / PROFILE_STEPS / 1e3:.3f} ms per step; the trace "
            f"holds no kernel: device time not measured; weight-read bound "
            f"{bound:.3f} ms")
    else:
        busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev_events)
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"decode profile: {PROFILE_STEPS} steps, per step wall "
            f"{wall_us / PROFILE_STEPS / 1e3:.3f} ms, kernels "
            f"{len(kernels) / PROFILE_STEPS:.0f}, device busy "
            f"{busy / PROFILE_STEPS / 1e3:.3f} ms ({busy / wall_us:.1%} of "
            f"wall), weight-read bound {bound:.3f} ms "
            f"({weight_bytes / 1e9:.2f} GB)")
        for name, us in top:
            log(f"decode profile: {us / PROFILE_STEPS / 1e3:.3f} ms per step "
                f"in {name[:100]}")
    del params, cache, logits
    torch.cuda.empty_cache()


def phase_model_reference(dev) -> None:
    """The smoke-size model in f32 on the card against the same code on
    the CPU: prefill + 4 greedy decode steps, logits within 1e-4 of the
    largest |logit|, identical tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.config import smoke_config

    cfg = smoke_config(get_config("stablelm-12b"))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for where in ("cpu", dev):
        p = {"layers": [{k: ({kk: vv.to(where) for kk, vv in v.items()}
                             if isinstance(v, dict) else v.to(where))
                         for k, v in lp.items()} for lp in params["layers"]]}
        p.update({k: v.to(where) for k, v in params.items()
                  if k != "layers"})
        with torch.inference_mode():
            logits, cache = transformer.prefill(p, cfg, tokens.to(where),
                                                cache_len=16)
            outs, toks = [logits.cpu()], []
            for _ in range(4):
                tok = logits[:, -1].argmax(dim=-1)
                toks.append(tok.cpu())
                logits, cache = transformer.decode_step(p, cfg, cache,
                                                        tok[:, None])
                outs.append(logits.cpu())
        runs[str(where)] = (torch.stack(outs), torch.stack(toks))
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(dev)]
    err = float((lg - lc).abs().max() / lc.abs().max())
    log(f"model: smoke-size f32 logits card vs CPU rel err {err:.2e}, "
        f"tokens equal {bool(torch.equal(tc, tg))}")
    if not (torch.isfinite(lg).all() and err <= 1e-4
            and torch.equal(tc, tg)):
        fail("the card's smoke-size model disagrees with the CPU run")


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
    if wrapper == "quant_reduce":
        _, q_shape, q_dtype = args[0]
        own = arg(2, "own")
        return quant_reduce_case(q_shape, wires[q_dtype],
                                 0 if own is None else own[1][-1], dev)
    (_, q_shape, q_dtype), _, table, (_, out_shape, out_dtype) = args[:4]
    return quant_reduce_into_case(q_shape, wires[q_dtype], table, out_shape,
                                  out_dtype, dev)


def kernels_line(dev, first, executor, served) -> dict:
    from repro_torch.kernels import ops
    info = {
        "fused_reduce": ("src/repro_torch/kernels/csrc/fused_reduce.cu",
                         "src/repro/kernels/fused_reduce.py:58"),
        "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                     "src/repro/kernels/quant.py:81"),
        "quant_reduce": ("src/repro_torch/kernels/csrc/quant.cu",
                         "src/repro/kernels/quant.py:147"),
    }
    out = []
    for name, (source, replaces) in info.items():
        wrapper, args, kw = first[name]
        case = _case_at(wrapper, args, kw, dev)
        shapes = [a[1] if isinstance(a, tuple) else tuple(a.rows.shape)
                  for a in args if isinstance(a, (tuple, ops.RowTable))]
        r = measure(case)
        if r["max_abs_err"] != 0.0:
            fail(f"{name} ({wrapper}) at main-path shapes {shapes} differs "
                 f"from its plain version by {r['max_abs_err']}")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": executor[name] + served[name],
                    **r, "wrapper": wrapper, "shapes": shapes})
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = ROOT / "src"
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
    phase_kernels(dev)
    log(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    rec_exec, rec_serve = ShapeRecorder(), ShapeRecorder()
    executor = phase_executor(dev, rec_exec)
    log(f"phase executor done at {time.perf_counter() - t0:.1f} s")
    served = phase_serve(dev, rec_serve)
    phase_decode_profile(dev)
    phase_model_reference(dev)
    log(f"phase serve done at {time.perf_counter() - t0:.1f} s")
    # each kernel is timed at its first launch on the main path: the
    # server's shapes where it launched the kernel, else the executor's
    line = kernels_line(dev, {**rec_exec.first, **rec_serve.first},
                        executor, served)
    log(f"phase kernels line done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
