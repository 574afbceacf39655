"""Batched serving driver: prefill + greedy decode, with the planned
tensor-parallel decode AllReduce executed on a local mesh.

Before serving, the planner prices the decode AllReduce (one per layer,
batch × d_model activations across the tensor-parallel ranks), GenTree
picks its plan, and `core.lower` compiles it (DESIGN.md §8). The schedule
then runs once on a local mesh of `local_ranks` ranks on the serving
device — every fold a fused-reduce kernel launch on a CUDA device — as a
deployment self-check against the plain column sum; it is timed, and the
time is reported to `PlannerService.observe` (DESIGN.md §10) as a
local-mesh observation, which is monitored and never refits. A failed
launch raises: the guard gives way to no plain sum. The
decode loop itself is single-device (`decode_step`), as in the reference
server.

    python -m repro_torch.launch.serve --arch stablelm-12b

builds the full-size model with random weights on the card; `--smoke`
shrinks it, `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.metrics import default_metrics
from repro_torch.runtime.trace import default_tracer


@dataclasses.dataclass
class ServeConfig:
    arch: str = "stablelm-12b"
    batch: int = 4
    prompt_len: int = 32
    max_new: int = 32
    cache_len: int = 128
    seed: int = 0
    # ranks of the local mesh the decode AllReduce runs on: the leading
    # axis of one (local_ranks, batch·d_model) tensor on `device`
    local_ranks: int = 8
    device: str = "cuda"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(sc: ServeConfig, smoke: bool = False, on_log=print) -> dict:
    """Serve one batch of prompts; returns the generated tokens, the
    decode plan and its guarded schedule, the self-check's relative error
    and host-clock timings (each ending in a device synchronize)."""
    dev = resolve_device(sc.device)
    cfg = get_config(sc.arch)
    if smoke:
        cfg = smoke_config(cfg)
    api = build(cfg)
    timings: dict[str, float] = {}

    from repro_torch.core.lower import guard_schedule
    from repro_torch.planner.service import default_service
    n = int(sc.local_ranks)
    size = sc.batch * cfg.d_model
    tp_exec = sched = None
    err = None
    if n > 1:
        svc = default_service()
        tp_exec = svc.get_axis_executable("model", n, float(size))
        # guarded execution (DESIGN.md §12); `sched.demotions` tells the
        # caller whether the planned schedule ever gave way
        sched = guard_schedule(tp_exec.schedule, telemetry=svc.telemetry)
        on_log(f"planner: decode AllReduce executes {tp_exec.algo} plan "
               f"({sched.describe()}) on {n} local ranks ({dev})")
        gen = torch.Generator(device=dev).manual_seed(2)
        probe = torch.randn((n, size), generator=gen, device=dev)
        with default_tracer().span("serve/self_check", n=n,
                                   algo=tp_exec.algo):
            got = sched.run_local(probe)
            _sync(dev)
        want = probe.double().sum(dim=0)
        err = float((got.double() - want).abs().max()
                    / (want.abs().max() + 1e-30))
        on_log(f"planner: executed-schedule self-check rel err {err:.2e}")
        if not err < 1e-5:
            raise RuntimeError(f"executed TP schedule disagrees with the "
                               f"plain sum: rel err {err:.2e}")
        # time the executed plan and feed it to the planner's online loop
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            sched.run_local(probe)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        measured = sorted(ts)[len(ts) // 2]
        timings["allreduce_s"] = measured
        # no predicted= override: observe re-prices at the exact executed
        # size, so the residual carries no cache-bucket bias. The time is
        # one device's rounds and launches, not a switch's links, so it is
        # monitored only and never refits the root_sw params.
        obs = svc.observe("root_sw", n, float(size), measured,
                          key=tp_exec.key, source="local_mesh")
        on_log(f"planner: observed decode plan {measured * 1e3:.3f} ms "
               f"(predicted {obs['predicted'] * 1e3:.3f} ms, drift "
               f"{obs['drift']:.2f}" + (", refit" if obs["refit"] else "")
               + ")")
    else:
        on_log("planner: single rank, no decode collective needed")

    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, torch.bfloat16, dev)
    _sync(dev)
    timings["init_s"] = time.perf_counter() - t0
    pgen = torch.Generator(device=dev).manual_seed(sc.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (sc.batch, sc.prompt_len),
                            generator=pgen, device=dev)

    tracer = default_tracer()
    metrics = default_metrics()
    with torch.inference_mode():
        t0 = time.perf_counter()
        with tracer.span("serve/prefill", batch=sc.batch,
                         prompt_len=sc.prompt_len):
            logits, cache = api.prefill(params, {"tokens": prompts},
                                        sc.cache_len)
            tok = logits[:, -1].float().argmax(dim=-1)
        out = [tok.cpu().numpy()]
        timings["prefill_s"] = time.perf_counter() - t0
        metrics.counter("serve_prefill_total", "prefill calls").inc()
        decode_ctr = metrics.counter("serve_decode_steps_total",
                                     "decode steps executed")
        step_s = []
        for i in range(sc.max_new - 1):
            t0 = time.perf_counter()
            with tracer.span("serve/decode", token=i + 1):
                logits, cache = api.decode_step(params, cache,
                                                {"tokens": tok[:, None]})
                tok = logits[:, -1].float().argmax(dim=-1)
            decode_ctr.inc()
            out.append(tok.cpu().numpy())      # waits for the device
            step_s.append(time.perf_counter() - t0)
        if step_s:
            # the first step pays one-time library set-up; the median is
            # the steady state
            timings["decode_s_per_token"] = float(np.mean(step_s))
            timings["decode_first_s"] = step_s[0]
            timings["decode_median_s"] = float(np.median(step_s))
    gen_tokens = np.stack(out, axis=1)
    on_log(f"served batch={sc.batch} prompt={sc.prompt_len} "
           f"new={sc.max_new}: first row {gen_tokens[0][:8].tolist()}...")
    return {"tokens": gen_tokens, "tp_exec": tp_exec, "tp_schedule": sched,
            "self_check_err": err, "timings": timings, "config": cfg}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--local-ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke-size configuration")
    args = ap.parse_args()
    serve(ServeConfig(arch=args.arch, batch=args.batch,
                      max_new=args.max_new, local_ranks=args.local_ranks,
                      device=args.device), smoke=args.smoke)


if __name__ == "__main__":
    main()
