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
server. Every ported family serves the same way: the dense transformer
(stablelm-12b; gemma2-27b with alternating local and global layers and
soft-capped logits; qwen3-32b with qk_norm; gemma3-4b with five local
layers to one global), the MoE transformer (deepseek-moe-16b, the sorted
dispatch; mixtral-8x22b, 8 experts top 2 and a 4096 window on every
layer), the vision-language transformer (qwen2-vl-7b: the prompt is
embeddings from a stubbed vision frontend with M-RoPE's t/h/w position
streams, a decode step the embedding rows of its token), RWKV6
(rwkv6-1.6b, whose decode state is its recurrent state), the Hymba
hybrid (hymba-1.5b, a KV cache plus SSM states) and the encoder-decoder
(whisper-large-v3: 32 frames of stub audio embeddings beside the
prompt). The prompt batches are the reference server's
(`prompt_batch`).

    python -m repro_torch.launch.serve --arch rwkv6-1.6b
    python -m repro_torch.launch.serve --arch mixtral-8x22b --n-layers 14

builds the full-size model with random weights on the card; `--n-layers`
cuts its (decoder) depth, as mixtral-8x22b's 56 layers need on one card;
`--smoke` shrinks it, `--device cpu` runs on the CPU.

    python -m repro_torch.launch.serve --smoke --device cpu --nproc 4 \
        --backend gloo

runs the decode AllReduce's self-check with one process a rank (a
process mesh over the axis "model", `launch.mesh`), every rank checking
its row of the planned schedule against the plain sum; rank 0 then
serves. `--backend nccl` (the default) needs a card a rank.
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
    # port-only: the configuration's (decoder) layers cut to this many
    # (`dataclasses.replace`, as `TrainConfig.n_layers`); None keeps them
    n_layers: int | None = None


AUDIO_FRAMES = 32    # the reference server's frames of stub audio
# the CLI's process mesh: the seconds its processes may run (and a
# collective may wait) before they are killed
CLI_MESH_TIMEOUT_S = 3600.0


def prompt_batch(cfg, batch: int, prompt_len: int, gen: torch.Generator
                 ) -> dict:
    """A prompt batch as the reference's `serve` builds it, drawn from
    `gen` (on the serving device): (batch, prompt_len) token ids; for the
    vlm family instead N(0, 1) embeddings (batch, prompt_len, d_model) in
    bf16 and three equal `arange(prompt_len)` M-RoPE position streams;
    for the audio family AUDIO_FRAMES N(0, 1) frame embeddings in bf16
    beside the tokens."""
    dev = gen.device
    if cfg.family == "vlm":
        pos = torch.arange(prompt_len, device=dev)
        return {"embeds": torch.randn((batch, prompt_len, cfg.d_model),
                                      generator=gen, device=dev).to(
                                          torch.bfloat16),
                "mrope_positions": pos.expand(3, batch, prompt_len)}
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
    if cfg.family == "audio":
        return {"tokens": tokens,
                "frames": torch.randn((batch, AUDIO_FRAMES, cfg.d_model),
                                      generator=gen, device=dev).to(
                                          torch.bfloat16)}
    return {"tokens": tokens}


def step_batch(cfg, params: dict, tok: torch.Tensor) -> dict:
    """A decode step's batch of the (B,) tokens just chosen: their ids,
    or for the vlm family their embedding rows (B, 1, d_model), as the
    reference's server feeds them (no M-RoPE streams)."""
    if cfg.family == "vlm":
        return {"embeds": params["embed"][tok[:, None]]}
    return {"tokens": tok[:, None]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(sc: ServeConfig, smoke: bool = False, on_log=print,
          mesh=None) -> dict:
    """Serve one batch of prompts; returns the generated tokens, the
    decode plan and its guarded schedule, the self-check's relative error
    and host-clock timings (each ending in a device synchronize).

    With `mesh` a `core.transport.ProcessMesh` (one process a rank, axis
    "model"; the CLI's `--nproc N`) every rank prices, lowers and guards
    the same decode plan, draws the same seeded probe and runs its own
    row through the schedule's process-mesh `allreduce`, checks it
    against the plain column sum and times it (the slowest rank's
    median, observed alike on every rank: as `source="host_staged"`
    over gloo, never fitted). Then rank 0 alone builds the model and
    serves, as the reference's single-host decode loop does; the other
    ranks return after the self-check (their "tokens" None)."""
    from repro_torch.core.transport import is_process_mesh
    pm = mesh if is_process_mesh(mesh) else None
    dev = pm.device if pm is not None else resolve_device(sc.device)
    cfg = get_config(sc.arch)
    if smoke:
        cfg = smoke_config(cfg)
    if sc.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(sc.n_layers))
    api = build(cfg)
    timings: dict[str, float] = {}

    from repro_torch.core.lower import guard_schedule
    from repro_torch.planner.service import default_service
    n = int(sc.local_ranks) if pm is None else pm.axis_size("model")
    size = sc.batch * cfg.d_model
    tp_exec = sched = None
    err = None
    if n > 1:
        svc = default_service()
        tp_exec = svc.get_axis_executable("model", n, float(size))
        # guarded execution (DESIGN.md §12); `sched.demotions` tells the
        # caller whether the planned schedule ever gave way
        sched = guard_schedule(tp_exec.schedule, telemetry=svc.telemetry)
        where = (f"{n} local ranks ({dev})" if pm is None else
                 f"{n} processes ({pm.transport}, {dev})")
        on_log(f"planner: decode AllReduce executes {tp_exec.algo} plan "
               f"({sched.describe()}) on {where}")
        gen = torch.Generator(device=dev).manual_seed(2)
        probe = torch.randn((n, size), generator=gen, device=dev)
        if pm is None:
            def run():
                return sched.run_local(probe)
        else:
            row = probe[pm.index("model")].clone()

            def run():
                return sched.allreduce(row, "model", pm)
        with default_tracer().span("serve/self_check", n=n,
                                   algo=tp_exec.algo):
            got = run()
            _sync(dev)
        want = probe.double().sum(dim=0)
        err = float((got.double() - want).abs().max()
                    / (want.abs().max() + 1e-30))
        on_log(f"planner: executed-schedule self-check rel err {err:.2e}")
        if not err < 1e-5:
            raise RuntimeError(f"executed TP schedule disagrees with the "
                               f"plain sum: rel err {err:.2e}")
        # time the executed plan and feed it to the planner's online loop
        measured = _time_schedule(run, dev, pm)
        timings["allreduce_s"] = measured
        # no predicted= override: observe re-prices at the exact executed
        # size, so the residual carries no cache-bucket bias. On the local
        # mesh the time is one device's rounds and launches, over gloo
        # the host's staging, not a switch's links: either is monitored
        # only and never refits the root_sw params.
        source = ("local_mesh" if pm is None else
                  "host_staged" if pm.backend == "gloo" else "mesh")
        obs = svc.observe("root_sw", n, float(size), measured,
                          key=tp_exec.key, source=source)
        on_log(f"planner: observed decode plan {measured * 1e3:.3f} ms "
               f"(predicted {obs['predicted'] * 1e3:.3f} ms, drift "
               f"{obs['drift']:.2f}" + (", refit" if obs["refit"] else "")
               + f"; {source})")
    else:
        on_log("planner: single rank, no decode collective needed")
    if pm is not None and pm.rank != 0:
        return {"tokens": None, "tp_exec": tp_exec, "tp_schedule": sched,
                "self_check_err": err, "timings": timings, "config": cfg}

    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, torch.bfloat16, dev)
    _sync(dev)
    timings["init_s"] = time.perf_counter() - t0
    pgen = torch.Generator(device=dev).manual_seed(sc.seed + 1)
    prompts = prompt_batch(cfg, sc.batch, sc.prompt_len, pgen)

    tracer = default_tracer()
    metrics = default_metrics()
    with torch.inference_mode():
        t0 = time.perf_counter()
        with tracer.span("serve/prefill", batch=sc.batch,
                         prompt_len=sc.prompt_len):
            logits, cache = api.prefill(params, prompts, sc.cache_len)
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
                logits, cache = api.decode_step(
                    params, cache, step_batch(cfg, params, tok))
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


def _time_schedule(run, dev: torch.device, pm, repeats: int = 3) -> float:
    """The median host time of `repeats` runs of `run`, each to a device
    synchronize; on a process mesh each run started together (a small
    exchange over the mesh) and the slowest rank's median taken, the
    same on every rank."""
    from repro_torch.core.transport import all_gather_rows
    everyone = pm.line(pm.axis_names) if pm is not None else None
    ts = []
    for _ in range(repeats):
        if everyone is not None:
            all_gather_rows(pm, everyone, torch.zeros(1, device=dev))
        t0 = time.perf_counter()
        run()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    mine = sorted(ts)[len(ts) // 2]
    if everyone is None:
        return mine
    return float(all_gather_rows(pm, everyone, torch.tensor(
        mine, dtype=torch.float64, device=dev)).max())


def _serve_rank(mesh, sc: ServeConfig, smoke: bool) -> dict:
    """One rank of `main`'s process mesh: `serve` on it, rank 0 logging;
    returns its tokens (rank 0's; None elsewhere) and its self-check's
    error and timings."""
    out = serve(sc, smoke=smoke, mesh=mesh,
                on_log=(lambda m: print(m, flush=True)) if mesh.rank == 0
                else (lambda _m: None))
    return {"tokens": out["tokens"], "self_check_err": out["self_check_err"],
            "timings": out["timings"]}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b",
                    help="stablelm-12b, gemma2-27b, qwen3-32b, gemma3-4b, "
                    "deepseek-moe-16b, mixtral-8x22b, qwen2-vl-7b, "
                    "rwkv6-1.6b, hymba-1.5b or whisper-large-v3")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--local-ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke-size configuration")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the (decoder) depth to this many layers, "
                    "e.g. 14 of mixtral-8x22b's 56 on one card")
    ap.add_argument("--nproc", type=int, default=None,
                    help="run the decode AllReduce's self-check with one "
                    "process a rank over this many ranks (a process mesh, "
                    "axis 'model'); rank 0 serves")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the process mesh's backend: nccl (one card a "
                    "rank), or gloo (on the CPU, or every rank on one "
                    "card, its rounds staged through the host)")
    args = ap.parse_args()
    sc = ServeConfig(arch=args.arch, batch=args.batch, max_new=args.max_new,
                     local_ranks=args.local_ranks, device=args.device,
                     n_layers=args.n_layers)
    if args.nproc is None:
        serve(sc, smoke=args.smoke)
        return
    from repro_torch.launch.mesh import launch
    print(f"process mesh: {args.nproc} processes, backend {args.backend}, "
          f"device {args.device}", flush=True)
    ranks = launch(_serve_rank, [("model", args.nproc)],
                   backend=args.backend, device=args.device,
                   timeout_s=CLI_MESH_TIMEOUT_S, args=(sc, args.smoke))
    print("self-check rel err by rank: "
          + ", ".join(f"{r['self_check_err']:.2e}" for r in ranks))


if __name__ == "__main__":
    main()
