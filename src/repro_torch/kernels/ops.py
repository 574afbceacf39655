"""Wrappers of the port's CUDA kernels.

A wrapper validates its inputs, then dispatches on where they lie: a CPU
tensor goes to the plain version in `ref.py`; a CUDA tensor launches the
kernel (built on first use by `build.py`) on PyTorch's current stream, or
raises. A meta tensor (the dry run's, `launch.dryrun`) goes to the plain
version too, whose ops carry the shapes; the recurrences, whose plain
versions step token by token, make their outputs' shapes alone. Under
`launch.analysis.census` each wrapper reports its kernel's work from the
shapes (`_work_*`), whatever the device. There is no fallback from a
failed build or launch to the plain version. Each wrapper counts its
kernel launches in `LAUNCHES`; the plain path counts nothing. The
kernels have no backward yet: on the card a wrapper raises when grad
mode is on and an input requires grad (the CPU path stays
differentiable), rather than cut the gradients.

The recurrence kernels (`wkv`, `ssm_scan`) take f32 inputs that must be
contiguous on every device, and return new output and final-state
tensors. The model kernels (`rmsnorm`, `flash_attention`) take f32 or
bf16 inputs whose last dim is contiguous, read their leading dims
through strides (so head transposes need no copy), and write new
tensors in the input's dtype; their layout limits are checked on every
device, so the CPU tests hold the models to what the kernels take.

A reduce kernel, and the dequantize kernel, has two wrappers, both
counted under its name: the dense form (`fused_reduce`, `quant_reduce`,
`dequantize`: the TPU kernel's shape, the reduces plus a batch axis) and
the gathered form (`fused_reduce_into`, `quant_reduce_into`,
`dequantize_into`), which reads its operands through a `RowTable` and
writes its results into rows of an existing buffer — how the executor
folds or lands a whole phase with no copy around the launch. A
`RowTable` is checked on the host once, when built, so a launch need not
wait for the device to trust its indices. `grouped_reduce` and
`quant_reduce_requant` have the dense form only, the TPU kernels' shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.analysis import KernelWork, kernel as _census

from . import build, ref
from .ref import QUANT_TILE, WIRE_QMAX, wire_dtype

# kernel name → launches since the last `reset_launches()`
LAUNCHES = {"fused_reduce": 0, "grouped_reduce": 0, "quantize": 0,
            "dequantize": 0, "quant_reduce": 0, "quant_reduce_requant": 0,
            "wkv": 0, "ssm_scan": 0, "rmsnorm": 0, "flash_attention": 0}
# the flash_attention launches again, by the CUDA kernel the call ran:
# decode (Tq <= DECODE_MAX_TQ), bf16 prefill, f32 prefill
ATTENTION_LAUNCHES = {"flash_decode_kernel": 0, "flash_tc_kernel": 0,
                      "flash_tf32_kernel": 0}

# largest head width (K, V) of the wkv kernel and state width N of the
# ssm_scan kernel: the state lives in registers, at most 64 values a warp
# row (`wkv_layout`, `ssm_scan_layout`)
RECURRENCE_MAX_WIDTH = 64
# largest row of the rmsnorm kernel (held in registers, at most 64
# values a thread) and head dim of the flash_attention kernels (their
# template bound)
RMSNORM_MAX_WIDTH = 8192
ATTENTION_MAX_HEAD_DIM = 256
# decode attention (Tq <= DECODE_MAX_TQ) deals each (key head, batch row)'s
# keys in tiles (16 keys in bf16, 32 in f32) to `decode_splits` blocks of
# one thread-block cluster, each split at least DECODE_SPLIT_KEYS keys (a
# bf16 tile for each of a block's eight warps); DECODE_SMS is the card's
# SM count (H100 SXM) and DECODE_MAX_SPLITS the largest portable cluster
DECODE_MAX_TQ = 4
DECODE_SPLIT_KEYS = 128
DECODE_SMS = 132
DECODE_MAX_SPLITS = 8
# deepest tree of the grouped_reduce kernel: one f32 accumulator a level
# and the result, per lane, in registers
GROUPED_REDUCE_MAX_DEPTH = 7
# largest row count (grid y) of the dense dequantize kernel
DEQUANTIZE_MAX_ROWS = 65535
_FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# each wrapper's work from its shapes, for `launch.analysis.census`: the
# FLOPs and bytes of the kernel table's bound column (each input read
# once, each output written once; a reduce's adds count no FLOPs)
# ---------------------------------------------------------------------------
def _elem(t: torch.Tensor) -> int:
    return t.element_size()


def _work_fused_reduce(parts, *a, **k) -> KernelWork:
    x, L = parts.shape[-2], parts.shape[-1]
    batch = parts.numel() // max(x * L, 1)
    return KernelWork(0.0, (x + 1) * L * batch * _elem(parts))


def _work_grouped_reduce(parts, *a, **k) -> KernelWork:
    x, L = parts.shape
    return KernelWork(0.0, (x + 1) * L * _elem(parts))


def _table_bytes(table: "RowTable") -> int:
    return 8 * (table.rows.numel() + table.out_rows.numel()
                + table.own_rows.numel())


def _work_fused_reduce_into(src, table, out, *a, **k) -> KernelWork:
    L = src.shape[-1]
    return KernelWork(0.0, table.live * L * _elem(src)
                      + (table.own_live + table.out_rows.numel()) * L
                      * _elem(out) + _table_bytes(table))


def _work_quantize(x, wire="float8_e4m3fn", tile=QUANT_TILE) -> KernelWork:
    W, L = x.shape
    nt = -(-L // tile)
    return KernelWork(0.0, W * (4 * L + nt * tile + 4 * nt))


def _work_dequantize(q, scales, tile=QUANT_TILE, out_len=None
                     ) -> KernelWork:
    W, Lp = q.shape
    out_len = Lp if out_len is None else int(out_len)
    nt = scales.shape[-1]
    return KernelWork(0.0, W * (nt * tile + 4 * nt + 4 * out_len))


def _work_dequantize_into(q, scales, table, out, tile=QUANT_TILE
                          ) -> KernelWork:
    L = out.shape[-1]
    B = table.rows.shape[0]
    return KernelWork(0.0, table.live * (L + 4 * -(-L // tile))
                      + B * L * _elem(out) + 8 * (table.rows.numel() + B))


def _work_quant_reduce_requant(q, scales, wire=None, tile=QUANT_TILE
                               ) -> KernelWork:
    K, Lp = q.shape
    return KernelWork(0.0, (K + 1) * (Lp + 4 * (Lp // tile)))


def _work_quant_reduce(q, scales, own=None, tile=QUANT_TILE, out_len=None
                       ) -> KernelWork:
    K, Lp = q.shape[-2], q.shape[-1]
    batch = q.numel() // max(K * Lp, 1)
    own_len = 0 if own is None else own.shape[-1]
    return KernelWork(0.0, batch * (K * Lp + 4 * K * (Lp // tile)
                                    + 4 * own_len + 4 * Lp))


def _work_quant_reduce_into(q, scales, table, out, tile=QUANT_TILE
                            ) -> KernelWork:
    Lp, L = q.shape[-1], out.shape[-1]
    return KernelWork(0.0, table.live * (Lp + 4 * (Lp // tile))
                      + (table.own_live + table.out_rows.numel()) * L
                      * _elem(out) + _table_bytes(table))


def _work_wkv(r, k, v, logw, u, s0) -> KernelWork:
    B, H, T, K = r.shape
    V = v.shape[-1]
    return KernelWork(B * H * T * K * (7 * V + 1),
                      4 * (B * H * T * (3 * K + 2 * V) + H * K
                           + 2 * B * H * K * V))


def _work_ssm_scan(u, dt, b, c, log_a, s0) -> KernelWork:
    B, T, Di = u.shape
    N = b.shape[-1]
    return KernelWork(B * T * Di * (7 * N + 1),
                      4 * (3 * B * T * Di + 2 * B * T * N + Di * N
                           + 2 * B * Di * N))


def _work_rmsnorm(x, w, *a, **k) -> KernelWork:
    return KernelWork(4 * x.numel(), 2 * x.numel() * _elem(x)
                      + w.numel() * _elem(w))


def _sum_min(a: int, b: int, w: int) -> int:
    """Σ_{p=a}^{b} min(p + 1, w)."""
    total = 0
    top = min(b, w - 2)
    if top >= a:
        total += (a + 1 + top + 1) * (top - a + 1) // 2
    lo = max(a, w - 1)
    if b >= lo:
        total += w * (b - lo + 1)
    return total


def attention_pairs(Tq: int, Tk: int, causal: bool, window: int
                    ) -> tuple[int, int]:
    """(query-key pairs one batch row's Tq queries see, key rows some
    query of the row sees), from the shapes: the queries right-aligned to
    all Tk keys (query i at position Tk − Tq + i), masked causally and by
    the window, as the kernel masks them when no kv_len cuts the row."""
    p0, p1 = Tk - Tq, Tk - 1
    if causal:
        pairs = (_sum_min(p0, p1, window) if window > 0
                 else (p0 + 1 + p1 + 1) * Tq // 2)
    else:
        beyond = 0                     # Σ max(0, p − window + 1)
        if window > 0 and p1 >= window:
            a = max(p0, window)
            beyond = (a - window + 1 + p1 - window + 1) * (p1 - a + 1) // 2
        pairs = Tq * Tk - beyond
    lo = max(0, p0 - window + 1) if window > 0 else 0
    return pairs, Tk - lo


def _work_flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None, kv_len=None) -> KernelWork:
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    pairs, rows = attention_pairs(Tq, Tk, causal, window)
    return KernelWork(4 * Hq * D * pairs * B,
                      _elem(q) * (2 * B * Hq * Tq * D + 2 * B * rows * Hkv * D)
                      + (0 if kv_len is None else 8 * B))


def reset_launches() -> None:
    for counts in (LAUNCHES, ATTENTION_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _on_cuda(*tensors: torch.Tensor | None) -> bool:
    """True for CUDA tensors on one card, False for CPU ones and for meta
    ones (the dry run's, where the plain version carries the shapes);
    raises on a mix of devices (two cards included) or on any other
    device."""
    devices = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device; got {sorted(map(str, devices))}")


def _kernel_path(what: str, *tensors: torch.Tensor | None) -> bool:
    """`_on_cuda`, and on the card a refusal of inputs that need a
    gradient: the kernels write their outputs through raw pointers, so
    autograd would see no graph and silently cut the gradients that the
    plain version on the CPU carries."""
    if not _on_cuda(*tensors):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {what} kernel has no backward yet: call it under "
            f"torch.no_grad() or torch.inference_mode(), or on inputs "
            f"that do not require grad")
    return True


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError "
                           f"{err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@_census("fused_reduce", _work_fused_reduce)
def fused_reduce(parts: torch.Tensor) -> torch.Tensor:
    """(x, L) → (L,) or batched (B, x, L) → (B, L): the x operand rows
    summed in f32 and written in the input dtype (f32 or bf16)."""
    if parts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_reduce takes f32 or bf16, got {parts.dtype}")
    if parts.dim() not in (2, 3) or parts.shape[-2] < 1:
        raise ValueError(f"fused_reduce takes (x, L) or (B, x, L) with "
                         f"x >= 1; got {tuple(parts.shape)}")
    if not _kernel_path("fused_reduce", parts):
        return ref.fused_reduce_ref(parts)
    if not parts.is_contiguous():
        raise ValueError("fused_reduce needs a contiguous operand tensor")
    p3 = parts if parts.dim() == 3 else parts.unsqueeze(0)
    B, x, L = p3.shape
    out = torch.empty((B, L), dtype=parts.dtype, device=parts.device)
    if out.numel():
        _launch_fused_reduce(p3, None, x, None, out, None, B, L)
    return out if parts.dim() == 3 else out[0]


def _grouped_reduce_depth(x: int, fan_in: int) -> int:
    """Levels of the fan_in-ary tree that folds x operands to one."""
    depth = 0
    while x > 1:
        x = -(-x // fan_in)
        depth += 1
    return depth


@_census("grouped_reduce", _work_grouped_reduce)
def grouped_reduce(parts: torch.Tensor, fan_in: int) -> torch.Tensor:
    """(x, L) → (L,): the x operand rows summed in f32 as a tree of
    fan_in-ary adds (see `ref.grouped_reduce_ref`), written in the input
    dtype (f32 or bf16); fan_in >= 2, tree depth <=
    GROUPED_REDUCE_MAX_DEPTH on every device."""
    if parts.dtype not in _FLOATS:
        raise TypeError(f"grouped_reduce takes f32 or bf16, got "
                        f"{parts.dtype}")
    if parts.dim() != 2 or parts.shape[0] < 1 or fan_in < 2:
        raise ValueError(f"grouped_reduce takes (x, L) with x >= 1 and "
                         f"fan_in >= 2; got {tuple(parts.shape)}, fan_in "
                         f"{fan_in}")
    x, L = parts.shape
    depth = _grouped_reduce_depth(x, fan_in)
    if depth > GROUPED_REDUCE_MAX_DEPTH:
        raise ValueError(f"grouped_reduce folds at most "
                         f"{GROUPED_REDUCE_MAX_DEPTH} levels; x={x} at "
                         f"fan_in {fan_in} needs {depth}")
    if not _kernel_path("grouped_reduce", parts):
        return ref.grouped_reduce_ref(parts, fan_in)
    if not parts.is_contiguous():
        raise ValueError("grouped_reduce needs a contiguous operand tensor")
    out = torch.empty((L,), dtype=parts.dtype, device=parts.device)
    if L:
        lib = build.load("fused_reduce")
        fn = (lib.grouped_reduce_f32 if parts.dtype == torch.float32
              else lib.grouped_reduce_bf16)
        with torch.cuda.device(parts.device):
            _check(fn(parts.data_ptr(), out.data_ptr(), x, int(fan_in), L,
                      _stream(parts)), "grouped_reduce")
        LAUNCHES["grouped_reduce"] += 1
    return out


def _launch_fused_reduce(src, rows, x, own_rows, out, out_rows, B, L):
    lib = build.load("fused_reduce")
    fn = {(torch.float32, torch.float32): lib.fused_reduce_f32,
          (torch.bfloat16, torch.bfloat16): lib.fused_reduce_bf16,
          (torch.bfloat16, torch.float32): lib.fused_reduce_bf16_f32,
          }[(src.dtype, out.dtype)]
    with torch.cuda.device(src.device):
        _check(fn(src.data_ptr(), _ptr(rows), x,
                  None if own_rows is None else out.data_ptr(),
                  _ptr(own_rows), out.data_ptr(), _ptr(out_rows), B, L,
                  _stream(src)), "fused_reduce")
    LAUNCHES["fused_reduce"] += 1


@dataclass(frozen=True, eq=False)
class RowTable:
    """The row tables of one gathered reduce, checked on the host when
    built (`row_table`), so a launch trusts them with O(1) checks and no
    wait for the device: batch row b folds operand rows rows[b, :] (−1 =
    skipped) plus partial row own_rows[b] of out (−1 = none) into out row
    out_rows[b]; no two batch rows write the same out row. A launch needs
    at least `src_extent` operand rows and `out_extent` out rows."""
    rows: torch.Tensor           # (B, x) int64
    out_rows: torch.Tensor       # (B,) int64
    own_rows: torch.Tensor       # (B,) int64
    src_extent: int
    out_extent: int
    has_own: bool = False        # some batch row folds a partial
    live: int = 0                # operand rows that are not -1
    own_live: int = 0            # partial rows that are not -1


def row_table(rows, out_rows, own_rows=None, device=None) -> RowTable:
    """Check integer row tables (array-likes on the host) and place them
    on `device` (default the CPU): rows (B, x >= 1) with entries >= −1,
    out_rows (B,) distinct and >= 0, own_rows (B,) with entries >= −1
    (default all −1)."""
    rows = np.asarray(rows, dtype=np.int64)
    out_rows = np.asarray(out_rows, dtype=np.int64)
    own_rows = (np.full(out_rows.shape, -1, np.int64) if own_rows is None
                else np.asarray(own_rows, dtype=np.int64))
    if rows.ndim != 2 or rows.shape[1] < 1 \
            or out_rows.shape != rows.shape[:1] \
            or own_rows.shape != out_rows.shape:
        raise ValueError(f"row tables must be rows (B, x >= 1), out_rows "
                         f"(B,) and own_rows (B,); got {rows.shape}, "
                         f"{out_rows.shape}, {own_rows.shape}")
    if (rows < -1).any() or (own_rows < -1).any() or (out_rows < 0).any():
        raise ValueError("row indices must be >= 0 (−1 marks a skipped "
                         "operand or partial)")
    if np.unique(out_rows).size != out_rows.size:
        raise ValueError("two batch rows write the same out row")
    dev = torch.device("cpu" if device is None else device)
    return RowTable(
        *(torch.from_numpy(a).to(dev) for a in (rows, out_rows, own_rows)),
        src_extent=int(rows.max(initial=-1)) + 1,
        out_extent=int(max(out_rows.max(initial=-1),
                           own_rows.max(initial=-1))) + 1,
        has_own=bool((own_rows >= 0).any()), live=int((rows >= 0).sum()),
        own_live=int((own_rows >= 0).sum()))


def _check_table(table: RowTable, src: torch.Tensor, out: torch.Tensor,
                 what: str) -> None:
    if not isinstance(table, RowTable):
        raise TypeError(f"{what} takes a RowTable (see row_table); got "
                        f"{type(table).__name__}")
    if not table.rows.device == src.device == out.device:
        raise ValueError(f"{what}: tables on {table.rows.device}, operands "
                         f"on {src.device}, out on {out.device}")
    if src.shape[0] < table.src_extent or out.shape[0] < table.out_extent:
        raise ValueError(f"{what}: the tables name rows up to "
                         f"{table.src_extent - 1} of the operands and "
                         f"{table.out_extent - 1} of out; got "
                         f"{src.shape[0]} and {out.shape[0]} rows")


@_census("fused_reduce", _work_fused_reduce_into)
def fused_reduce_into(src: torch.Tensor, table: RowTable,
                      out: torch.Tensor) -> None:
    """Gathered fused reduce, in place, in one launch: for every batch
    row b, out[out_rows[b]] = Σ_k src[rows[b, k]] (+ out[own_rows[b]]),
    summed in f32 and written in out's dtype, with the rows of `table`.
    src (R, L) f32 or bf16; out (R', L) of src's dtype, or f32 for bf16
    operands."""
    if (src.dtype, out.dtype) not in ((torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.float32)):
        raise TypeError(f"fused_reduce_into takes f32 or bf16 operands "
                        f"into f32 or their own dtype; got {src.dtype} "
                        f"into {out.dtype}")
    if src.dim() != 2 or out.dim() != 2 or src.shape[1] != out.shape[1]:
        raise ValueError(f"src and out must be (rows, L) with one L; got "
                         f"{tuple(src.shape)} and {tuple(out.shape)}")
    _check_table(table, src, out, "fused_reduce_into")
    if not _kernel_path("fused_reduce", src, out):
        return ref.fused_reduce_into_ref(src, table.rows, out,
                                         table.out_rows, table.own_rows)
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("fused_reduce_into needs contiguous src and out")
    B, x = table.rows.shape
    if B and src.shape[1]:
        _launch_fused_reduce(src, table.rows, x, table.own_rows, out,
                             table.out_rows, B, src.shape[1])


@_census("quantize", _work_quantize)
def quantize(x: torch.Tensor, wire: str = "float8_e4m3fn",
             tile: int = QUANT_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, L) f32 → (q (W, Lp) wire dtype, scales (W, nt) f32): per-tile
    symmetric quantization, Lp = nt·tile."""
    wdt = wire_dtype(wire)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"quantize takes a 2-D f32 tensor; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not _kernel_path("quantize", x):
        return ref.quantize_ref(x, wire, tile)
    if tile != QUANT_TILE:
        raise ValueError(f"the CUDA quantize kernel tiles by {QUANT_TILE} "
                         f"lanes; got tile={tile}")
    if not x.is_contiguous():
        raise ValueError("quantize needs a contiguous input")
    W, L = x.shape
    nt = -(-L // tile)
    q = torch.empty((W, nt * tile), dtype=wdt, device=x.device)
    s = torch.empty((W, nt), dtype=torch.float32, device=x.device)
    if x.numel():
        lib = build.load("quant")
        fn = lib.quantize_fp8 if wire == "float8_e4m3fn" else lib.quantize_int8
        with torch.cuda.device(x.device):
            _check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), W, L, nt,
                      _stream(x)), "quantize")
        LAUNCHES["quantize"] += 1
    return q, s


def _check_wire(what: str, q: torch.Tensor, scales: torch.Tensor,
                tile: int) -> None:
    """q (R, Lp) fp8-e4m3/int8 tiled by `tile` lanes, scales (R, nt) f32."""
    if q.dtype not in (torch.float8_e4m3fn, torch.int8) \
            or scales.dtype != torch.float32:
        raise TypeError(f"{what} takes an fp8-e4m3 or int8 payload and f32 "
                        f"scales; got {q.dtype} and {scales.dtype}")
    if q.dim() != 2 or scales.dim() != 2 or q.shape[1] % tile \
            or scales.shape != (q.shape[0], q.shape[1] // tile):
        raise ValueError(f"{what} takes q (R, Lp) and scales (R, Lp/{tile}); "
                         f"got {tuple(q.shape)} and {tuple(scales.shape)}")


def _wire_name(dtype: torch.dtype) -> str:
    return "fp8" if dtype == torch.float8_e4m3fn else "int8"


def _kind(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


@_census("dequantize", _work_dequantize)
def dequantize(q: torch.Tensor, scales: torch.Tensor,
               tile: int = QUANT_TILE,
               out_len: int | None = None) -> torch.Tensor:
    """(W, Lp) wire + (W, nt) scales → (W, out_len or Lp) f32, a new
    tensor: each tile q·scale, a zero-scale tile exactly 0 whatever its
    payload bits."""
    _check_wire("dequantize", q, scales, tile)
    W, Lp = q.shape
    out_len = Lp if out_len is None else int(out_len)
    if not 0 < out_len <= Lp:
        raise ValueError(f"dequantize takes 0 < out_len <= {Lp}; got "
                         f"{out_len}")
    if not _kernel_path("dequantize", q, scales):
        return ref.dequantize_ref(q, scales, tile, out_len)
    if tile != QUANT_TILE or W > DEQUANTIZE_MAX_ROWS:
        raise ValueError(f"the CUDA dequantize kernel tiles by {QUANT_TILE} "
                         f"lanes and takes at most {DEQUANTIZE_MAX_ROWS} "
                         f"rows; got tile={tile}, {W} rows")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize needs contiguous q and scales")
    out = torch.empty((W, out_len), dtype=torch.float32, device=q.device)
    if W:
        _launch_dequantize(q, scales, None, out, None, W)
    return out


def _launch_dequantize(q, scales, rows, out, out_rows, B):
    lib = build.load("quant")
    fn = getattr(lib, f"dequantize_{_wire_name(q.dtype)}_{_kind(out.dtype)}")
    with torch.cuda.device(q.device):
        _check(fn(q.data_ptr(), scales.data_ptr(), _ptr(rows),
                  out.data_ptr(), _ptr(out_rows), out.shape[1], B,
                  q.shape[1], _stream(q)), "dequantize")
    LAUNCHES["dequantize"] += 1


@_census("dequantize", _work_dequantize_into)
def dequantize_into(q: torch.Tensor, scales: torch.Tensor, table: RowTable,
                    out: torch.Tensor, tile: int = QUANT_TILE) -> None:
    """Gathered dequantize, in place, in one launch: for every batch row
    b, out[out_rows[b]] = decode(q, scales)[rows[b, 0]] (−1 = zeros) cut to
    out's row length L <= Lp, written in out's dtype (f32 or bf16). The
    table has one operand a row and no partial. q (R, Lp) fp8-e4m3/int8,
    scales (R, nt) f32."""
    _check_wire("dequantize_into", q, scales, tile)
    if out.dtype not in _FLOATS:
        raise TypeError(f"dequantize_into writes f32 or bf16; got "
                        f"{out.dtype}")
    if out.dim() != 2 or not 0 < out.shape[1] <= q.shape[1]:
        raise ValueError(f"dequantize_into takes out (R', L <= "
                         f"{q.shape[1]}); got {tuple(out.shape)}")
    _check_table(table, q, out, "dequantize_into")
    if table.rows.shape[1] != 1 or table.has_own:
        raise ValueError(f"dequantize_into takes one operand a row and no "
                         f"partial; got rows {tuple(table.rows.shape)}, "
                         f"partial {table.has_own}")
    if not _kernel_path("dequantize", q, scales, out):
        return ref.dequantize_into_ref(q, scales, table.rows, out,
                                       table.out_rows, tile)
    if tile != QUANT_TILE:
        raise ValueError(f"the CUDA dequantize kernel tiles by {QUANT_TILE} "
                         f"lanes; got tile={tile}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("dequantize_into needs contiguous q, scales and "
                         "out")
    B = table.rows.shape[0]
    if B:
        _launch_dequantize(q, scales, table.rows, out, table.out_rows, B)


@_census("quant_reduce_requant",
         _work_quant_reduce_requant)
def quant_reduce_requant(q: torch.Tensor, scales: torch.Tensor,
                         wire: str | None = None, tile: int = QUANT_TILE
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed reduce that stays on the wire: (K, Lp) wire + (K, nt)
    scales → (q (Lp,) `wire`, default the operands' wire; scales (nt,)
    f32), equal byte for byte to `quantize(quant_reduce(q, scales))`."""
    _check_wire("quant_reduce_requant", q, scales, tile)
    K, Lp = q.shape
    if wire is None:
        wire = {v: k for k, v in ref.WIRE_DTYPES.items()}[q.dtype]
    wdt = wire_dtype(wire)
    if K < 1:
        raise ValueError("quant_reduce_requant takes K >= 1 operand rows")
    if not _kernel_path("quant_reduce_requant", q, scales):
        return ref.quant_reduce_requant_ref(q, scales, wire, tile)
    if tile != QUANT_TILE:
        raise ValueError(f"the CUDA quant_reduce_requant kernel tiles by "
                         f"{QUANT_TILE} lanes; got tile={tile}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quant_reduce_requant needs contiguous inputs")
    nt = Lp // tile
    q_out = torch.empty((Lp,), dtype=wdt, device=q.device)
    s_out = torch.empty((nt,), dtype=torch.float32, device=q.device)
    if Lp:
        lib = build.load("quant")
        fn = getattr(lib, f"quant_reduce_requant_{_wire_name(q.dtype)}_"
                          f"{_wire_name(wdt)}")
        with torch.cuda.device(q.device):
            _check(fn(q.data_ptr(), scales.data_ptr(), K, q_out.data_ptr(),
                      s_out.data_ptr(), Lp, _stream(q)),
                   "quant_reduce_requant")
        LAUNCHES["quant_reduce_requant"] += 1
    return q_out, s_out


@_census("quant_reduce", _work_quant_reduce)
def quant_reduce(q: torch.Tensor, scales: torch.Tensor,
                 own: torch.Tensor | None = None, tile: int = QUANT_TILE,
                 out_len: int | None = None) -> torch.Tensor:
    """Fused compressed reduce: (K, Lp) wire + (K, nt) scales [+ own
    (L_own,) f32] → (out_len or Lp,) f32, or the same with a leading batch
    axis B on every argument and the result."""
    if q.dtype not in (torch.float8_e4m3fn, torch.int8):
        raise TypeError(f"quant_reduce takes an fp8-e4m3 or int8 payload; "
                        f"got {q.dtype}")
    if q.dim() not in (2, 3) or q.shape[-2] < 1 \
            or scales.dim() != q.dim() or scales.dtype != torch.float32:
        raise ValueError(f"quant_reduce takes (K, Lp) / (B, K, Lp) payloads "
                         f"with K >= 1 and f32 scales; got {tuple(q.shape)} "
                         f"and {scales.dtype} {tuple(scales.shape)}")
    if q.shape[-1] % tile or scales.shape != q.shape[:-1] + (
            q.shape[-1] // tile,):
        raise ValueError(f"scales {tuple(scales.shape)} do not tile payload "
                         f"{tuple(q.shape)} by {tile} lanes")
    if own is not None and (own.dtype != torch.float32
                            or own.dim() != q.dim() - 1
                            or own.shape[:-1] != q.shape[:-2]
                            or own.shape[-1] > q.shape[-1]):
        raise ValueError(f"own must be f32 of shape (..., <= Lp) matching "
                         f"the payload batch; got {own.dtype} "
                         f"{tuple(own.shape)}")
    if not _kernel_path("quant_reduce", q, scales, own):
        return ref.quant_reduce_ref(q, scales, own, tile, out_len)
    if tile != QUANT_TILE:
        raise ValueError(f"the CUDA quant_reduce kernel tiles by "
                         f"{QUANT_TILE} lanes; got tile={tile}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and (own is None or own.is_contiguous())):
        raise ValueError("quant_reduce needs contiguous inputs")
    batched = q.dim() == 3
    q3 = q if batched else q.unsqueeze(0)
    B, K, Lp = q3.shape
    out = torch.empty((B, Lp), dtype=torch.float32, device=q.device)
    if out.numel():
        _launch_quant_reduce(q3, scales, None, K, own, None,
                             0 if own is None else own.shape[-1], out, None,
                             B)
    if out_len is not None and out_len != Lp:
        out = out[:, :out_len]
    return out if batched else out[0]


def _launch_quant_reduce(q, scales, rows, K, own, own_rows, own_len, out,
                         out_rows, B):
    lib = build.load("quant")
    fn = getattr(lib, f"quant_reduce_{_wire_name(q.dtype)}_{_kind(out.dtype)}")
    with torch.cuda.device(q.device):
        _check(fn(q.data_ptr(), scales.data_ptr(), _ptr(rows), K, _ptr(own),
                  _ptr(own_rows), own_len, out.data_ptr(), _ptr(out_rows),
                  out.shape[-1], B, q.shape[-1], _stream(q)),
               "quant_reduce")
    LAUNCHES["quant_reduce"] += 1


@_census("quant_reduce", _work_quant_reduce_into)
def quant_reduce_into(q: torch.Tensor, scales: torch.Tensor,
                      table: RowTable, out: torch.Tensor,
                      tile: int = QUANT_TILE) -> None:
    """Gathered fused compressed reduce, in place, in one launch: for
    every batch row b, out[out_rows[b]] = Σ_k decode(q, scales)[rows[b, k]]
    cut to out's row length L <= Lp (+ out[own_rows[b]]), summed in f32
    and written in out's dtype (f32 or bf16), with the rows of `table`.
    q (R, Lp) fp8-e4m3/int8, scales (R, nt) f32."""
    if q.dtype not in (torch.float8_e4m3fn, torch.int8) \
            or scales.dtype != torch.float32 \
            or out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_reduce_into takes an fp8-e4m3 or int8 "
                        f"payload, f32 scales and an f32 or bf16 out; got "
                        f"{q.dtype}, {scales.dtype}, {out.dtype}")
    if q.dim() != 2 or scales.dim() != 2 or out.dim() != 2 \
            or q.shape[1] % tile or scales.shape != (q.shape[0],
                                                     q.shape[1] // tile) \
            or not 0 < out.shape[1] <= q.shape[1]:
        raise ValueError(f"quant_reduce_into takes q (R, Lp), scales "
                         f"(R, Lp/{tile}) and out (R', L <= Lp); got "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}, "
                         f"{tuple(out.shape)}")
    _check_table(table, q, out, "quant_reduce_into")
    if not _kernel_path("quant_reduce", q, scales, out):
        return ref.quant_reduce_into_ref(q, scales, table.rows, out,
                                         table.out_rows, table.own_rows,
                                         tile)
    if tile != QUANT_TILE:
        raise ValueError(f"the CUDA quant_reduce kernel tiles by "
                         f"{QUANT_TILE} lanes; got tile={tile}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("quant_reduce_into needs contiguous q, scales "
                         "and out")
    B, K = table.rows.shape
    if B:
        _launch_quant_reduce(q, scales, table.rows, K, out, table.own_rows,
                             out.shape[1], out, table.out_rows, B)


def _check_recurrence(what: str, tensors: dict[str, torch.Tensor],
                      shapes: dict[str, tuple[int, ...]]) -> bool:
    """Validate the f32 inputs of a recurrence kernel against their
    expected shapes; returns whether they lie on a CUDA device (raising
    there for inputs that need a gradient, `_kernel_path`). Every
    input must be contiguous on every device, so the CPU tests hold
    callers to what the kernel takes."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes f32 inputs; {name} is {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous inputs; {name} is not")
    return _kernel_path(what, *tensors.values())


def wkv_layout(B: int, H: int, K: int, V: int) -> tuple[int, int]:
    """(lanes, warps) of the wkv kernel. `lanes` lanes of a warp split a
    (b, h)'s K rows, 4 a lane: the fewest of 4, 8, 16 that cover K. A
    warp holds 128 / lanes of its V columns, 4 a lane, and a block
    `warps` of its warps, so a (b, h)'s columns span ceil(V / (warps ·
    128 / lanes)) blocks: the most whose B·H·splits blocks still fit the
    DECODE_SMS SMs at one a block (a (b, h) in one block where they do
    not: each block stages the whole of its r, k and logw), at most one
    a warp. From the shapes alone."""
    lanes = 4 if K <= 16 else 8 if K <= 32 else 16
    need = -(-V // (128 // lanes))                 # warps a (b, h)
    splits = max(1, min(need, DECODE_SMS // (B * H)))
    return lanes, -(-need // splits)


def ssm_scan_layout(B: int, Di: int, N: int) -> tuple[int, int]:
    """(lanes, channels) of the ssm_scan kernel. `lanes` neighbouring
    lanes share a channel's N states, 4 a lane: the fewest of 1, 2, 4, 8,
    16 that cover N. A block holds `channels` channels of one batch row:
    128 / lanes (128 threads), halved while its B·ceil(Di / channels)
    blocks are fewer than two an SM (DECODE_SMS), down to 8 channels or
    a warp. From the shapes alone."""
    lanes = next(n for n in (1, 2, 4, 8, 16) if 4 * n >= N)
    channels = 128 // lanes
    while (channels > max(8, 32 // lanes)
           and B * -(-Di // channels) < 2 * DECODE_SMS):
        channels //= 2
    return lanes, channels


@_census("wkv", _work_wkv)
def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 WKV recurrence (the reference's `kernels/wkv.py`): r/k/logw
    (B, H, T, K), v (B, H, T, V), u (H, K), s0 (B, H, K, V), all f32 and
    contiguous, T >= 1, K and V <= 64 → (out (B, H, T, V), final state
    (B, H, K, V)), both new tensors."""
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"wkv takes (B, H, T, K) and (B, H, T, V) inputs; "
                         f"got {tuple(r.shape)} and {tuple(v.shape)}")
    B, H, T, K = r.shape
    V = v.shape[-1]
    if T < 1 or not 1 <= K <= RECURRENCE_MAX_WIDTH \
            or not 1 <= V <= RECURRENCE_MAX_WIDTH:
        raise ValueError(f"wkv takes T >= 1 and 1 <= K, V <= "
                         f"{RECURRENCE_MAX_WIDTH}; got T={T}, K={K}, V={V}")
    cuda = _check_recurrence(
        "wkv", dict(r=r, k=k, v=v, logw=logw, u=u, s0=s0),
        dict(r=(B, H, T, K), k=(B, H, T, K), v=(B, H, T, V),
             logw=(B, H, T, K), u=(H, K), s0=(B, H, K, V)))
    if r.is_meta:                     # the dry run's: shapes alone
        return (r.new_empty((B, H, T, V)), r.new_empty((B, H, K, V)))
    if not cuda:
        return ref.wkv_ref(r, k, v, logw, u, s0)
    lib = build.load("wkv")
    out = torch.empty((B, H, T, V), dtype=torch.float32, device=r.device)
    s_fin = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lanes, warps = wkv_layout(B, H, K, V)
    with torch.cuda.device(r.device):
        _check(lib.wkv_f32(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                           out.data_ptr(), s_fin.data_ptr(), B, H, T, K, V,
                           lanes, warps, _stream(r)), "wkv")
    LAUNCHES["wkv"] += 1
    return out, s_fin


@_census("ssm_scan", _work_ssm_scan)
def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, log_a: torch.Tensor, s0: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-SSM scan (the reference's `kernels/ssm_scan.py`): u/dt
    (B, T, Di), b/c (B, T, N), log_a (Di, N), s0 (B, Di, N), all f32 and
    contiguous, T >= 1, N <= 64 → (y (B, T, Di), final state (B, Di, N)),
    both new tensors."""
    if u.dim() != 3 or b.dim() != 3:
        raise ValueError(f"ssm_scan takes (B, T, Di) and (B, T, N) inputs; "
                         f"got {tuple(u.shape)} and {tuple(b.shape)}")
    B, T, Di = u.shape
    N = b.shape[-1]
    if T < 1 or Di < 1 or not 1 <= N <= RECURRENCE_MAX_WIDTH:
        raise ValueError(f"ssm_scan takes T, Di >= 1 and 1 <= N <= "
                         f"{RECURRENCE_MAX_WIDTH}; got T={T}, Di={Di}, "
                         f"N={N}")
    cuda = _check_recurrence(
        "ssm_scan", dict(u=u, dt=dt, b=b, c=c, log_a=log_a, s0=s0),
        dict(u=(B, T, Di), dt=(B, T, Di), b=(B, T, N), c=(B, T, N),
             log_a=(Di, N), s0=(B, Di, N)))
    if u.is_meta:                     # the dry run's: shapes alone
        return (u.new_empty((B, T, Di)), u.new_empty((B, Di, N)))
    if not cuda:
        return ref.ssm_scan_ref(u, dt, b, c, log_a, s0)
    lib = build.load("ssm_scan")
    y = torch.empty((B, T, Di), dtype=torch.float32, device=u.device)
    s_fin = torch.empty((B, Di, N), dtype=torch.float32, device=u.device)
    lanes, channels = ssm_scan_layout(B, Di, N)
    with torch.cuda.device(u.device):
        _check(lib.ssm_scan_f32(u.data_ptr(), dt.data_ptr(), b.data_ptr(),
                                c.data_ptr(), log_a.data_ptr(),
                                s0.data_ptr(), y.data_ptr(),
                                s_fin.data_ptr(), B, T, Di, N, lanes,
                                channels, _stream(u)), "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return y, s_fin


def _row_layout(x: torch.Tensor) -> list[tuple[int, int]]:
    """The rows of x (..., D) as three (count, stride) leading dims, outer
    first: dims of size 1 dropped, a dim merged into the one before it
    where that one strides exactly over it, padded with (1, 0). Raises if
    the last dim is not contiguous or more than three dims remain."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"the last dim must be contiguous; strides "
                         f"{x.stride()}")
    dims: list[tuple[int, int]] = []
    for n, st in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == st * n:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 3:
        raise ValueError(f"rows must be strided in at most three leading "
                         f"dims; got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    return [(1, 0)] * (3 - len(dims)) + dims


@_census("rmsnorm", _work_rmsnorm)
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            offset: float = 0.0) -> torch.Tensor:
    """x (..., D) · rsqrt(mean x² + eps) · (offset + w), in f32, as a new
    contiguous tensor of x's shape and dtype: offset 0 is the reference
    kernel (scale by w), offset 1 the models' norm (scale by 1 + w). x
    and w f32 or bf16, w (D,), D <= RMSNORM_MAX_WIDTH."""
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise TypeError(f"rmsnorm takes f32 or bf16 x and w; got {x.dtype} "
                        f"and {w.dtype}")
    D = x.shape[-1] if x.dim() else 0
    if w.shape != (D,) or not 1 <= D <= RMSNORM_MAX_WIDTH:
        raise ValueError(f"rmsnorm takes x (..., D) and w (D,) with 1 <= D "
                         f"<= {RMSNORM_MAX_WIDTH}; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    (n0, s0), (n1, s1), (n2, s2) = _row_layout(x)
    if not _kernel_path("rmsnorm", x, w):
        return ref.rmsnorm(x, w, eps, offset)
    if not w.is_contiguous():
        raise ValueError("rmsnorm needs a contiguous w")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel():
        lib = build.load("rmsnorm")
        kind = {torch.float32: "f32", torch.bfloat16: "bf16"}
        fn = getattr(lib, f"rmsnorm_{kind[x.dtype]}_{kind[w.dtype]}")
        with torch.cuda.device(x.device):
            _check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n0, n1, n2,
                      s0, s1, s2, D, eps, offset, _stream(x)), "rmsnorm")
        LAUNCHES["rmsnorm"] += 1
    return y


def decode_splits(B: int, Hkv: int, Tk: int) -> int:
    """Blocks that share a (key head, batch row)'s keys at decode: the
    most whose splits × Hkv × B blocks still fit the DECODE_SMS SMs at
    one a block (all run at once: a second wave would double the time),
    no more than give each split DECODE_SPLIT_KEYS of the Tk keys (a key
    tile for every warp), at most DECODE_MAX_SPLITS, at least 1. From
    the shapes alone, so the host never waits on the device's kv_len."""
    fit = DECODE_SMS // (B * Hkv)
    return max(1, min(fit, Tk // DECODE_SPLIT_KEYS, DECODE_MAX_SPLITS))


@_census("flash_attention", _work_flash_attention)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """GQA attention (the reference's `kernels/flash_attention.py`, see
    `ref.flash_attention` for the function): q (B, Hq, Tq, D), k/v
    (B, Hkv, Tk, D), one dtype (f32 or bf16), each with a contiguous last
    dim and any strides in the others; Hq % Hkv == 0, 1 <= Tq <= Tk,
    D <= ATTENTION_MAX_HEAD_DIM; kv_len None or (B,) int64 visible-key
    counts on the inputs' device (read by the kernel, so no host sync).
    Returns (B, Hq, Tq, D) in q's dtype, a view of a new (B, Tq, Hq, D)
    tensor."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _FLOATS:
            raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of "
                            f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             f"contiguous last dim; got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D \
            or Hkv < 1 or Hq % Hkv or not 1 <= Tq <= Tk \
            or not 1 <= D <= ATTENTION_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes q (B, Hq, Tq, D), k/v "
                         f"(B, Hkv, Tk, D) with Hq % Hkv == 0, 1 <= Tq <= "
                         f"Tk and D <= {ATTENTION_MAX_HEAD_DIM}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window and softcap must be >= 0; got {window}, "
                         f"{softcap}")
    if kv_len is not None and (kv_len.dtype != torch.int64
                               or kv_len.shape != (B,)
                               or not kv_len.is_contiguous()):
        raise ValueError(f"kv_len must be a contiguous (B,) int64 tensor; "
                         f"got {kv_len.dtype} {tuple(kv_len.shape)}")
    scale = D ** -0.5 if scale is None else float(scale)
    if not _kernel_path("flash_attention", q, k, v, kv_len):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   kv_len=kv_len)
    if B > 65535 or Hq > 65535:
        raise ValueError(f"the flash_attention kernel's grid takes B and Hq "
                         f"<= 65535; got {B} and {Hq}")
    splits = decode_splits(B, Hkv, Tk) if Tq <= DECODE_MAX_TQ else 1
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _ptr(kv_len), B, Hq, Hkv, Tq, Tk, D, *q.stride()[:3],
                  *k.stride()[:3], *v.stride()[:3], scale, float(softcap),
                  int(causal), int(window), splits, _stream(q)),
               "flash_attention")
    LAUNCHES["flash_attention"] += 1
    ATTENTION_LAUNCHES["flash_decode_kernel" if Tq <= DECODE_MAX_TQ
                       else "flash_tc_kernel" if q.dtype == torch.bfloat16
                       else "flash_tf32_kernel"] += 1
    return out.transpose(1, 2)


__all__ = ["ATTENTION_LAUNCHES", "ATTENTION_MAX_HEAD_DIM", "DECODE_MAX_SPLITS",
           "DECODE_MAX_TQ", "DECODE_SMS", "DECODE_SPLIT_KEYS",
           "DEQUANTIZE_MAX_ROWS", "GROUPED_REDUCE_MAX_DEPTH", "LAUNCHES",
           "QUANT_TILE", "RECURRENCE_MAX_WIDTH", "RMSNORM_MAX_WIDTH",
           "WIRE_QMAX", "RowTable", "decode_splits", "dequantize",
           "dequantize_into", "flash_attention", "fused_reduce",
           "fused_reduce_into", "grouped_reduce", "quant_reduce",
           "quant_reduce_into", "quant_reduce_requant", "quantize",
           "reset_launches", "rmsnorm", "row_table", "ssm_scan", "wkv"]
