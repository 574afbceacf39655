"""Wrappers of the port's CUDA kernels.

A wrapper validates its inputs, then dispatches on where they lie: a CPU
tensor goes to the plain version in `ref.py`; a CUDA tensor launches the
kernel (built on first use by `build.py`) on PyTorch's current stream, or
raises. There is no fallback from a failed build or launch to the plain
version. Each wrapper counts its kernel launches in `LAUNCHES`; the plain
path counts nothing.

A reduce kernel has two wrappers, both counted under its name: the dense
form (`fused_reduce`, `quant_reduce`: the TPU kernel's shape, plus a
batch axis) and the gathered form (`fused_reduce_into`,
`quant_reduce_into`), which reads its operands through a `RowTable` and
writes its results into rows of an existing buffer — how the executor
folds a whole phase with no copy around the launch. A `RowTable` is
checked on the host once, when built, so a launch need not wait for the
device to trust its indices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import build, ref
from .ref import QUANT_TILE, WIRE_QMAX, wire_dtype

# kernel name → launches since the last `reset_launches()`
LAUNCHES = {"fused_reduce": 0, "quantize": 0, "quant_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor | None) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device; got {sorted(kinds)}")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError "
                           f"{err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fused_reduce(parts: torch.Tensor) -> torch.Tensor:
    """(x, L) → (L,) or batched (B, x, L) → (B, L): the x operand rows
    summed in f32 and written in the input dtype (f32 or bf16)."""
    if parts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_reduce takes f32 or bf16, got {parts.dtype}")
    if parts.dim() not in (2, 3) or parts.shape[-2] < 1:
        raise ValueError(f"fused_reduce takes (x, L) or (B, x, L) with "
                         f"x >= 1; got {tuple(parts.shape)}")
    if not _on_cuda(parts):
        return ref.fused_reduce_ref(parts)
    if not parts.is_contiguous():
        raise ValueError("fused_reduce needs a contiguous operand tensor")
    p3 = parts if parts.dim() == 3 else parts.unsqueeze(0)
    B, x, L = p3.shape
    out = torch.empty((B, L), dtype=parts.dtype, device=parts.device)
    if out.numel():
        _launch_fused_reduce(p3, None, x, None, out, None, B, L)
    return out if parts.dim() == 3 else out[0]


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
                           own_rows.max(initial=-1))) + 1)


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
    if not _on_cuda(src, out):
        return ref.fused_reduce_into_ref(src, table.rows, out,
                                         table.out_rows, table.own_rows)
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("fused_reduce_into needs contiguous src and out")
    B, x = table.rows.shape
    if B and src.shape[1]:
        _launch_fused_reduce(src, table.rows, x, table.own_rows, out,
                             table.out_rows, B, src.shape[1])


def quantize(x: torch.Tensor, wire: str = "float8_e4m3fn",
             tile: int = QUANT_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, L) f32 → (q (W, Lp) wire dtype, scales (W, nt) f32): per-tile
    symmetric quantization, Lp = nt·tile."""
    wdt = wire_dtype(wire)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"quantize takes a 2-D f32 tensor; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not _on_cuda(x):
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
    if not _on_cuda(q, scales, own):
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
    wire = "fp8" if q.dtype == torch.float8_e4m3fn else "int8"
    kind = "f32" if out.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"quant_reduce_{wire}_{kind}")
    with torch.cuda.device(q.device):
        _check(fn(q.data_ptr(), scales.data_ptr(), _ptr(rows), K, _ptr(own),
                  _ptr(own_rows), own_len, out.data_ptr(), _ptr(out_rows),
                  out.shape[-1], B, q.shape[-1], _stream(q)),
               "quant_reduce")
    LAUNCHES["quant_reduce"] += 1


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
    if not _on_cuda(q, scales, out):
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


__all__ = ["LAUNCHES", "QUANT_TILE", "WIRE_QMAX", "RowTable",
           "fused_reduce", "fused_reduce_into", "quant_reduce",
           "quant_reduce_into", "quantize", "reset_launches", "row_table"]
