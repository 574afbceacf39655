"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (`-gencode arch=compute_90a,code=sm_90a`), so a build takes
seconds and needs no PyTorch headers. Libraries land in `build/kernels/`
at the repository root, named by a hash of their source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
is built when this module is imported: `load` builds on first use, and
`build_all` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"fused_reduce": "fused_reduce.cu", "quant": "quant.cu",
           "wkv": "wkv.cu", "ssm_scan": "ssm_scan.cu",
           "rmsnorm": "rmsnorm.cu", "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signature of every exported launcher (all return a cudaError_t).
_FR = (_P, _P, _I, _P, _P, _P, _P, _L, _L, _P)
_QR = (_P, _P, _P, _I, _P, _P, _L, _P, _P, _L, _L, _L, _P)
_GR = (_P, _P, _I, _I, _L, _P)
_DQ = (_P, _P, _P, _P, _P, _L, _L, _L, _P)
_RQ = (_P, _P, _I, _P, _P, _L, _P)
_RN = (_P, _P, _P) + (_L,) * 6 + (_I, _F, _F, _P)
_FA = (_P,) * 5 + (_I,) * 6 + (_L,) * 9 + (_F, _F, _I, _I, _I, _P)
SIGNATURES = {
    "fused_reduce": {
        "fused_reduce_f32": _FR,
        "fused_reduce_bf16": _FR,
        "fused_reduce_bf16_f32": _FR,
        "grouped_reduce_f32": _GR,
        "grouped_reduce_bf16": _GR,
    },
    "quant": {
        "quantize_fp8": (_P, _P, _P, _L, _L, _L, _P),
        "quantize_int8": (_P, _P, _P, _L, _L, _L, _P),
        "quant_reduce_fp8_f32": _QR,
        "quant_reduce_fp8_bf16": _QR,
        "quant_reduce_int8_f32": _QR,
        "quant_reduce_int8_bf16": _QR,
        **{f"dequantize_{w}_{t}": _DQ for w in ("fp8", "int8")
           for t in ("f32", "bf16")},
        **{f"quant_reduce_requant_{a}_{b}": _RQ for a in ("fp8", "int8")
           for b in ("fp8", "int8")},
    },
    "wkv": {"wkv_f32": (_P,) * 8 + (_I,) * 7 + (_P,)},
    "ssm_scan": {"ssm_scan_f32": (_P,) * 8 + (_I,) * 6 + (_P,)},
    "rmsnorm": {f"rmsnorm_{x}_{w}": _RN for x in ("f32", "bf16")
                for w in ("f32", "bf16")},
    "flash_attention": {"flash_attention_f32": _FA,
                        "flash_attention_bf16": _FA},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by name
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    target = _target(name)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build_all(names=None) -> dict[str, float]:
    """Compile every stale source (or those in `names`), one nvcc each,
    all started together. Returns the seconds from start to each
    library's completion (0.0 for one already built). Raises on the first
    failed compile, with the compiler's output."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    secs = {}
    for name in names:
        if _target(name).is_file():
            secs[name] = 0.0
        else:
            running[name] = _start(name)
    try:
        for name, (proc, tmp, target) in running.items():
            out, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            build_logs[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, target)
    finally:
        for proc, tmp, _target_path in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed, with
    `argtypes`/`restype` declared for every launcher."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not target.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib
