"""Hand-written Hopper kernels of the port and their plain versions.

fused_reduce — the paper's δ-optimal N-ary reduction; quantize and
quant_reduce — the fp8/int8 wire format of compressed collectives. The
CUDA sources live in `csrc/`, `build.py` compiles and loads them, `ops.py`
holds the wrappers (plain version on CPU tensors, kernel on CUDA ones) and
`ref.py` the plain versions.
"""
from . import ops, ref  # noqa: F401
