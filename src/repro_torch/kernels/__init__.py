"""Hand-written Hopper kernels of the port and their plain versions.

fused_reduce and grouped_reduce — the paper's δ-optimal N-ary reduction,
in one pass or as a tree of bounded fan-in; quantize, dequantize,
quant_reduce and quant_reduce_requant — the fp8/int8 wire format of
compressed collectives; wkv
and ssm_scan — the RWKV6 and Mamba recurrences of the recurrent model
families; rmsnorm and flash_attention — every norm and attention of the
served models. The CUDA sources live in `csrc/`, `build.py` compiles and
loads them, `ops.py` holds the wrappers (plain version on CPU tensors,
kernel on CUDA ones) and `ref.py` the plain versions.
"""
from . import ops, ref  # noqa: F401
