"""The kernel wrappers on the card refuse inputs that need a gradient.

The CUDA kernels write their outputs through raw pointers, so autograd
sees no graph behind them. Rather than cut the gradients silently, a
wrapper given a CUDA tensor raises when grad mode is on and an input
requires grad; under `torch.no_grad()` or `torch.inference_mode()` (how
serving runs) it launches. The CPU path, the plain versions, stays
differentiable. The card is faked here: `_on_cuda` answers True and the
library is one whose launchers all report success.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref


def _t(shape, seed=0, grad=False):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))
    return x.requires_grad_(grad)


def _wire(shape, grad):
    q, s = ref.quantize_ref(_t(shape), "float8_e4m3fn")
    return q, s.requires_grad_(grad)


def _calls(grad):
    """wrapper → (call, the kernel its launches count under), each with
    one input that requires grad when `grad`."""
    q, s = _wire((2, 128), grad)
    one = ops.row_table([[0]], [0])
    two = ops.row_table([[0, 1]], [0])
    B, H, T, K = 1, 2, 3, 4
    return {
        "fused_reduce": (lambda: ops.fused_reduce(_t((2, 8), 1, grad)),
                         "fused_reduce"),
        "grouped_reduce": (lambda: ops.grouped_reduce(_t((3, 8), 1, grad),
                                                      2), "grouped_reduce"),
        "fused_reduce_into": (lambda: ops.fused_reduce_into(
            _t((2, 8), 1, grad), two, torch.zeros(1, 8)), "fused_reduce"),
        "quantize": (lambda: ops.quantize(_t((2, 128), 1, grad)),
                     "quantize"),
        "dequantize": (lambda: ops.dequantize(q, s), "dequantize"),
        "dequantize_into": (lambda: ops.dequantize_into(
            q, s, one, torch.zeros(1, 128)), "dequantize"),
        "quant_reduce_requant": (lambda: ops.quant_reduce_requant(q, s),
                                 "quant_reduce_requant"),
        "quant_reduce": (lambda: ops.quant_reduce(q, s), "quant_reduce"),
        "quant_reduce_into": (lambda: ops.quant_reduce_into(
            q, s, two, torch.zeros(1, 128)), "quant_reduce"),
        "wkv": (lambda: ops.wkv(
            _t((B, H, T, K), 1, grad), _t((B, H, T, K), 2),
            _t((B, H, T, K), 3), -torch.ones(B, H, T, K), _t((H, K), 4),
            _t((B, H, K, K), 5)), "wkv"),
        "ssm_scan": (lambda: ops.ssm_scan(
            _t((B, T, 8), 1, grad), torch.ones(B, T, 8), _t((B, T, K), 2),
            _t((B, T, K), 3), -torch.ones(8, K), _t((B, 8, K), 4)),
            "ssm_scan"),
        "rmsnorm": (lambda: ops.rmsnorm(_t((2, 3, 16), 1, grad),
                                        torch.ones(16), offset=1.0),
                    "rmsnorm"),
        "flash_attention": (lambda: ops.flash_attention(
            _t((1, 4, 3, 16), 1, grad), _t((1, 2, 5, 16), 2),
            _t((1, 2, 5, 16), 3), window=4), "flash_attention"),
    }


@pytest.fixture
def fake_card(monkeypatch):
    class Lib:
        def __getattr__(self, fn):
            return lambda *a: 0          # cudaSuccess
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("wrapper", sorted(_calls(False)))
def test_card_path_refuses_grad_and_launches_without(fake_card, wrapper):
    call, kernel = _calls(True)[wrapper]
    before = ops.LAUNCHES[kernel]
    with pytest.raises(RuntimeError,
                       match=f"the {kernel} kernel has no backward"):
        call()
    assert ops.LAUNCHES[kernel] == before          # no launch counted
    with torch.no_grad():
        call()
    assert ops.LAUNCHES[kernel] == before + 1
    with torch.inference_mode():
        call()
    assert ops.LAUNCHES[kernel] == before + 2
    _calls(False)[wrapper][0]()                    # nothing needs grad
    assert ops.LAUNCHES[kernel] == before + 3


@pytest.mark.parametrize("wrapper", ["fused_reduce", "grouped_reduce",
                                     "wkv", "ssm_scan", "rmsnorm",
                                     "flash_attention"])
def test_cpu_path_stays_differentiable(wrapper):
    """On CPU tensors the wrapper runs the plain version, whose output
    carries autograd's graph back to the input that needs it."""
    call, kernel = _calls(True)[wrapper]
    before = ops.LAUNCHES[kernel]
    out = call()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert ops.LAUNCHES[kernel] == before
