"""The port's CUDA kernels and executor against their plain versions, on
the card.

Every test here needs a CUDA device and skips without one; on a machine
with a card run `PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
-q`. The file imports no JAX (the card's machine has none): the plain
versions it holds the kernels against are themselves held against the
JAX package by tests/test_torch_kernels.py on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import PAPER_TABLE5, PRECISIONS
from repro_torch.core.gentree import gentree
from repro_torch.core.lower import lower_plan
from repro_torch.core.topology import single_switch, symmetric_tree
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed, dev, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


# The kernels compute the plain versions' float operations in the same
# order, so they must agree exactly (tolerance 0).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1000), (3, 20480), (9, 1001),
                                   (4, 8, 4100), (8, 9, 1003)])
def test_fused_reduce_kernel_matches_plain(dev, dtype, shape):
    x = _rand(shape, 1, dev).to(dtype)
    before = ops.LAUNCHES["fused_reduce"]
    got = ops.fused_reduce(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] == before + 1
    want = ref.fused_reduce_ref(x)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("shape", [(1, 1000), (4, 20480), (3, 131),
                                   (2, 256)])
def test_quantize_kernel_matches_plain(dev, wire, shape):
    x = _rand(shape, 2, dev, scale=3.0)
    x[:, :128] = 0.0                        # an all-zero tile
    q, s = ops.quantize(x, wire)
    torch.cuda.synchronize()
    qr, sr = ref.quantize_ref(x, wire)
    assert torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
    assert torch.equal(s, sr)
    assert (s[:, 0] == 0).all()


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("with_own", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_quant_reduce_kernel_matches_plain(dev, wire, with_own, batch):
    K, L = 5, 1000
    lead = () if batch is None else (batch,)
    x = _rand(lead + (K, L), 3, dev)
    q, s = ops.quantize(x.reshape(-1, L), wire)
    q = q.reshape(lead + (K, -1))
    s = s.reshape(lead + (K, -1))
    # a masked operand: NaN payload bits under a zero scale
    q.view(torch.uint8)[..., 1, :] = 0x7F if wire != "int8" else 0x80
    s[..., 1, :] = 0.0
    own = _rand(lead + (L,), 4, dev) if with_own else None
    got = ops.quant_reduce(q, s, own, out_len=L)
    torch.cuda.synchronize()
    want = ref.quant_reduce_ref(q, s, own, out_len=L)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _tables(B, K, R, n_out, dev):
    """Gathered-launch row tables: operands from rows 0..R-1 with one
    masked (−1) slot per batch row, distinct out rows, every other batch
    row folding its own partial."""
    rng = np.random.default_rng(B * K)
    rows = rng.integers(0, R, (B, K))
    rows[np.arange(B), rng.integers(0, K, B)] = -1
    out_rows = rng.permutation(n_out)[:B]
    own_rows = np.where(np.arange(B) % 2 == 0, out_rows, -1)
    return ops.row_table(rows, out_rows, own_rows, dev)


@pytest.mark.parametrize("src_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,K,L", [(8, 7, 2560), (3, 2, 1003), (6, 9, 4096)])
def test_fused_reduce_into_kernel_matches_plain(dev, src_dtype, out_dtype,
                                                B, K, L):
    R, n_out = 20, 10
    src = _rand((R + 1, L), 6, dev).to(src_dtype)
    src[R] = float("nan")                   # a row no table names
    t = _tables(B, K, R, n_out, dev)
    out = _rand((n_out, L), 7, dev).to(out_dtype)
    got, want = out.clone(), out.clone()
    before = ops.LAUNCHES["fused_reduce"]
    ops.fused_reduce_into(src, t, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_reduce"] == before + 1
    ref.fused_reduce_into_ref(src, t.rows, want, t.out_rows, t.own_rows)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,L", [(8, 7, 2560), (3, 2, 1003)])
def test_quant_reduce_into_kernel_matches_plain(dev, wire, dtype, B, K, L):
    R, n_out = 20, 10
    q, s = ops.quantize(_rand((R + 1, L), 8, dev), wire)
    q.view(torch.uint8)[R] = 0x7F           # NaN bits in a row no table names
    s[3, 0] = 0.0                           # a zero-scale tile
    t = _tables(B, K, R, n_out, dev)
    out = _rand((n_out, L), 9, dev).to(dtype)
    got, want = out.clone(), out.clone()
    before = ops.LAUNCHES["quant_reduce"]
    ops.quant_reduce_into(q, s, t, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quant_reduce"] == before + 1
    ref.quant_reduce_into_ref(q, s, t.rows, want, t.out_rows, t.own_rows)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("topo", ["flat8", "two_level", "flat6"])
@pytest.mark.parametrize("wire", [None, "bf16", "fp8", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_run_local_on_card(dev, topo, wire, dtype):
    t = {"flat8": single_switch(8), "two_level": symmetric_tree(2, 4),
         "flat6": single_switch(6)}[topo]
    cs = lower_plan(gentree(t, 1e6, params=PAPER_TABLE5).plan)
    if wire is not None:
        cs = cs.with_wire(PRECISIONS[wire])
    X = _rand((t.num_servers(), 4 * 5120 + 3), 5, dev)
    if dtype == "bf16":
        X = X.to(torch.bfloat16)
    want = X.double().sum(dim=0)
    got = cs.run_local(X)
    torch.cuda.synchronize()
    assert got.dtype == X.dtype
    err = float((got.double() - want).abs().max() / want.abs().max())
    budget = 1e-6 if wire is None else PRECISIONS[wire].error_budget
    if dtype == "bf16":                     # the buffer itself rounds
        budget = max(budget, 2e-2)
    assert err <= budget
    # the same schedule on the CPU runs the plain versions: the same
    # float operations in the same order
    assert torch.equal(got.cpu(), cs.run_local(X.cpu()))
