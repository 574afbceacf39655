"""Tensor parallelism on the auto engine's "model" axis: rwkv6-1.6b,
hymba-1.5b and whisper-large-v3 (their widened smoke models with FSDP in
f32 on ("data", 2) x ("model", 2), against the reference's auto engine
and the port's one-device run, as `test_torch_dist_tp.py`'s; `_tp_runs.py`
holds the fixture's body and the tolerances), the operators of the
"model" line in f64 against the unsharded autograd, the line's traffic
in a step, and a checkpointed `run_training` on the (data, model) mesh.
"""
import pytest
import torch

import _dist_workers as W
import _tp_runs as TP
from repro_torch.launch import mesh as M

LABELS = list(W.TP_REST)
OPS_TOL = 1e-12
# the loss takes its log-softmax in f32 (`transformer._nll`, as the
# reference's), so its f64 inputs meet it at f32's rounding
NLL_TOL = 1e-6
# the parameter leaves the forward uses outside a product, by their last
# path key, which it gathers over the "model" line where the rule shards
# them: the norms' weights (qwen3-32b's and mixtral-8x22b's ln1 and ln2
# at full size), RWKV6's token-shift mixes, decay base and bonus, the
# SSM's decays (hymba-1.5b's log_a at full size), step bias and skip
GATHERED = {"ln1", "ln2", "ln_f", "ln_x", "ln_attn", "ln_ssm", "ln_enc",
            "q_norm", "k_norm", "mu", "cm_mu", "w0", "u", "log_a",
            "dt_bias", "d_skip"}
# torch calls that take a model-sharded leaf outside the gathers: the
# products (as `x @ w`, `torch.matmul`, `torch.bmm`), reads of its shape
# and dtype, its widening to f32 (`recurrence._widened`), and the
# embedding's lookup of its local columns
PRODUCTS = {"__matmul__", "matmul", "bmm"}
READS = {"__get__", "dim", "float"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TP.run(tmp_path_factory.mktemp("dist_tp_rest"), LABELS,
                  extras=True)


@pytest.fixture(scope="module")
def ops():
    return M.launch(W.tp_ops_worker, [("model", 2)], backend="gloo",
                    device="cpu", timeout_s=TP.TIMEOUT_S, threads=1)


@pytest.mark.parametrize("label", LABELS)
def test_ranks_match_the_reference_tp_step(runs, label):
    ref, ranks, _, _ = runs
    TP.check_reference(ref, ranks, label)


@pytest.mark.parametrize("label", LABELS)
def test_ranks_match_the_one_device_run(runs, label):
    _, ranks, one, _ = runs
    TP.check_one_device(ranks, one, label)


@pytest.mark.parametrize("label", LABELS)
def test_every_kind_of_spec_occurs(runs, label):
    _, ranks, _, _ = runs
    assert TP.kinds(ranks, label) == TP.KINDS


@pytest.mark.parametrize("case", list(W.TP_OPS))
def test_operators_match_unsharded_autograd(ops, case):
    """Each rank's output and its gradients, of x and of its slices of
    the weights, equal the unsharded autograd's (sliced) within 1e-12
    in f64, relative to each tensor's largest |value|: the column- and
    row-sharded products, the batch-sharded one, the sharded MLP (and
    the row-first pair, unfused), the experts, the embedding, a norm's
    gathered weight; the vocabulary-parallel loss within NLL_TOL."""
    x, ws, g = W.tp_op_inputs(case)
    wspecs = W.TP_OPS[case][1]
    ws = [w.clone().requires_grad_(True) for w in ws]
    xg = x if case == "embed" else x.clone().requires_grad_(True)
    y = W.tp_op(case, xg, ws)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    wrt = ws if case == "embed" else [xg] + ws
    want = torch.autograd.grad((y * dy).sum(), wrt)
    tol = NLL_TOL if case == "nll" else OPS_TOL
    y = y.detach()
    for r, res in enumerate(ops):
        got_y, got = res[case]
        assert float((got_y - y).abs().max()) <= tol * float(y.abs().max())
        n_x = 0 if case == "embed" else 1
        for i, (a, b) in enumerate(zip(got, want)):
            if i >= n_x:
                _, d = wspecs[i - n_x]
                n = b.shape[d] // 2
                b = b.narrow(d, r * n, n)
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= tol * float(
                b.abs().max()), (case, i)


def test_no_parameter_is_gathered_over_the_model_line(runs):
    """In a step, the four operators of the model line move activations
    and their cotangents only: the one parameter leaves they take are
    the gathers of GATHERED's leaves (used outside a product), where
    the rule shards them (here under a threshold of 64, so that it
    does)."""
    _, ranks, _, _ = runs
    gathered = set()
    for res in ranks:
        for label, c in res["census"].items():
            for op, _, path in c["calls"]:
                if path is None:
                    continue
                assert op == "gather_over_line", (label, op, path)
                assert path.split("/")[-1] in GATHERED, (label, path)
                gathered.add(path.split("/")[-1])
            assert c["sent"] > 0
    assert {"ln1", "ln2", "log_a", "mu", "u"} <= gathered


def test_sharded_leaves_enter_every_product_at_their_slice(runs):
    """Each model-sharded leaf enters the step's torch calls only as this
    rank's 1/m of it: in products (and the embedding's lookup), never
    whole; every sharded leaf that GATHERED does not name enters at
    least one product, and no other call but reads of its shape and
    dtype."""
    _, ranks, _, _ = runs
    for res in ranks:
        for label, c in res["census"].items():
            m = c["m"]
            seen = set()
            for func, path, shape in c["uses"]:
                dim, whole = c["sharded"][path]
                layer = path.split("/")[0] in ("layers", "encoder",
                                               "decoder")
                want = list(whole[1:] if layer else whole)
                d = dim - 1 if layer else dim
                want[d] //= m
                assert list(shape) == want, (label, path, shape)
                if path.split("/")[-1] in GATHERED:
                    continue
                assert func in PRODUCTS | READS or (
                    path == "embed" and func == "__getitem__"), (
                        label, func, path)
                if func in PRODUCTS:
                    seen.add(path)
            want = {p for p in c["sharded"] if p != "embed"
                    and p.split("/")[-1] not in GATHERED}
            assert seen == want, (label, sorted(want - seen))


def test_model_line_ranks_are_equal_bit_for_bit(runs):
    """Every rank's loss and gnorm of each census step are the same bits:
    the ranks of a model line sum their partials in line order."""
    _, ranks, _, _ = runs
    for label in ranks[0]["census"]:
        vals = {(res["census"][label]["loss"], res["census"][label]["gnorm"])
                for res in ranks}
        assert len(vals) == 1, (label, vals)


def test_checkpoint_restart_on_the_tp_mesh_replays_exactly(runs):
    """run_training on ("data", 2) x ("model", 2), its leaves sharded on
    "model": 4 steps at once, or 2 and then a resumed run from the same
    directory (each rank restoring its local tensors in place): the same
    last loss."""
    _, ranks, _, _ = runs
    ck = ranks[0]["ckpt"]
    assert ck["tp_leaves"] > 0
    assert ck["part"][1] == [0, 1] and ck["resumed"][1] == [2, 3]
    assert ck["resumed"][0][-1] == pytest.approx(ck["full"][0][-1],
                                                 rel=1e-5)
    assert all(res["ckpt"] == ck for res in ranks)


def test_adamw_in_slices_is_the_whole_update_bit_for_bit(monkeypatch):
    """The auto step updates a leaf's local tensors a slice at a time
    (`train._adamw_sliced`, so that a large local leaf's f32 temporaries
    stay a slice's): at slices of 7 elements of a (5, 13) leaf, the
    moments and parameters equal `adamw_update` of the whole leaf bit
    for bit, in place and into another tensor."""
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, adamw_update
    g = torch.Generator().manual_seed(0)
    p, grad, m, v = (torch.randn(5, 13, generator=g) for _ in range(4))
    v = v.abs()
    step = torch.tensor(3, dtype=torch.int32)
    cfg = AdamWConfig(lr=1e-3, grad_clip=0.0)
    want_p, want_o, _ = adamw_update([p], [grad], {"m": [m], "v": [v],
                                                   "step": step}, cfg)
    monkeypatch.setattr(train, "ADAMW_SLICE", 7)
    for in_place in (True, False):
        pp, mm, vv = p.clone(), m.clone(), v.clone()
        out = pp if in_place else torch.empty_like(pp)
        train._adamw_sliced(pp, grad, mm, vv, step, out, cfg)
        assert torch.equal(out, want_p[0])
        assert torch.equal(mm, want_o["m"][0])
        assert torch.equal(vv, want_o["v"][0])
