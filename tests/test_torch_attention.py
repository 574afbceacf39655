"""The port's attention and RMSNorm against the JAX package's, on the CPU.

- The plain `flash_attention` (what the wrapper runs on CPU tensors)
  against the Pallas kernel in interpret mode, on shared numpy inputs
  made from a seed: causal GQA with groups 1, 2 and 5, a sliding window,
  a soft-cap, fewer queries than keys, no causal mask, head dims 16 and
  160. f32 outputs agree within 1e-5 of the largest |value| (the two sum
  in another order). A bf16 output is the f32 result rounded once, so
  it is held within 2^-8 of the largest |value| of the Pallas kernel's
  output on the same inputs widened to f32 (holding two bf16 outputs
  against each other would count a rounding that went the other way,
  one step of up to 2^-7).
- `kv_len`: each batch row equals the plain version on its keys sliced
  to its length; a row that sees no key gives 0.
- The plain `rmsnorm` with offset 0 against the Pallas kernel, and with
  offset 1 against the reference model's `layers.rmsnorm`, for every
  dtype pair of x and w, on rows strided in their leading dims.
- The port's `attention_decode` against the reference's with a position
  per row and a window.
- gemma2-27b at smoke size in f32 (window 32, soft-caps 50 and 30): a
  48-token prompt, so the window masks keys in prefill and decode, and
  4 greedy decode steps, on the JAX model's weights through
  `convert.params_from_jax`: logits within 1e-4 of the largest |logit|,
  the same tokens. Its server on the CPU launches no kernel.
- The wrappers' contract: inputs they refuse on every device, and no
  plain fallback for a CUDA tensor when the build or launch fails.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.config import smoke_config as jsmoke

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build, ops, ref
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import layers
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build as build_model

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8
MODEL_RTOL = 1e-4
STEPS = 4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _as(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


# ---------------------------------------------------------------------------
# flash attention: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
FLASH_CASES = {   # B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, bq, bk
    "group1": (1, 2, 2, 16, 16, 16, True, 0, 0.0, 8, 8),
    "group2": (2, 4, 2, 16, 16, 16, True, 0, 0.0, 8, 8),
    "group5": (1, 5, 1, 16, 16, 16, True, 0, 0.0, 8, 8),
    "window_tq_lt_tk": (1, 4, 2, 8, 32, 16, True, 12, 0.0, 8, 8),
    "softcap": (1, 2, 1, 16, 16, 16, True, 0, 1.0, 8, 8),
    "gemma_like": (1, 4, 2, 16, 16, 16, True, 6, 50.0, 8, 8),
    "d160_window": (1, 2, 1, 8, 16, 160, True, 5, 0.0, 8, 8),
    "not_causal": (1, 2, 2, 8, 16, 16, False, 0, 0.0, 8, 8),
}


def _qkv_inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, Hq, Tq, D), _normal(rng, B, Hkv, Tk, D),
            _normal(rng, B, Hkv, Tk, D))


def _widened(arrays, dtype):
    """The arrays as `dtype` tensors and, exactly, back as f32 numpy."""
    ts = [_as(a, dtype) for a in arrays]
    return ts, [_np(t) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case, dtype):
    B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, bq, bk = \
        FLASH_CASES[case]
    (q, k, v), (qn, kn, vn) = _widened(
        _qkv_inputs(B, Hq, Hkv, Tq, Tk, D, seed=Hq * Tk + D), dtype)
    want = jflash(*map(jnp.asarray, (qn, kn, vn)), causal=causal,
                  window=window, softcap=softcap, block_q=bq, block_k=bk,
                  interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert got.dtype == dtype and got.shape == (B, Hq, Tq, D)
    tol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    assert _rel(_np(got), want) <= tol


def test_flash_plain_tiles_queries_past_one_block():
    """More queries than one score tile of the plain version holds: the
    tiles together give the dense softmax of a float64 numpy oracle."""
    Tq, Tk, window, cap = ref.FLASH_BLOCK_Q + 44, ref.FLASH_BLOCK_Q + 54, \
        40, 2.0
    qn, kn, vn = _qkv_inputs(1, 2, 1, Tq, Tk, 8, seed=3)
    got = ref.flash_attention(*map(torch.from_numpy, (qn, kn, vn)),
                              window=window, softcap=cap)
    s = np.einsum("bhqd,bkd->bhqk", qn.astype(np.float64),
                  kn[:, 0].astype(np.float64)) * 8 ** -0.5
    s = cap * np.tanh(s / cap)
    qpos = np.arange(Tq)[:, None] + Tk - Tq
    kpos = np.arange(Tk)[None, :]
    s = np.where((kpos <= qpos) & (kpos > qpos - window), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    want = np.einsum("bhqk,bkd->bhqd", p / p.sum(axis=-1, keepdims=True),
                     vn[:, 0].astype(np.float64))
    assert _rel(got.numpy(), want) <= F32_RTOL


def test_flash_layout_strided_in_and_token_major_out():
    """q, k, v given as head transposes of (B, T, H, D) tensors (no copy)
    give what contiguous ones give; the output is a (B, Hq, Tq, D) view
    of a (B, Tq, Hq, D) tensor."""
    q, k, v = _qkv_inputs(2, 4, 2, 6, 10, 16, seed=4)
    dense = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                window=4)
    strided = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1,
                                                                 3)))
               .transpose(1, 2) for a in (q, k, v)]
    assert not strided[0].is_contiguous()
    got = ops.flash_attention(*strided, window=4)
    assert _rel(got.numpy(), dense.numpy()) == 0.0
    assert got.transpose(1, 2).is_contiguous()


# ---------------------------------------------------------------------------
# kv_len: a visible-key count per batch row
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Tq,window,softcap", [(1, 0, 0.0), (1, 4, 50.0),
                                               (3, 5, 0.0), (4, 0, 1.0)])
def test_flash_kv_len_rows_match_sliced_keys(Tq, window, softcap):
    B, Hq, Hkv, Tk, D = 4, 5, 1, 16, 16
    q, k, v = map(torch.from_numpy,
                  _qkv_inputs(B, Hq, Hkv, Tq, Tk, D, seed=10 + Tq))
    n = torch.tensor([7, 16, Tq, 11])
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap,
                              kv_len=n)
    for b in range(B):
        m = int(n[b])
        want = ref.flash_attention(q[b:b + 1], k[b:b + 1, :, :m],
                                   v[b:b + 1, :, :m], window=window,
                                   softcap=softcap)
        assert _rel(got[b:b + 1].numpy(), want.numpy()) <= F32_RTOL
    # against the Pallas kernel on the one row whose count divides
    want = jflash(*(jnp.asarray(t[1:2].numpy()) for t in (q, k, v)),
                  window=window, softcap=softcap, block_q=Tq, block_k=8,
                  interpret=True)
    assert _rel(got[1:2].numpy(), want) <= F32_RTOL


def test_flash_rows_that_see_no_key_give_zero():
    """kv_len 0, and queries that the causal mask leaves with no key
    (more queries than visible keys), give exactly 0, never NaN."""
    q, k, v = map(torch.from_numpy, _qkv_inputs(2, 2, 2, 4, 8, 16, seed=5))
    got = ops.flash_attention(q, k, v, kv_len=torch.tensor([0, 2]),
                              window=3)
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()
    assert (got[1, :, :2] == 0).all() and (got[1, :, 2:] != 0).any()


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


@pytest.mark.parametrize("w_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 200)])
def test_rmsnorm_offset_zero_matches_pallas(shape, x_dtype, w_dtype):
    rng = np.random.default_rng(sum(shape))
    (x, w), (xn, wn) = _widened([_normal(rng, *shape) * 3.0,
                                 _normal(rng, shape[-1])], x_dtype)
    w = w.to(w_dtype)
    want = jrmsnorm(jnp.asarray(xn), jnp.asarray(_np(w)), block_rows=8,
                    interpret=True)
    got = ops.rmsnorm(x, w)
    assert got.dtype == x_dtype and got.shape == shape
    tol = F32_RTOL if x_dtype == torch.float32 else BF16_RTOL
    assert _rel(_np(got), want) <= tol


@pytest.mark.parametrize("w_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=DTYPE_IDS)
def test_rmsnorm_offset_one_matches_model_norm(x_dtype, w_dtype):
    rng = np.random.default_rng(11)
    (x,), (xn,) = _widened([_normal(rng, 2, 6, 48)], x_dtype)
    w = _as(_normal(rng, 48) * 0.5, w_dtype)
    want = jlayers.rmsnorm(jnp.asarray(xn), jnp.asarray(_np(w)))
    got = layers.rmsnorm(x, w)
    assert got.dtype == x_dtype
    tol = F32_RTOL if x_dtype == torch.float32 else BF16_RTOL
    assert _rel(_np(got), want) <= tol
    # the two forms differ by exactly the unit added to w
    assert _rel(_np(ops.rmsnorm(x.float(), w.float() + 1.0)),
                _np(ops.rmsnorm(x.float(), w, offset=1.0))) <= F32_RTOL


def test_rmsnorm_strided_rows():
    """Rows strided in up to three leading dims (a last-token slice, a
    head transpose) normalise as their contiguous copies do."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_normal(rng, 2, 5, 3, 16))
    w = torch.from_numpy(_normal(rng, 16))
    for view in (x[:, -1:], x.transpose(1, 2), x[:, ::2, 1]):
        assert not view.is_contiguous()
        got = ops.rmsnorm(view, w, offset=1.0)
        want = ops.rmsnorm(view.contiguous(), w, offset=1.0)
        assert got.shape == view.shape
        assert torch.equal(got, want)


def test_row_layout_merges_leading_dims():
    x = torch.zeros(2, 3, 4, 8)
    assert ops._row_layout(x) == [(1, 0), (1, 0), (24, 8)]
    assert ops._row_layout(x[:, -1:]) == [(1, 0), (2, 96), (4, 8)]
    assert ops._row_layout(x.transpose(1, 2)) == [(2, 96), (4, 8), (3, 32)]


# ---------------------------------------------------------------------------
# the models: decode attention, gemma2-27b, the server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemma():
    jcfg = jsmoke(jget_config("gemma2-27b"))
    cfg = smoke_config(get_config("gemma2-27b"))
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg,
                                       dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def test_gemma2_smoke_config_keeps_its_features(gemma):
    _, _, cfg, params = gemma
    assert cfg.window_pattern == (32, 0) and cfg.attn_softcap == 50.0
    assert cfg.final_softcap == 30.0 and cfg.head_dim == 16
    assert len(params["layers"]) == cfg.n_layers
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_matches_jax(gemma, window):
    """One decode step per row at its own position (0, 5 and 9 of a
    16-slot cache) against the reference's `attention_decode`: the
    output and the caches with the new K/V written in."""
    jcfg, jparams, cfg, params = gemma
    rng = np.random.default_rng(13)
    B, S = 3, 16
    x = _normal(rng, B, 1, cfg.d_model)
    ck = _normal(rng, B, cfg.n_kv_heads, S, cfg.head_dim)
    cv = _normal(rng, B, cfg.n_kv_heads, S, cfg.head_dim)
    pos = np.array([0, 5, 9])
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want, wk, wv = jlayers.attention_decode(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos, jnp.int32), jcfg, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = layers.attention_decode(params["layers"][0]["attn"],
                                  torch.from_numpy(x), tk, tv,
                                  torch.from_numpy(pos), cfg, window=window)
    assert _rel(got.numpy(), want) <= MODEL_RTOL
    assert _rel(tk.numpy(), wk) <= MODEL_RTOL
    assert _rel(tv.numpy(), wv) <= MODEL_RTOL


@pytest.fixture(scope="module")
def gemma_runs(gemma):
    """Prefill of a 48-token prompt (cache 64) and 4 greedy decode steps
    in both packages."""
    jcfg, jparams, cfg, params = gemma
    B, T, cache_len = 2, 48, 64
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, T))
    logits, cache = jtransformer.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         cache_len=cache_len)
    step = jax.jit(lambda p, c, t: jtransformer.decode_step(p, jcfg, c, t))
    jouts, jtoks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        jtoks.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok[:, None])
        jouts.append(np.asarray(logits))

    api = build_model(cfg)
    ops.reset_launches()
    with torch.inference_mode():
        logits, state = api.prefill(
            params, {"tokens": torch.from_numpy(tokens)}, cache_len)
        touts, ttoks = [logits.numpy()], []
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(dim=-1)
            ttoks.append(tok.numpy())
            logits, state = api.decode_step(params, state,
                                            {"tokens": tok[:, None]})
            touts.append(logits.numpy())
    return dict(jouts=jouts, touts=touts, jtoks=np.stack(jtoks, 1),
                ttoks=np.stack(ttoks, 1), launches=dict(ops.LAUNCHES),
                jk=np.asarray(cache["k"]), tk=state["k"].numpy())


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_gemma2_logits_match_jax(gemma_runs, step):
    assert _rel(gemma_runs["touts"][step],
                gemma_runs["jouts"][step]) <= MODEL_RTOL


def test_gemma2_greedy_tokens_and_cache_match_jax(gemma_runs):
    np.testing.assert_array_equal(gemma_runs["ttoks"], gemma_runs["jtoks"])
    assert _rel(gemma_runs["tk"], gemma_runs["jk"]) <= MODEL_RTOL
    assert sum(gemma_runs["launches"].values()) == 0


def test_serve_gemma2_smoke_on_cpu():
    lines = []
    ops.reset_launches()
    res = serve(ServeConfig(arch="gemma2-27b", batch=2, prompt_len=40,
                            max_new=4, cache_len=48, device="cpu"),
                smoke=True, on_log=lines.append)
    text = "\n".join(lines)
    assert "self-check rel err" in text and "served batch=2" in text, text
    assert res["config"].name == "gemma2-27b"
    assert res["tokens"].shape == (2, 4)
    assert res["self_check_err"] < 1e-5
    assert res["tp_schedule"].demotions == 0
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------
def _bad_calls():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(_normal(rng, 2, 3, 8))
    w = torch.from_numpy(_normal(rng, 8))
    q, k, v = map(torch.from_numpy, _qkv_inputs(1, 4, 2, 4, 8, 16, 15))
    return [
        lambda: ops.rmsnorm(x.double(), w),
        lambda: ops.rmsnorm(x, w.half()),
        lambda: ops.rmsnorm(x, w[:4]),
        lambda: ops.rmsnorm(x.transpose(1, 2), torch.ones(3)),
        lambda: ops.rmsnorm(torch.zeros(1, ops.RMSNORM_MAX_WIDTH + 1),
                            torch.zeros(ops.RMSNORM_MAX_WIDTH + 1)),
        lambda: ops.rmsnorm(torch.zeros(2, 3, 4, 5, 8).permute(3, 2, 1, 0,
                                                               4),
                            torch.zeros(8)),
        lambda: ops.flash_attention(q, k.bfloat16(), v),
        lambda: ops.flash_attention(q[:, :3], k, v),
        lambda: ops.flash_attention(q, k[:, :, :3], v[:, :, :3]),
        lambda: ops.flash_attention(q, k, v[:, :, :6]),
        lambda: ops.flash_attention(q.transpose(2, 3), k, v),
        lambda: ops.flash_attention(q, k, v, window=-1),
        lambda: ops.flash_attention(
            q, k, v, kv_len=torch.tensor([3], dtype=torch.int32)),
        lambda: ops.flash_attention(*(torch.zeros(1, 1, 2, 257)
                                      for _ in range(3))),
    ]


@pytest.mark.parametrize("case", range(14))
def test_model_kernel_wrappers_refuse_bad_inputs(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()


def test_cpu_calls_count_no_launch():
    ops.reset_launches()
    q, k, v = map(torch.from_numpy, _qkv_inputs(1, 2, 1, 2, 4, 16, 16))
    ops.flash_attention(q, k, v)
    ops.rmsnorm(q, torch.ones(16))
    assert {"rmsnorm", "flash_attention"} <= set(ops.LAUNCHES)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention"])
def test_cuda_path_raises_without_fallback(monkeypatch, kernel):
    """A CUDA tensor's call goes to the kernel: when the build fails the
    wrapper raises, and when the launch reports an error it raises that,
    never answering with the plain version or counting a launch."""
    q, k, v = map(torch.from_numpy, _qkv_inputs(2, 4, 2, 3, 8, 16, 17))
    call = {"rmsnorm": lambda: ops.rmsnorm(q, torch.ones(16), offset=1.0),
            "flash_attention": lambda: ops.flash_attention(
                q, k, v, window=4, kv_len=torch.tensor([5, 8]))}[kernel]
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops.ref, kernel, None)           # never called
    ops.reset_launches()

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        call()

    class FailingLib:
        def __getattr__(self, fn):
            return lambda *a: 700            # cudaErrorIllegalAddress
    monkeypatch.setattr(build, "load", lambda name: FailingLib())
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="cudaError 700"):
        call()
    assert ops.LAUNCHES[kernel] == 0
