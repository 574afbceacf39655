"""The port's recurrent families against the JAX package's, on the CPU.

- The plain `wkv` and `ssm_scan` (what the wrappers run on CPU tensors)
  against the Pallas kernels in interpret mode, on shared numpy inputs
  made from a seed, within 1e-5 of the largest |value| for output and
  final state: the Pallas kernels evaluate the recurrences chunk by chunk
  (WKV in its parallel pair form), the port token by token, so f32
  rounding differs.
- rwkv6-1.6b and hymba-1.5b at smoke size in f32, the JAX model
  initialized by its own `init_params` and the port run on the same
  weights through `convert.params_from_jax`: prefill and 4 greedy decode
  steps agree in logits within 1e-4 of the largest |logit| and pick the
  same tokens. A 40-token Hymba prompt makes the smoke window of 32 mask
  keys and the reference's SSM scan run more than one chunk.
- The server at smoke size for both families, with no kernel launched.
- The wrappers' contract: f32 and contiguous inputs, widths up to 64, and
  no plain fallback for a CUDA tensor when the build or launch fails.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ssm_scan import ssm_scan as jssm_scan
from repro.kernels.wkv import wkv as jwkv
from repro.models import hybrid_model as jhybrid
from repro.models import rwkv_model as jrwkv
from repro.models.config import smoke_config as jsmoke

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build, ops
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build as build_model

KERNEL_RTOL = 1e-5
MODEL_RTOL = 1e-4
STEPS = 4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _wkv_inputs(B, H, T, K, V, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(r=f(B, H, T, K), k=f(B, H, T, K), v=f(B, H, T, V),
                logw=-np.exp(f(B, H, T, K)), u=f(H, K) * 0.1,
                s0=f(B, H, K, V) * 0.1)


def _ssm_inputs(B, T, Di, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(B, T, Di), dt=np.log1p(np.exp(f(B, T, Di))),
                b=f(B, T, N), c=f(B, T, N), log_a=-np.exp(f(Di, N) * 0.5),
                s0=f(B, Di, N) * 0.1)


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


# ---------------------------------------------------------------------------
# the plain recurrences against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,T,K,V,chunk", [
    (1, 2, 8, 4, 4, 4), (2, 3, 16, 8, 8, 8), (2, 2, 40, 16, 16, 32),
    (1, 2, 12, 16, 8, 4)])
def test_wkv_plain_matches_pallas(B, H, T, K, V, chunk):
    x = _wkv_inputs(B, H, T, K, V, seed=B * T + K + V)
    want, s_want = jwkv(**_jax(x), chunk=chunk, interpret=True)
    got, s_got = ops.wkv(**_torch(x))
    assert _rel(got.numpy(), want) <= KERNEL_RTOL
    assert _rel(s_got.numpy(), s_want) <= KERNEL_RTOL


def test_wkv_state_handoff_matches_pallas():
    """Two calls over the halves of the sequence, the first's final state
    handed to the second, equal one Pallas call over the whole."""
    x = _wkv_inputs(2, 2, 16, 8, 8, seed=21)
    want, s_want = jwkv(**_jax(x), chunk=8, interpret=True)
    t = _torch(x)
    half = lambda a, sl: a[:, :, sl].contiguous()  # noqa: E731
    h1, s1 = ops.wkv(*(half(t[n], slice(0, 8)) for n in "r k v logw".split()),
                     t["u"], t["s0"])
    h2, s2 = ops.wkv(*(half(t[n], slice(8, 16))
                       for n in "r k v logw".split()), t["u"], s1)
    assert _rel(torch.cat([h1, h2], dim=2).numpy(), want) <= KERNEL_RTOL
    assert _rel(s2.numpy(), s_want) <= KERNEL_RTOL


@pytest.mark.parametrize("B,T,Di,N,chunk,bd", [
    (1, 8, 4, 2, 4, 4), (2, 16, 12, 4, 4, 6), (2, 40, 200, 8, 16, 200),
    (1, 6, 10, 16, 6, 5)])
def test_ssm_scan_plain_matches_pallas(B, T, Di, N, chunk, bd):
    x = _ssm_inputs(B, T, Di, N, seed=B * T + Di + N)
    want, s_want = jssm_scan(**_jax(x), chunk=chunk, block_d=bd,
                             interpret=True)
    got, s_got = ops.ssm_scan(**_torch(x))
    assert _rel(got.numpy(), want) <= KERNEL_RTOL
    assert _rel(s_got.numpy(), s_want) <= KERNEL_RTOL


def test_ssm_scan_state_handoff_matches_pallas():
    x = _ssm_inputs(2, 16, 12, 4, seed=22)
    want, s_want = jssm_scan(**_jax(x), chunk=8, block_d=12, interpret=True)
    t = _torch(x)
    half = lambda a, sl: a[:, sl].contiguous()  # noqa: E731
    seq = ("u", "dt", "b", "c")
    y1, s1 = ops.ssm_scan(*(half(t[n], slice(0, 8)) for n in seq),
                          t["log_a"], t["s0"])
    y2, s2 = ops.ssm_scan(*(half(t[n], slice(8, 16)) for n in seq),
                          t["log_a"], s1)
    assert _rel(torch.cat([y1, y2], dim=1).numpy(), want) <= KERNEL_RTOL
    assert _rel(s2.numpy(), s_want) <= KERNEL_RTOL


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------
def _bad_calls():
    w = _torch(_wkv_inputs(1, 2, 4, 8, 8, seed=3))
    s = _torch(_ssm_inputs(1, 4, 6, 4, seed=4))
    wide = _torch(_wkv_inputs(1, 1, 2, 65, 8, seed=5))
    wide_s = _torch(_ssm_inputs(1, 2, 3, 65, seed=6))
    return [
        lambda: ops.wkv(**{**w, "r": w["r"].double()}),
        lambda: ops.wkv(**{**w, "k": w["k"].transpose(2, 3).contiguous()
                           .transpose(2, 3)}),
        lambda: ops.wkv(**{**w, "u": w["u"][:1]}),
        lambda: ops.wkv(**wide),
        lambda: ops.ssm_scan(**{**s, "b": s["b"].bfloat16()}),
        lambda: ops.ssm_scan(**{**s, "dt": s["dt"].transpose(1, 2)
                                .contiguous().transpose(1, 2)}),
        lambda: ops.ssm_scan(**{**s, "log_a": s["log_a"][:, :2]}),
        lambda: ops.ssm_scan(**wide_s),
    ]


@pytest.mark.parametrize("case", range(8))
def test_recurrence_wrappers_refuse_bad_inputs(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()


@pytest.mark.parametrize("kernel", ["wkv", "ssm_scan"])
def test_cuda_path_raises_without_fallback(monkeypatch, kernel):
    """A CUDA tensor's call goes to the kernel: when the build fails the
    wrapper raises, and when the launch reports an error it raises that,
    never answering with the plain version or counting a launch."""
    args = (_torch(_wkv_inputs(1, 2, 4, 8, 8, seed=7)) if kernel == "wkv"
            else _torch(_ssm_inputs(1, 4, 6, 4, seed=8)))
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops.ref, f"{kernel}_ref", None)   # never called
    ops.reset_launches()

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(ops, kernel)(**args)

    class FailingLib:
        def __getattr__(self, fn):
            return lambda *a: 700            # cudaErrorIllegalAddress
    monkeypatch.setattr(build, "load", lambda name: FailingLib())
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="cudaError 700"):
        getattr(ops, kernel)(**args)
    assert ops.LAUNCHES[kernel] == 0


# ---------------------------------------------------------------------------
# smoke-size models against the JAX package
# ---------------------------------------------------------------------------
ARCH_CASES = {                   # arch, batch, prompt length, cache length
    "rwkv": ("rwkv6-1.6b", 2, 8, 16),
    "hymba": ("hymba-1.5b", 2, 8, 16),
    "hymba_long": ("hymba-1.5b", 1, 40, 48),
}
JAX_MODELS = {"ssm": jrwkv, "hybrid": jhybrid}


@pytest.fixture(scope="module", params=sorted(ARCH_CASES))
def model_runs(request):
    arch, B, T, cache_len = ARCH_CASES[request.param]
    jcfg = jsmoke(jget_config(arch))
    cfg = smoke_config(get_config(arch))
    jm = JAX_MODELS[jcfg.family]
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, T))

    logits, cache = jm.prefill(jparams, jcfg, jnp.asarray(tokens),
                               cache_len=cache_len)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    jouts, jtoks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        jtoks.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok[:, None])
        jouts.append(np.asarray(logits))

    api = build_model(cfg)
    ops.reset_launches()
    with torch.inference_mode():
        logits, state = api.prefill(params, {"tokens": torch.from_numpy(
            tokens)}, cache_len)
        touts, ttoks = [logits.numpy()], []
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(dim=-1)
            ttoks.append(tok.numpy())
            logits, state = api.decode_step(params, state,
                                            {"tokens": tok[:, None]})
            touts.append(logits.numpy())
    launches = dict(ops.LAUNCHES)
    return dict(cfg=cfg, jparams=jparams, params=params, jouts=jouts,
                touts=touts, jtoks=np.stack(jtoks, 1),
                ttoks=np.stack(ttoks, 1), launches=launches)


def test_prefill_and_decode_logits_match_jax(model_runs):
    errs = [_rel(t, j) for t, j in zip(model_runs["touts"],
                                       model_runs["jouts"])]
    assert len(errs) == STEPS + 1
    assert max(errs) <= MODEL_RTOL, errs


def test_greedy_tokens_match_jax(model_runs):
    np.testing.assert_array_equal(model_runs["ttoks"], model_runs["jtoks"])


def test_cpu_model_launches_no_kernel(model_runs):
    assert sum(model_runs["launches"].values()) == 0


def test_params_from_jax_keeps_nested_layout_and_dtypes(model_runs):
    cfg, jparams, params = (model_runs[k] for k in ("cfg", "jparams",
                                                    "params"))
    jl = jparams["layers"]
    assert len(params["layers"]) == cfg.n_layers
    if cfg.family == "ssm":
        for name in ("w0", "u", "wr"):
            np.testing.assert_array_equal(params["layers"][1][name].numpy(),
                                          np.asarray(jl[name][1]))
    else:
        for branch, name in (("ssm", "log_a"), ("ssm", "w_dt"),
                             ("attn", "wq"), ("mlp", "wg")):
            np.testing.assert_array_equal(
                params["layers"][1][branch][name].numpy(),
                np.asarray(jl[branch][name][1]))


def test_params_from_jax_bf16_keeps_f32_leaves():
    jcfg = jsmoke(jget_config("hymba-1.5b"))
    jparams = jhybrid.init_params(jax.random.PRNGKey(1), jcfg)  # bf16
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ssm = params["layers"][0]["ssm"]
    assert ssm["in_x"].dtype == torch.bfloat16
    for name in ("log_a", "w_dt", "dt_bias", "d_skip"):
        assert ssm[name].dtype == torch.float32
    np.testing.assert_array_equal(
        ssm["in_x"].float().numpy(),
        np.asarray(jparams["layers"]["ssm"]["in_x"][0], np.float32))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_serve_smoke_on_cpu(arch):
    lines = []
    ops.reset_launches()
    res = serve(ServeConfig(arch=arch, batch=2, prompt_len=8, max_new=4,
                            cache_len=16, device="cpu"),
                smoke=True, on_log=lines.append)
    text = "\n".join(lines)
    assert "self-check rel err" in text and "served batch=2" in text, text
    assert res["tokens"].shape == (2, 4)
    assert res["config"].family in ("ssm", "hybrid")
    assert res["self_check_err"] < 1e-5
    assert res["tp_schedule"].demotions == 0
    assert {"decode_first_s", "decode_median_s"} <= set(res["timings"])
    assert sum(ops.LAUNCHES.values()) == 0
