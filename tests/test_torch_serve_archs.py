"""qwen3-32b and gemma3-4b: the port's transformer against the JAX
package's, on the CPU at smoke size, f32.

qwen3-32b brings `qk_norm` (an RMSNorm over each head's rows of q and k,
head-transposed (B, H, T, hd) rows through the `rmsnorm` wrapper);
gemma3-4b five 32-key local layers to one global one (its smoke
window). Each runs a prompt and 4 greedy decode steps on the reference's
weights (`convert.params_from_jax`): prefill and decode logits and the
KV cache within 1e-4 of the largest |value|, the same tokens. gemma3-4b
runs at batch 2, a 40-token prompt and a 48-slot cache, past its
window, so the local layers mask keys in prefill and decode. Each also
runs with `d_head` replaced by 80 and by 256 on both sides: the served
head dims (qwen3-32b's 5120 / 64, gemma3-4b's 256).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.models.config import smoke_config as jsmoke

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import transformer
from repro_torch.models.config import smoke_config

RTOL = 1e-4
STEPS = 4
# (batch, prompt, cache) of each config's run
RUN = {"qwen3-32b": (2, 8, 16), "gemma3-4b": (2, 40, 48)}
CASES = [(arch, d_head) for arch in RUN for d_head in (None, 80, 256)]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _cfgs(arch, d_head):
    kw = {} if d_head is None else {"d_head": d_head}
    return (dataclasses.replace(jsmoke(jget_config(arch)), **kw),
            dataclasses.replace(smoke_config(get_config(arch)), **kw))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-hd{d or 'smoke'}" for a, d in CASES])
def runs(request):
    arch, d_head = request.param
    jcfg, cfg = _cfgs(arch, d_head)
    B, T, cache_len = RUN[arch]
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg,
                                       dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, T))

    logits, cache = jax.jit(lambda p, t: jtransformer.prefill(
        p, jcfg, t, cache_len=cache_len))(jparams, jnp.asarray(tokens))
    step = jax.jit(lambda p, c, t: jtransformer.decode_step(p, jcfg, c, t))
    jouts, jtoks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        jtoks.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok[:, None])
        jouts.append(np.asarray(logits))
    jk, jv = np.asarray(cache["k"]), np.asarray(cache["v"])

    with torch.inference_mode():
        logits, cache = transformer.prefill(params, cfg,
                                            torch.from_numpy(tokens),
                                            cache_len=cache_len)
        touts, ttoks = [logits.numpy()], []
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(dim=-1)
            ttoks.append(tok.numpy())
            logits, cache = transformer.decode_step(params, cfg, cache,
                                                    tok[:, None])
            touts.append(logits.numpy())
    return (cfg, (jouts, np.stack(jtoks, 1), jk, jv),
            (touts, np.stack(ttoks, 1), cache["k"].numpy(),
             cache["v"].numpy()))


def test_configs_keep_their_features(runs):
    cfg = runs[0]
    if cfg.name == "qwen3-32b":
        assert cfg.qk_norm and cfg.rope_theta == 1e6
        assert get_config(cfg.name).head_dim == 80
    else:
        assert cfg.window_pattern == (32,) * 5 + (0,)
        assert [cfg.window_for_layer(i) for i in range(7)] == \
            [32] * 5 + [0, 32]
        assert get_config(cfg.name).head_dim == 256
        assert RUN[cfg.name][1] > cfg.window_pattern[0]


def test_prefill_logits_match_jax(runs):
    _, (jo, *_), (to, *_) = runs
    assert _rel(to[0], jo[0]) <= RTOL


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_logits_match_jax(runs, step):
    _, (jo, *_), (to, *_) = runs
    assert _rel(to[step], jo[step]) <= RTOL


def test_greedy_tokens_match_jax(runs):
    _, (_, jt, *_), (_, tt, *_) = runs
    np.testing.assert_array_equal(tt, jt)


def test_kv_cache_matches_jax(runs):
    _, (_, _, jk, jv), (_, _, tk, tv) = runs
    assert _rel(tk, jk) <= RTOL
    assert _rel(tv, jv) <= RTOL


def test_qk_norm_leaves_come_from_jax():
    jcfg, cfg = _cfgs("qwen3-32b", None)
    jparams = jtransformer.init_params(jax.random.PRNGKey(1), jcfg,
                                       dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name in ("q_norm", "k_norm"):
        got = params["layers"][1]["attn"][name]
        assert got.shape == (cfg.head_dim,)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jparams["layers"]["attn"][name][1]))


@pytest.mark.parametrize("arch", list(RUN))
def test_serve_smoke_on_cpu(arch):
    lines = []
    ops.reset_launches()
    B, T, cache_len = RUN[arch]
    res = serve(ServeConfig(arch=arch, batch=B, prompt_len=T, max_new=4,
                            cache_len=cache_len, device="cpu"),
                smoke=True, on_log=lines.append)
    text = "\n".join(lines)
    assert "self-check rel err" in text and f"served batch={B}" in text
    assert res["config"].name == arch
    assert res["tokens"].shape == (B, 4)
    assert res["self_check_err"] < 1e-5
    assert sum(ops.LAUNCHES.values()) == 0
