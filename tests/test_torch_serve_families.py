"""whisper-large-v3, qwen2-vl-7b and mixtral-8x22b: the port's
encoder-decoder and transformer against the JAX package's, on the CPU at
smoke size, f32.

Each runs a prompt and 4 greedy decode steps on the reference's weights
(`convert.params_from_jax`): prefill and decode logits and the caches
(self-attention K/V; whisper's cross-attention `xk` / `xv` too) within
1e-4 of the largest |value|, the same tokens.
- whisper-large-v3 (`models/encdec.py`): 12 frames of N(0, 1) stub audio
  embeddings through the non-causal encoder, a 6-token prompt, at the
  smoke head dim 16 and at 64 (the served one, 1280 / 20).
- qwen2-vl-7b: the prompt is N(0, 1) embeddings and three distinct t/h/w
  M-RoPE position streams (drawn in [0, 2048)); a decode step feeds the
  embedding rows of the chosen token, as the reference's server. At the
  smoke head dim 16 the sections (8, 4, 4) are cut to the 8 rotary
  frequencies and every lane takes the t stream (M-RoPE is RoPE there),
  so the cases run at head dim 32 with (8, 4, 4) and at 128 with the
  served (16, 24, 24); a test
  shows that the h and w streams move the prefill logits on both sides
  there, and not at 16.
- mixtral-8x22b: a (4, 40) prompt, 160 tokens through the 16-group
  sorted dispatch, past the 32-key smoke window (its 4096 on every layer
  at full size), in a 48-slot cache.
Then: `serve` with `ServeConfig(n_layers=…)` and the `serve` CLI at
smoke size on the CPU for the three; whisper's `params_spec` against the
reference's and the `stack_layers` / `unstack_layers` round trip; the
training entry points of the vlm and audio families give a finite loss
and a gradient for every leaf (their training against the reference's
is `test_torch_family_train.py`).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro.models.config import smoke_config as jsmoke
from repro.models.registry import build as jbuild

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import encdec, transformer
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unstack_layers)

RTOL = 1e-4
STEPS = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# (batch, prompt, cache) of each config's run; whisper's stub frames
RUN = {"whisper-large-v3": (2, 6, 16), "qwen2-vl-7b": (2, 8, 16),
       "mixtral-8x22b": (4, 40, 48)}
FRAMES = 12
# (arch, config overrides on both sides)
CASES = [("whisper-large-v3", {}),
         ("whisper-large-v3", {"d_head": 64}),
         ("qwen2-vl-7b", {"d_head": 32}),
         ("qwen2-vl-7b", {"d_head": 128, "mrope_sections": (16, 24, 24)}),
         ("mixtral-8x22b", {})]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _cfgs(arch, kw):
    return (dataclasses.replace(jsmoke(jget_config(arch)), **kw),
            dataclasses.replace(smoke_config(get_config(arch)), **kw))


def _inputs(cfg, seed=7):
    """The prompt's numpy inputs: token ids; for whisper the frames, for
    qwen2-vl the embeddings and three distinct position streams."""
    B, T, _ = RUN[cfg.name]
    rng = np.random.default_rng(seed)
    inp = {"tokens": rng.integers(0, cfg.vocab, (B, T))}
    if cfg.family == "audio":
        inp["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        inp["embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
        # t, h and w drawn apart over a long context's range, so that
        # the h and w sections (M-RoPE's lowest frequencies) turn far
        inp["mrope"] = rng.integers(0, 2048, (3, B, T))
    return inp


def _jax_prefill(jparams, jcfg, inp, cache_len):
    if jcfg.family == "audio":
        return jencdec.prefill(jparams, jcfg, jnp.asarray(inp["tokens"]),
                               frames=jnp.asarray(inp["frames"]),
                               cache_len=cache_len)
    if jcfg.family == "vlm":
        return jtransformer.prefill(
            jparams, jcfg, None, cache_len=cache_len,
            embeds=jnp.asarray(inp["embeds"]),
            mrope_positions=jnp.asarray(inp["mrope"], jnp.int32))
    return jtransformer.prefill(jparams, jcfg, jnp.asarray(inp["tokens"]),
                                cache_len=cache_len)


def _jax_step(jparams, jcfg, cache, tok):
    if jcfg.family == "audio":
        return jencdec.decode_step(jparams, jcfg, cache, tok[:, None])
    if jcfg.family == "vlm":
        emb = jnp.take(jparams["embed"], tok[:, None], axis=0)
        return jtransformer.decode_step(jparams, jcfg, cache, None,
                                        embeds=emb)
    return jtransformer.decode_step(jparams, jcfg, cache, tok[:, None])


def _port_prefill(params, cfg, inp, cache_len):
    if cfg.family == "audio":
        return encdec.prefill(params, cfg, torch.from_numpy(inp["tokens"]),
                              frames=torch.from_numpy(inp["frames"]),
                              cache_len=cache_len)
    if cfg.family == "vlm":
        return transformer.prefill(
            params, cfg, None, cache_len=cache_len,
            embeds=torch.from_numpy(inp["embeds"]),
            mrope_positions=torch.from_numpy(inp["mrope"]).long())
    return transformer.prefill(params, cfg, torch.from_numpy(inp["tokens"]),
                               cache_len=cache_len)


def _port_step(params, cfg, cache, tok):
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, cache, tok[:, None])
    if cfg.family == "vlm":
        return transformer.decode_step(params, cfg, cache, None,
                                       embeds=params["embed"][tok[:, None]])
    return transformer.decode_step(params, cfg, cache, tok[:, None])


def _weights(arch, kw, seed=0):
    jcfg, cfg = _cfgs(arch, kw)
    init = jencdec.init_params if jcfg.family == "audio" \
        else jtransformer.init_params
    jparams = init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams))


def _cache_arrays(cache):
    keys = ("k", "v", "xk", "xv")
    return {k: np.asarray(cache[k]) for k in keys if k in cache}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-" + ("-".join(f"{k}{v}" for k, v in kw.items())
                                or "smoke") for a, kw in CASES])
def runs(request):
    arch, kw = request.param
    jcfg, cfg, jparams, params = _weights(arch, kw)
    cache_len = RUN[arch][2]
    inp = _inputs(cfg)

    logits, cache = jax.jit(lambda p: _jax_prefill(p, jcfg, inp, cache_len))(
        jparams)
    step = jax.jit(lambda p, c, t: _jax_step(p, jcfg, c, t))
    jouts, jtoks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        jtoks.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok)
        jouts.append(np.asarray(logits))
    jcache = _cache_arrays(cache)

    with torch.inference_mode():
        logits, cache = _port_prefill(params, cfg, inp, cache_len)
        touts, ttoks = [logits.numpy()], []
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(dim=-1)
            ttoks.append(tok.numpy())
            logits, cache = _port_step(params, cfg, cache, tok)
            touts.append(logits.numpy())
    tcache = {k: v.numpy() for k, v in cache.items() if k != "pos"}
    return (cfg, (jouts, np.stack(jtoks, 1), jcache),
            (touts, np.stack(ttoks, 1), tcache))


def test_configs_keep_their_features(runs):
    cfg = runs[0]
    full = get_config(cfg.name)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jget_config(cfg.name))
    if cfg.name == "whisper-large-v3":
        assert cfg.family == "audio" and cfg.n_encoder_layers == 2
        assert full.n_encoder_layers == 32 and full.head_dim == 64
    elif cfg.name == "qwen2-vl-7b":
        assert cfg.family == "vlm" and cfg.embeds_input
        assert full.mrope_sections == (16, 24, 24) and full.head_dim == 128
        # the rotary half covers every section: M-RoPE is live here
        assert cfg.head_dim // 2 > cfg.mrope_sections[0]
    else:
        assert cfg.family == "moe" and cfg.moe_groups == 16
        assert full.window_pattern == (4096,) and cfg.window_pattern == (32,)
        B, T, _ = RUN[cfg.name]
        assert (B * T) % cfg.moe_groups == 0 and T > cfg.window_pattern[0]


def test_prefill_logits_match_jax(runs):
    _, (jo, *_), (to, *_) = runs
    assert _rel(to[0], jo[0]) <= RTOL


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_logits_match_jax(runs, step):
    _, (jo, *_), (to, *_) = runs
    assert _rel(to[step], jo[step]) <= RTOL


def test_greedy_tokens_match_jax(runs):
    _, (_, jt, _), (_, tt, _) = runs
    np.testing.assert_array_equal(tt, jt)


def test_caches_match_jax(runs):
    cfg, (_, _, jc), (_, _, tc) = runs
    assert sorted(tc) == sorted(jc) == (
        ["k", "v", "xk", "xv"] if cfg.family == "audio" else ["k", "v"])
    for k in jc:
        assert _rel(tc[k], jc[k]) <= RTOL, k
    if cfg.family == "audio":
        assert tc["xk"].shape[3] == FRAMES


@pytest.mark.parametrize("d_head,sections,live", [
    (16, (8, 4, 4), False), (32, (8, 4, 4), True),
    (128, (16, 24, 24), True)])
def test_mrope_h_w_streams_move_prefill_logits(d_head, sections, live):
    """The same prompt with three distinct position streams and with the
    t stream in all three: on both sides the logits differ where the
    rotary half reaches the h and w sections, and are equal at the smoke
    head dim 16, where M-RoPE is RoPE on the t stream."""
    kw = {"d_head": d_head, "mrope_sections": sections}
    jcfg, cfg, jparams, params = _weights("qwen2-vl-7b", kw)
    inp = _inputs(cfg)
    t_only = dict(inp, mrope=np.broadcast_to(inp["mrope"][:1],
                                             inp["mrope"].shape).copy())
    cache_len = RUN["qwen2-vl-7b"][2]
    jl = [np.asarray(_jax_prefill(jparams, jcfg, x, cache_len)[0])
          for x in (inp, t_only)]
    with torch.inference_mode():
        tl = [_port_prefill(params, cfg, x, cache_len)[0].numpy()
              for x in (inp, t_only)]
    assert _rel(tl[0], jl[0]) <= RTOL and _rel(tl[1], jl[1]) <= RTOL
    for a, b in (jl, tl):
        moved = _rel(a, b)
        assert (moved > 1e-3) if live else (moved <= 1e-6), moved


def test_mixtral_prefill_takes_the_grouped_dispatch():
    from repro_torch.models import layers
    cfg = smoke_config(get_config("mixtral-8x22b"))
    B, T, _ = RUN[cfg.name]
    assert layers.moe_blocks(cfg, B * T) == 16
    assert layers.moe_blocks(cfg, B) == 1


def test_whisper_leaves_come_from_jax():
    jcfg, cfg, jparams, params = _weights("whisper-large-v3", {}, seed=1)
    assert len(params["encoder"]) == cfg.n_encoder_layers
    assert len(params["decoder"]) == cfg.n_layers
    for stack in ("encoder", "decoder"):
        for path, leaf in tree_items(jparams[stack]):
            node = params[stack][1]
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[1])
    for k in ("ln_enc", "ln_f", "embed", "lm_head"):
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b",
                                  "mixtral-8x22b"])
def test_params_spec_matches_reference(arch):
    """The full-size configuration's leaves in the reference's order, with
    its stacked shapes and dtypes."""
    want = jax.tree_util.tree_flatten_with_path(
        jbuild(jget_config(arch)).params_spec())[0]
    got = tree_items(build(get_config(arch)).params_spec())
    assert [tuple(k.key for k in p) for p, _ in want] == [p for p, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
        assert str(w.dtype) == str(g.dtype).removeprefix("torch.")


def test_whisper_stack_layers_round_trip():
    _, cfg, jparams, params = _weights("whisper-large-v3", {}, seed=2)
    stacked = stack_layers(params)
    want = dict(tree_items(jax.tree.map(np.asarray, jparams)))
    got = dict(tree_items(stacked))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    back = unstack_layers(stacked)
    for stack in ("encoder", "decoder"):
        assert len(back[stack]) == len(params[stack])
        for lb, lp in zip(back[stack], params[stack]):
            for (pb, tb), (pp, tp) in zip(tree_items(lb), tree_items(lp)):
                assert pb == pp and torch.equal(tb, tp)


def test_stack_layers_keeps_the_decoder_only_layout():
    """A tree without encoder or decoder stacks comes out as before: the
    one "layers" key stacked, every other key as it is."""
    _, cfg, _, params = _weights("mixtral-8x22b", {})
    stacked = stack_layers(params)
    assert list(stacked) == list(params)
    assert stacked["embed"] is params["embed"]
    assert stacked["layers"]["moe"]["wi"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b"])
def test_served_only_families_refuse_training(arch):
    """The former refusals (ROADMAP §1 item 6e) lifted: `forward` gives
    finite logits and `loss_fn` a finite loss whose gradient reaches
    every leaf (qwen2-vl's tokens through its `embed`)."""
    _, cfg, _, params = _weights(arch, {})
    api = build(cfg)
    inp = _inputs(cfg)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["tokens"])}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(inp["frames"])
    B, T = batch["tokens"].shape
    logits = api.forward(params, batch)
    assert logits.shape == (B, T, cfg.vocab)
    assert torch.isfinite(logits).all()
    items = tree_items(stack_layers(params))
    leaves = [t.requires_grad_(True) for _, t in items]
    loss = api.loss_fn(unstack_layers(tree_from_items(
        (p, t) for (p, _), t in zip(items, leaves))), batch)
    assert torch.isfinite(loss) and loss.ndim == 0
    for (path, _), g in zip(items, torch.autograd.grad(loss, leaves)):
        assert torch.isfinite(g).all() and g.any(), path


def test_mixtral_trains_at_smoke_size():
    _, cfg, _, params = _weights("mixtral-8x22b", {})
    tokens = torch.from_numpy(_inputs(cfg)["tokens"])
    loss = build(cfg).loss_fn(params, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss) and loss.ndim == 0


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b",
                                  "mixtral-8x22b"])
def test_serve_smoke_with_cut_depth_on_cpu(arch):
    lines = []
    ops.reset_launches()
    res = serve(ServeConfig(arch=arch, batch=2, prompt_len=8, max_new=4,
                            cache_len=16, n_layers=1, device="cpu"),
                smoke=True, on_log=lines.append)
    text = "\n".join(lines)
    assert "self-check rel err" in text and "served batch=2" in text
    cfg = res["config"]
    assert cfg.name == arch and cfg.n_layers == 1
    assert cfg.n_encoder_layers == (2 if arch == "whisper-large-v3" else 0)
    toks = res["tokens"]
    assert toks.shape == (2, 4) and 0 <= toks.min() and \
        toks.max() < cfg.vocab
    assert res["self_check_err"] < 1e-5
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-7b",
                                  "mixtral-8x22b"])
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--max-new", "3",
         "--local-ranks", "4", "--n-layers", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "served batch=2 prompt=32 new=3" in proc.stdout
