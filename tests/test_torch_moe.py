"""The port's MoE layer and the deepseek-moe-16b model against the JAX
package's, on the CPU at smoke size, f32.

- `layers.moe` against the reference's `layers.moe` on shared numpy
  weights and inputs made from a seed (8 experts, top 2, one shared
  expert): the sorted dispatch at 256 tokens in 16 groups of 16 (the
  smoke config's `moe_groups`; capacity 8 a group; the tokens share a
  direction, so they route unevenly, and some group sends 9 or more
  slots to an expert: slots are dropped, and the test asserts it), in
  one block (`moe_groups` 0), and at 2 tokens (a decode block); the
  dense dispatch; and capacity factor 0.25. Each
  within 1e-5 of the largest |value| (f32 products and sums in another
  order). Which slot is dropped is part of the function: both sort the
  slots stably by expert.
- The whole smoke model on the reference's weights
  (`convert.params_from_jax`): a (4, 64) prompt, 256 tokens through the
  grouped dispatch, then 4 greedy decode steps, with both dispatches;
  logits and the KV cache within 1e-4 of the largest |value|, equal
  tokens.
- `params_from_jax` carries the MoE leaves as they are.
- The "ep" and "local" dispatches, and "sorted" with `moe_local`, outside
  an EP context: the reference's `_moe_sorted_block` (one block, no
  `moe_groups`) on 256 tokens, against the reference's `moe` with the
  same dispatch and against `_moe_sorted_block` itself, within 1e-5.
- MoE trains: the API's `forward` / `loss_fn` and `make_manual_train_step`
  build and run (`test_torch_moe_train.py` holds them against the
  reference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.config import smoke_config as jsmoke

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train
from repro_torch.models import layers, transformer
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build

ARCH = "deepseek-moe-16b"
LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
B, T, CACHE, STEPS = 4, 64, 72, 4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _cfgs(**kw):
    return (dataclasses.replace(jsmoke(jget_config(ARCH)), **kw),
            dataclasses.replace(smoke_config(get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def weights():
    """One MoE layer's leaves in the reference's layout, numpy f32."""
    cfg = smoke_config(get_config(ARCH))
    rng = np.random.default_rng(29)
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    fs = fe * cfg.n_shared_experts

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"router": normal(d, E, scale=0.5),
            "wi": normal(E, d, fe, scale=d ** -0.5),
            "wg": normal(E, d, fe, scale=d ** -0.5),
            "wo": normal(E, fe, d, scale=fe ** -0.5),
            "shared": {"wi": normal(d, fs, scale=d ** -0.5),
                       "wg": normal(d, fs, scale=d ** -0.5),
                       "wo": normal(fs, d, scale=fs ** -0.5)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(v) for k, v in tree.items()}


def _x(batch, tokens, d, seed=30):
    """N(0, 1) tokens plus 0.3 times one shared direction: tokens that
    share a direction, as real activations do, route unevenly."""
    rng = np.random.default_rng(seed)
    u = np.random.default_rng(5).standard_normal(d)
    return (rng.standard_normal((batch, tokens, d)) + 0.3 * u).astype(
        np.float32)


_jmoe = jax.jit(lambda p, x, cfg, dispatch, cf: jlayers.moe(
    p, x, cfg, dispatch=dispatch, capacity_factor=cf),
    static_argnums=(2, 3, 4))


def _both(weights, x, dispatch, capacity_factor=1.25, **cfg_kw):
    jcfg, cfg = _cfgs(**cfg_kw)
    want = _jmoe(jax.tree.map(jnp.asarray, weights), jnp.asarray(x), jcfg,
                 dispatch, capacity_factor)
    got = layers.moe(_torch_tree(weights), torch.from_numpy(x), cfg,
                     dispatch=dispatch, capacity_factor=capacity_factor)
    return got.numpy(), np.asarray(want), cfg


def _reference_drops(weights, x, cfg, capacity_factor=1.25):
    """Slots the reference's sorted dispatch drops, from its own router
    (`lax.top_k` of the softmax) and capacity rule."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jnp.asarray(weights["router"]), axis=-1)
    topi = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    n, G = topi.shape[0], cfg.moe_groups
    G = G if G > 1 and n % G == 0 else 1
    cap = int(n // G * cfg.top_k * capacity_factor / cfg.n_experts) + 1
    cap = max(8, -(-cap // 8) * 8)
    counts = np.stack([np.bincount(g.reshape(-1), minlength=cfg.n_experts)
                       for g in topi.reshape(G, -1)])
    return int(np.maximum(counts - cap, 0).sum()), topi


def test_sorted_grouped_dispatch_drops_as_the_reference(weights):
    x = _x(4, 64, weights["router"].shape[0])
    got, want, cfg = _both(weights, x, "sorted")
    assert cfg.moe_groups == 16
    drops, topi = _reference_drops(weights, x, cfg)
    assert drops > 0, "this input must overflow an expert's capacity"
    assert layers.moe_drops(torch.tensor(topi), cfg) == drops
    assert _rel(got, want) <= LAYER_RTOL
    # the drops matter: the dense dispatch, which drops nothing, differs
    dense, _, _ = _both(weights, x, "dense")
    assert _rel(dense, want) > 1e-3


@pytest.mark.parametrize("case", ["one block", "decode block"])
def test_sorted_dispatch_without_groups(weights, case):
    d = weights["router"].shape[0]
    if case == "one block":
        got, want, cfg = _both(weights, _x(4, 64, d), "sorted", moe_groups=0)
    else:
        got, want, cfg = _both(weights, _x(2, 1, d), "sorted")
    assert _rel(got, want) <= LAYER_RTOL


@pytest.mark.parametrize("dispatch,groups", [("dense", 16), ("sorted", 16),
                                             ("sorted", 0)])
def test_dispatch_at_capacity_factor_quarter(weights, dispatch, groups):
    x = _x(4, 64, weights["router"].shape[0], seed=31)
    got, want, cfg = _both(weights, x, dispatch, capacity_factor=0.25,
                           moe_groups=groups)
    if dispatch == "sorted":
        assert _reference_drops(weights, x, cfg, 0.25)[0] > 0
    assert _rel(got, want) <= LAYER_RTOL


def test_dense_dispatch_matches_reference(weights):
    got, want, _ = _both(weights, _x(4, 64, weights["router"].shape[0]),
                         "dense")
    assert _rel(got, want) <= LAYER_RTOL


def test_router_breaks_ties_to_the_lower_expert():
    """Equal probabilities: `lax.top_k` takes the lower index first, and
    so does the port's stable descending sort."""
    p = {"router": torch.zeros((4, 8))}
    p["router"][:, 5] = 1.0
    xt = torch.ones((3, 4))
    _, topv, topi = layers.moe_route(p, xt, 3)
    want = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.ones((3, 4)) @ jnp.asarray(p["router"].numpy()), -1), 3)[1])
    np.testing.assert_array_equal(topi.numpy(), want)
    assert topi[0].tolist() == [5, 0, 1]


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jparams = jtransformer.init_params(jax.random.PRNGKey(3), jcfg,
                                       dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    return jcfg, jparams, cfg, params, tokens


def _jax_run(jcfg, jparams, tokens, dispatch):
    logits, cache = jtransformer.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         cache_len=CACHE,
                                         moe_dispatch=dispatch)
    step = jax.jit(lambda p, c, t: jtransformer.decode_step(
        p, jcfg, c, t, moe_dispatch=dispatch))
    outs, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        toks.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok[:, None])
        outs.append(np.asarray(logits))
    return outs, np.stack(toks, 1), np.asarray(cache["k"])


def _torch_run(cfg, params, tokens, dispatch):
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, cfg,
                                            torch.from_numpy(tokens),
                                            cache_len=CACHE,
                                            moe_dispatch=dispatch)
        outs, toks = [logits.numpy()], []
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(dim=-1)
            toks.append(tok.numpy())
            logits, cache = transformer.decode_step(
                params, cfg, cache, tok[:, None], moe_dispatch=dispatch)
            outs.append(logits.numpy())
    return outs, np.stack(toks, 1), cache["k"].numpy()


@pytest.fixture(scope="module", params=["sorted", "dense"])
def runs(request, models):
    jcfg, jparams, cfg, params, tokens = models
    return (_jax_run(jcfg, jparams, tokens, request.param),
            _torch_run(cfg, params, tokens, request.param))


def test_model_logits_match_jax(runs):
    (jo, _, _), (to, _, _) = runs
    for step, (got, want) in enumerate(zip(to, jo)):
        assert _rel(got, want) <= MODEL_RTOL, step


def test_model_tokens_and_cache_match_jax(runs):
    (_, jt, jk), (_, tt, tk) = runs
    np.testing.assert_array_equal(tt, jt)
    assert _rel(tk, jk) <= MODEL_RTOL


def test_model_prefill_drops_slots(models):
    """The (4, 64) prompt overflows a group's capacity in the first
    layer, so the model test covers a drop."""
    _, _, cfg, params, tokens = models
    lp = params["layers"][0]
    with torch.inference_mode():
        x = layers.embed(params["embed"], torch.from_numpy(tokens))
        z = layers.rmsnorm(x, lp["ln1"])
        x = x + layers.attention(lp["attn"], z, cfg)
        z = layers.rmsnorm(x, lp["ln2"])
        _, _, topi = layers.moe_route(lp["moe"], z.reshape(-1, cfg.d_model),
                                      cfg.top_k)
    assert layers.moe_drops(topi, cfg) > 0


def test_params_from_jax_carries_moe_leaves(models):
    jcfg, jparams, cfg, params, _ = models
    jm = jparams["layers"]["moe"]
    for i, lp in enumerate(params["layers"]):
        assert "mlp" not in lp
        m = lp["moe"]
        assert m["router"].dtype == torch.float32
        assert m["wi"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
        assert m["wo"].shape == (cfg.n_experts, cfg.d_ff_expert, cfg.d_model)
        for name in ("router", "wi", "wg", "wo"):
            np.testing.assert_array_equal(m[name].numpy(),
                                          np.asarray(jm[name][i]))
        for name in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(
                m["shared"][name].numpy(), np.asarray(jm["shared"][name][i]))


def test_port_init_has_the_reference_leaves(models):
    """The port's own init gives the reference's leaf names, shapes and
    dtypes (bf16 weights, an f32 router)."""
    _, jparams, cfg, _, _ = models
    spec = build(cfg).params_spec()
    jspec = jax.eval_shape(lambda: jtransformer.init_params(
        jax.random.PRNGKey(0), _cfgs()[0]))
    flat = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_leaves_with_path(jspec)}

    def walk(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{path}['{k}']")
            else:
                yield f"{path}['{k}']", (tuple(v.shape),
                                         str(v.dtype).removeprefix("torch."))

    assert dict(walk(spec)) == flat


# ---------------------------------------------------------------------------
# the dispatches outside an EP context, and training
# ---------------------------------------------------------------------------
def _reference_sorted_block(weights, x, cfg):
    """The reference's `_moe_sorted_block` on its own router's top k, plus
    the shared experts, in x's dtype."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    p = jax.tree.map(jnp.asarray, weights)
    probs = jax.nn.softmax(xt @ p["router"], axis=-1)
    topv, topi = jax.lax.top_k(probs, cfg.top_k)
    topv = topv / (topv.sum(-1, keepdims=True) + 1e-9)
    out = jlayers._moe_sorted_block(xt, topi, topv, p, cfg.n_experts,
                                    cfg.top_k, cfg.d_model, 1.25)
    out = out + jlayers.mlp(p["shared"], xt).astype(jnp.float32)
    return np.asarray(out).reshape(x.shape)


@pytest.mark.parametrize("dispatch", ["ep", "local"])
def test_expert_parallel_dispatch_raises(weights, dispatch):
    """Outside an EP context (and with no GSPMD mesh, which the port does
    not have) "ep" and "local" are the reference's sorted block without
    groups: 256 tokens in one block, not the smoke config's 16 groups."""
    x = _x(4, 64, weights["router"].shape[0])
    got, want, cfg = _both(weights, x, dispatch)
    assert cfg.moe_groups == 16
    assert _rel(got, want) <= LAYER_RTOL
    assert _rel(got, _reference_sorted_block(weights, x, cfg)) <= LAYER_RTOL
    grouped, _, _ = _both(weights, x, "sorted")
    assert _rel(grouped, want) > 1e-3


def test_moe_local_config_raises(weights):
    """`moe_local` turns "sorted" into the reference's shard_map dispatch,
    which without a mesh is the sorted block without groups."""
    x = _x(4, 64, weights["router"].shape[0])
    got, want, cfg = _both(weights, x, "sorted", moe_local=True)
    assert cfg.moe_local
    assert _rel(got, want) <= LAYER_RTOL
    assert _rel(got, _reference_sorted_block(weights, x, cfg)) <= LAYER_RTOL


def test_moe_does_not_train():
    """MoE trains now: the API's `forward` / `loss_fn`, `transformer.forward`
    and the ZeRO-3 step on 8 ranks (expert-parallel over "data") build
    and run at smoke size on the CPU."""
    api = build(smoke_config(get_config(ARCH)))
    params = api.init_params(torch.Generator().manual_seed(0),
                             torch.float32)
    tokens = torch.randint(0, api.cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    logits = api.forward(params, batch)
    assert logits.shape == (2, 8, api.cfg.vocab)
    assert torch.equal(logits, transformer.forward(params, api.cfg, tokens))
    w = params["layers"][0]["moe"]["wi"].requires_grad_(True)
    loss = api.loss_fn(params, batch)
    assert loss.ndim == 0 and torch.isfinite(loss)
    loss.backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    w.requires_grad_(False)
    step = train.make_manual_train_step(api, 8, device="cpu",
                                        param_dtype=torch.float32)
    assert step.ep == ("data", 8)
    shards = train.shard_params_zero3(params, 8)
    state = {"params": shards, "opt": train.adamw_init(shards)}
    batch = {k: torch.randint(0, api.cfg.vocab, (8, 16),
                              generator=torch.Generator().manual_seed(2))
             for k in ("tokens", "labels")}
    _, m = step(state, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["gnorm"])
