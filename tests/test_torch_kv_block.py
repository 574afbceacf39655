"""The KV-block attention scan (`ModelConfig.attn_kv_block`, the
reference's dry-run knob `kvblock=N`) against the JAX package's, on the
CPU at smoke size in f32.

- `layers.train_attention` with `attn_kv_block` against the reference's
  `attention` on the same inputs and weights, and its gradients (of the
  input and the four projections, under a fixed cotangent) against
  `jax.grad`: causal, non-causal, non-causal windowed and soft-capped
  take the KV-block scan; causal windowed takes the banded path first,
  as the reference's branch order does. Within 1e-5 of the largest
  |value| of each compared tensor (f32 sums in another order; measured
  at most 4e-7 on values of order 1);
- the smoke transformer's loss and gradients with `attn_kv_block`
  against the reference's `loss_fn` and `jax.value_and_grad` on the
  reference's own weights (`convert.params_from_jax`), within 1e-5;
- a smoke model with `attn_kv_block` serves: prefill and greedy decode
  give the tokens and logits of the same model without it (prefill and
  decode keep the `flash_attention` kernel, which tiles the keys
  itself).
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
from repro_torch.models import layers
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unstack_layers)

TOL = 1e-5
BK = 16                       # the KV block: 4 blocks of the 64 keys
T = 64
BQ = 32
# (causal, window, softcap, the path train_attention takes)
CASES = {"causal": (True, 0, 0.0, "kv"),
         "causal_windowed": (True, 24, 0.0, "banded"),
         "noncausal": (False, 0, 0.0, "kv"),
         "noncausal_windowed": (False, 20, 0.0, "kv"),
         "softcapped": (True, 0, 30.0, "kv")}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _cfgs(arch="stablelm-12b", **kw):
    j = dataclasses.replace(jsmoke(jget_config(arch)), attn_kv_block=BK,
                            **kw)
    t = dataclasses.replace(smoke_config(get_config(arch)),
                            attn_kv_block=BK, **kw)
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_train_attention_matches_reference(case, monkeypatch):
    causal, window, softcap, path = CASES[case]
    jc, tc = _cfgs(attn_softcap=softcap)
    rng = np.random.default_rng(1)
    D, hq, hkv = jc.d_model, jc.n_heads * jc.head_dim, \
        jc.n_kv_heads * jc.head_dim
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    w = {"wq": (D, hq), "wk": (D, hkv), "wv": (D, hkv), "wo": (hq, D)}
    w = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in w.items()}
    ct = rng.standard_normal((2, T, D)).astype(np.float32)

    def jf(x, p):
        out = jlayers.attention(p, x, jc, window=window, causal=causal,
                                block_q=BQ)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})

    calls = []
    scan = layers._kv_block_scan
    monkeypatch.setattr(layers, "_kv_block_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    tx = torch.tensor(x, requires_grad=True)
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    out = layers.train_attention(tw, tx, tc, window=window, causal=causal,
                                 block_q=BQ)
    (out * torch.tensor(ct)).sum().backward()
    assert bool(calls) == (path == "kv")
    assert _rel(out.detach(), jout) <= TOL
    assert _rel(tx.grad, jg[0]) <= TOL
    for k in w:
        assert _rel(tw[k].grad, jg[1][k]) <= TOL, k


def test_kv_block_not_dividing_takes_the_q_blocks(monkeypatch):
    """bk not dividing Tk (or not below it) is the q-block path, as the
    reference's condition `Tk % bk == 0 and bk < Tk`."""
    calls = []
    monkeypatch.setattr(layers, "_kv_block_scan",
                        lambda *a, **k: calls.append(1))
    for bk in (24, T):
        tc = dataclasses.replace(smoke_config(get_config("stablelm-12b")),
                                 attn_kv_block=bk)
        D = tc.d_model
        p = {k: torch.zeros(s) for k, s in (
            ("wq", (D, 64)), ("wk", (D, 16)), ("wv", (D, 16)),
            ("wo", (64, D)))}
        layers.train_attention(p, torch.zeros(1, T, D), tc, block_q=BQ)
    assert calls == []


def _leaf_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma2-27b"])
def test_loss_and_grads_match_reference(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (2, T)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (2, T)).astype(np.int32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jc,
                                       jnp.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(p, jc, jbatch, remat=True))(jparams)
    want = {_leaf_key(path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}

    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    api = build(tc)
    items = tree_items(stack_layers(params))
    paths = [p for p, _ in items]
    leaves = [t.detach().requires_grad_(True) for _, t in items]
    batch = {"tokens": torch.tensor(tokens).long(),
             "labels": torch.tensor(labels).long()}
    loss = api.loss_fn(unstack_layers(tree_from_items(zip(paths, leaves))),
                       batch, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(loss.detach(), jloss) <= TOL
    assert len(grads) == len(want)
    for path, g in zip(paths, grads):
        assert _rel(g, want["/".join(path)]) <= TOL, path


@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma2-27b"])
def test_served_tokens_match_without_kv_block(arch):
    """The same weights with and without `attn_kv_block`: prefill logits
    and four greedy decode steps agree exactly."""
    _, tc = _cfgs(arch)
    plain = dataclasses.replace(tc, attn_kv_block=0)
    params = build(plain).init_params(torch.Generator().manual_seed(0),
                                      torch.float32, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (2, 40)))
    runs = []
    for cfg in (plain, tc):
        api = build(cfg)
        logits, cache = api.prefill(params, {"tokens": prompt},
                                    cache_len=48)
        seen, toks = [logits], []
        for _ in range(4):
            tok = logits[:, -1:].argmax(-1)
            toks.append(tok)
            logits, cache = api.decode_step(params, cache, {"tokens": tok})
            seen.append(logits)
        runs.append((torch.cat(toks, 1), seen))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
