"""The port's dense transformer and server against the JAX package's, on
the CPU at smoke size.

The JAX model is initialized in f32 by its own `init_params`; the port
runs on the same weights through `convert.params_from_jax`. Prefill and
decode logits agree to 1e-4 relative to the largest |logit| (f32 matmuls
and softmax sums in another order), and greedy decoding picks the same
tokens for the first 4 steps.
"""
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
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import layers, transformer
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.runtime.device import resolve_device

RTOL = 1e-4
B, T, CACHE, STEPS = 2, 8, 16, 4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def both_models():
    jcfg = jsmoke(jget_config("stablelm-12b"))
    cfg = smoke_config(get_config("stablelm-12b"))
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg,
                                       dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, T))
    return jcfg, jparams, cfg, params, tokens


@pytest.fixture(scope="module")
def jax_run(both_models):
    jcfg, jparams, _, _, tokens = both_models
    logits, cache = jtransformer.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         cache_len=CACHE)
    step = jax.jit(lambda p, c, t: jtransformer.decode_step(p, jcfg, c, t))
    outs = [np.asarray(logits)]
    tok = jnp.argmax(logits[:, -1], axis=-1)
    toks = [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = step(jparams, cache, tok[:, None])
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], axis=-1)
        toks.append(np.asarray(tok))
    return outs, np.stack(toks, 1), np.asarray(cache["k"])


@pytest.fixture(scope="module")
def torch_run(both_models):
    _, _, cfg, params, tokens = both_models
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, cfg,
                                            torch.from_numpy(tokens),
                                            cache_len=CACHE)
        outs = [logits.numpy()]
        tok = logits[:, -1].argmax(dim=-1)
        toks = [tok.numpy()]
        for _ in range(STEPS):
            logits, cache = transformer.decode_step(params, cfg, cache,
                                                    tok[:, None])
            outs.append(logits.numpy())
            tok = logits[:, -1].argmax(dim=-1)
            toks.append(tok.numpy())
    return outs, np.stack(toks, 1), cache["k"].numpy()


def test_params_from_jax_layout(both_models):
    jcfg, jparams, cfg, params, _ = both_models
    assert len(params["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wq"].numpy(),
        np.asarray(jparams["layers"]["attn"]["wq"][1]))
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab)


def test_prefill_logits_match_jax(jax_run, torch_run):
    assert torch_run[0][0].shape == jax_run[0][0].shape
    assert _rel(torch_run[0][0], jax_run[0][0]) <= RTOL


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_logits_match_jax(jax_run, torch_run, step):
    assert _rel(torch_run[0][step], jax_run[0][step]) <= RTOL


def test_greedy_tokens_match_jax(jax_run, torch_run):
    np.testing.assert_array_equal(torch_run[1][:, :STEPS],
                                  jax_run[1][:, :STEPS])


def test_kv_cache_matches_jax(jax_run, torch_run):
    assert torch_run[2].shape == jax_run[2].shape
    assert _rel(torch_run[2], jax_run[2]) <= RTOL


@pytest.mark.parametrize("window,causal", [(0, True), (3, True),
                                           (0, False)])
def test_attention_matches_jax(both_models, window, causal):
    """Full-sequence attention, q-block by q-block (block_q 4 over T 8),
    with a sliding window and without the causal mask, against the
    reference's `layers.attention` on the same weights and inputs."""
    jcfg, jparams, cfg, params, _ = both_models
    x = np.random.default_rng(8).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want = jlayers.attention(jp, jnp.asarray(x), jcfg, window=window,
                             causal=causal, block_q=4)
    got = layers.attention(params["layers"][0]["attn"], torch.from_numpy(x),
                           cfg, window=window, causal=causal, block_q=4)
    assert _rel(got.numpy(), want) <= RTOL


def test_registry_builds_dense_only():
    api = build(smoke_config(get_config("stablelm-12b")))
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, torch.float32, "cpu")
    logits, cache = api.prefill(params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long)}, 8)
    assert logits.shape == (1, 1, api.cfg.vocab)
    assert int(cache["pos"][0]) == 4


@pytest.mark.parametrize("ranks", [8, 6])
def test_serve_smoke_on_cpu(ranks):
    lines = []
    ops.reset_launches()
    res = serve(ServeConfig(batch=2, prompt_len=8, max_new=4, cache_len=16,
                            local_ranks=ranks, device="cpu"),
                smoke=True, on_log=lines.append)
    text = "\n".join(lines)
    for prefix in ("planner: decode AllReduce executes",
                   "self-check rel err", "planner: observed decode plan",
                   "served batch=2"):
        assert prefix in text, text
    assert res["tokens"].shape == (2, 4)
    assert res["self_check_err"] < 1e-5
    assert res["tp_schedule"].demotions == 0
    assert res["tp_exec"].schedule.n == ranks
    # the CPU path runs the plain versions: no kernel was launched
    assert sum(ops.LAUNCHES.values()) == 0


def test_serve_single_rank_skips_collective():
    lines = []
    res = serve(ServeConfig(batch=1, prompt_len=4, max_new=2, cache_len=8,
                            local_ranks=1, device="cpu"),
                smoke=True, on_log=lines.append)
    assert res["tp_exec"] is None and res["self_check_err"] is None
    assert "no decode collective" in lines[0]


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(ServeConfig())
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A device other than the CPU, one card and the meta device (the dry
    run's, where the plain version carries the shapes) is refused, and
    so is a mix of devices."""
    from types import SimpleNamespace
    with pytest.raises(ValueError):
        ops._on_cuda(SimpleNamespace(device=torch.device("xpu")))
    with pytest.raises(ValueError):
        ops.quant_reduce(torch.zeros((2, 128), dtype=torch.int8),
                         torch.zeros((2, 1), device="meta"))
    with pytest.raises(ValueError):
        ops.fused_reduce_into(torch.zeros((2, 8)), ops.row_table(
            [[0]], [0]), torch.zeros((2, 8), device="meta"))
    out = ops.fused_reduce(torch.zeros((2, 8), device="meta"))
    assert out.is_meta and out.shape == (8,)
    q, s = ops.quantize(torch.zeros((2, 8), device="meta"))
    assert q.is_meta and q.shape == (2, 128) and s.shape == (2, 1)


@pytest.mark.parametrize("source,refits", [("mesh", True),
                                           ("local_mesh", False)])
def test_local_mesh_observations_never_refit(source, refits):
    """A time taken on a local mesh measures one device's launches, not
    the level's links: under a policy that refits a drifting level after
    3 samples, mesh observations refit and local-mesh ones never do."""
    from repro_torch.planner.service import PlannerService, RefitPolicy
    svc = PlannerService(refit_policy=RefitPolicy(
        drift_threshold=0.1, min_samples=3, cooldown=1))
    outs = [svc.observe("root_sw", 8, size, 1.0, source=source)
            for size in (2e4, 8e4, 3.2e5, 1.28e6)]
    assert any(o["refit"] for o in outs) is refits
    assert all(o["drift"] > 0.1 for o in outs)
    assert bool(svc.refits) is refits
    if not refits:
        assert svc._params_version == 0
        assert not svc.telemetry.ledger.entries("root_sw")
