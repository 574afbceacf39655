"""The port's training forward, loss and gradients against the JAX
package's `forward` and `jax.value_and_grad` of its `loss_fn`, on the
same f32 weights (`convert.params_from_jax`) at smoke size, for the
dense models stablelm-12b and gemma2-27b (sliding window, softcaps);
and `ModelAPI.params_spec` against the reference's. The reference runs
in `test_torch_train.py`'s subprocess (the "model" part); tolerances as
stated there: 1e-5 of the largest |value| of the logits, the loss and
each leaf's gradient.
"""
import pytest
import torch

from test_torch_train import (ARCHS, SPECS, _api, _batch,  # noqa: F401
                              _np, _params, _rel, few_threads, inputs,
                              run_reference)

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import build
from repro_torch.models.tree import (stack_layers, tree_from_items,
                                     tree_items, unstack_layers)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):  # noqa: F811
    return run_reference(tmp_path_factory, inputs, ("model",))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(ref, inputs, arch):
    api = _api(arch)
    params = _params(ref, f"{arch}/params")
    batch = _batch(inputs, arch)
    with torch.no_grad():
        logits = api.forward(params, batch, remat=False)
        loss = api.loss_fn(params, batch, remat=True)
    want = ref[f"{arch}/logits"]
    assert logits.shape == want.shape and logits.dtype == torch.float32
    assert _rel(_np(logits), want) <= 1e-5
    assert _rel(_np(loss), ref[f"{arch}/loss"]) <= 1e-5


def _grads(api, params, batch, remat):
    """Loss gradients of the stacked leaves, in the reference's order."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_items(stack_layers(params))]
    paths = [p for p, _ in tree_items(stack_layers(params))]
    loss = api.loss_fn(unstack_layers(tree_from_items(zip(paths, leaves))),
                       batch, remat=remat)
    return paths, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(ref, inputs, arch):
    paths, grads = _grads(_api(arch), _params(ref, f"{arch}/params"),
                          _batch(inputs, arch), True)
    assert len(paths) == 12
    for path, g in zip(paths, grads):
        want = ref[f"{arch}/grads/" + "/".join(path)]
        assert g.shape == want.shape
        assert _rel(_np(g), want) <= 1e-5, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_identical_grads(ref, inputs, arch):
    api, batch = _api(arch), _batch(inputs, arch)
    params = _params(ref, f"{arch}/params")
    _, with_remat = _grads(api, params, batch, True)
    _, without = _grads(api, params, batch, False)
    for a, b in zip(with_remat, without):
        assert torch.equal(a, b)


def test_training_forward_launches_no_kernel(monkeypatch, ref, inputs):
    """The training forward runs torch ops only: it never calls a kernel
    wrapper (the kernels have no backward)."""
    called = []
    for name in ("rmsnorm", "flash_attention", "wkv", "ssm_scan"):
        monkeypatch.setattr(ops, name,
                            lambda *a, _n=name, **k: called.append(_n))
    _grads(_api("gemma2-27b"), _params(ref, "gemma2-27b/params"),
           _batch(inputs, "gemma2-27b"), True)
    assert called == []


@pytest.mark.parametrize("arch", SPECS)
def test_params_spec_matches_reference(ref, arch):
    """The leaves of `params_spec`, in order, with the reference's paths,
    stacked shapes and bf16 dtype, allocated nowhere."""
    cfg = get_config(arch.split("/")[0])
    if not arch.endswith("/full"):
        cfg = smoke_config(cfg)
    got = [f"{'/'.join(p)} {str(t.dtype).removeprefix('torch.')} "
           + " ".join(map(str, t.shape))
           for p, t in tree_items(build(cfg).params_spec())]
    assert got == list(ref[f"spec/{arch}"])
    assert {t.device.type for _, t in
            tree_items(build(cfg).params_spec())} == {"meta"}
