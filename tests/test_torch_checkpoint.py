"""The port's checkpoint store (`repro_torch.checkpoint`) against the JAX
package's (`repro.checkpoint`), on the CPU.

The reference's own cases (tests/test_substrate.py's round trip, latest
and gc, async; tests/test_faults.py's checksum manifest, fallback past a
corrupt step, raise when every step is corrupt) run against the port.
The on-disk format is held both ways: a tree of bf16, f32 and int32
leaves saved by either package loads in the other with equal bits, and
the port's flatten order of the trainer's ZeRO-3 state is the order of
`jax.tree.leaves` of the reference's. Exact throughout: a checkpoint
stores bits.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import (CheckpointManager, LeafMismatch,
                                    load_pytree, save_pytree, tree_flatten,
                                    tree_unflatten)
from repro_torch.checkpoint.store import (CHECKSUM_FILE, _file_crc,
                                          verify_checksums)
from repro_torch.runtime.faults import (ENV_VAR, FaultInjector, FaultPlan)


@pytest.fixture
def quiet_faults(monkeypatch):
    """No ambient injector: an empty scoped plan masks $REPRO_FAULT_PLAN."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    with FaultInjector(FaultPlan()) as inj:
        yield inj


def _bits(x) -> np.ndarray:
    """The raw bits of a torch or jax leaf, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        size = x.element_size()
        x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[size]).numpy()
    else:
        x = np.asarray(x)
        size = x.dtype.itemsize
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[size])


def _mixed(seed: int) -> dict:
    """bf16, f32 and int32 leaves (numpy, from a seed) in nested dicts and
    a list."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "h": {"b": rng.standard_normal((7,)).astype(np.float32),
                  "k": rng.integers(-9, 9, (2, 3)).astype(np.int32)},
            "l": [rng.standard_normal((4,)).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)],
            "step": np.int32(seed)}


def _torch_of(tree):
    """The numpy tree as torch tensors, `w` and the list's first leaf in
    bf16."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"w": t(tree["w"]).to(torch.bfloat16),
            "h": {"b": t(tree["h"]["b"]), "k": t(tree["h"]["k"])},
            "l": [t(tree["l"][0]).to(torch.bfloat16), t(tree["l"][1])],
            "step": t(tree["step"])}


def _jax_of(tree):
    return {"w": jnp.asarray(tree["w"], jnp.bfloat16),
            "h": {"b": jnp.asarray(tree["h"]["b"]),
                  "k": jnp.asarray(tree["h"]["k"])},
            "l": [jnp.asarray(tree["l"][0], jnp.bfloat16),
                  jnp.asarray(tree["l"][1])],
            "step": jnp.asarray(tree["step"], jnp.int32)}


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_substrate.py)
# ---------------------------------------------------------------------------
def test_save_load_roundtrip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.bfloat16),
            "b": {"c": torch.ones((2, 3))},
            "step": torch.tensor(7, dtype=torch.int32)}
    save_pytree(tree, str(tmp_path / "ck"))
    like = {"a": torch.zeros(5, dtype=torch.bfloat16),
            "b": {"c": torch.zeros((2, 3))},
            "step": torch.tensor(0, dtype=torch.int32)}
    out = load_pytree(str(tmp_path / "ck"), like)
    assert int(out["step"]) == 7 and out["step"].dtype == torch.int32
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.ones((2, 3)))
    assert out["a"] is like["a"]                # restored in place


def test_manager_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    assert mgr.latest_step() == 30
    restored, step = mgr.restore({"x": torch.zeros(3)})
    assert step == 30 and float(restored["x"][0]) == 30.0
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(dirs) == 2       # gc keeps 2


def test_manager_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.ones(4)
    mgr.save(1, {"x": x})
    x.add_(1.0)                 # the snapshot was taken before save returned
    mgr.wait()
    assert mgr.latest_step() == 1
    out, _ = mgr.restore({"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.ones(4))
    assert mgr.last_save["bytes"] == 16 and mgr.last_save["write_s"] >= 0


def test_async_write_error_is_raised_by_wait(tmp_path):
    """A failed background write is not lost: `wait` (and so the next
    save or restore) raises it."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    (tmp_path / ".tmp_step_00000001").write_text("a file where a dir goes")
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()                  # raised once


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_faults.py): checksums and fallback
# ---------------------------------------------------------------------------
def _ckpt_tree(v: float) -> dict:
    return {"w": torch.full((4,), v), "step": torch.tensor(int(v))}


def test_checkpoint_checksums_written_and_verified(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _ckpt_tree(1.0))
    path = tmp_path / "step_00000001"
    assert (path / CHECKSUM_FILE).exists()
    assert verify_checksums(str(path)) and mgr.verify(1)
    # the manifest, taken of the bytes as written, is the files' CRC32
    sums = json.loads((path / CHECKSUM_FILE).read_text())["crc32"]
    assert sums == {n: _file_crc(str(path / n))
                    for n in ("arrays.npz", "tree.json")}
    assert ref_store.verify_checksums(str(path))
    (path / "arrays.npz").write_bytes(b"\x00flip")
    assert not verify_checksums(str(path)) and not mgr.verify(1)


def test_restore_falls_back_past_corrupt_checkpoint(tmp_path, quiet_faults):
    from repro_torch.runtime.metrics import default_metrics
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(10, _ckpt_tree(10.0))
    mgr.save(20, _ckpt_tree(20.0))
    inj = FaultInjector(FaultPlan(seed=11))
    assert inj.corrupt_file(str(tmp_path / "step_00000020" / "arrays.npz"))
    fallbacks = default_metrics().counter(
        "ckpt_restore_fallbacks_total").value
    tree, step = mgr.restore(_ckpt_tree(0.0))
    assert step == 10                     # newest intact wins
    np.testing.assert_array_equal(tree["w"].numpy(),
                                  np.full((4,), 10.0, np.float32))
    assert default_metrics().counter(
        "ckpt_restore_fallbacks_total").value == fallbacks + 1
    # an explicit step is authoritative: corruption there raises
    with pytest.raises(Exception):
        mgr.restore(_ckpt_tree(0.0), step=20)


def test_restore_raises_when_everything_is_corrupt(tmp_path, quiet_faults):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, _ckpt_tree(5.0))
    inj = FaultInjector(FaultPlan(seed=2))
    assert inj.corrupt_file(str(tmp_path / "step_00000005" / "arrays.npz"))
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        mgr.restore(_ckpt_tree(0.0))


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_checkpoint_loads_into_the_port(tmp_path, seed):
    tree = _mixed(seed)
    ref_store.save_pytree(_jax_of(tree), str(tmp_path / "ck"))
    like = jax.tree.map(lambda x: x * 0, _torch_of(tree))
    out = load_pytree(str(tmp_path / "ck"), like)
    want = jax.tree.leaves(_jax_of(tree))
    got, _ = tree_flatten(out)
    assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                      torch.bfloat16, torch.float32,
                                      torch.int32, torch.bfloat16]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_port_checkpoint_loads_into_the_reference(tmp_path, seed):
    tree = _mixed(seed)
    save_pytree(_torch_of(tree), str(tmp_path / "ck"))
    like = jax.tree.map(jnp.zeros_like, _jax_of(tree))
    out = ref_store.load_pytree(str(tmp_path / "ck"), like)
    got = jax.tree.leaves(out)
    want, _ = tree_flatten(_torch_of(tree))
    assert [str(g.dtype) for g in got] == ["float32", "int32", "bfloat16",
                                           "float32", "int32", "bfloat16"]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    meta = json.loads((tmp_path / "ck" / "tree.json").read_text())
    assert meta["treedef"] == str(jax.tree.structure(_jax_of(tree)))


def test_fp8_leaves_cross_as_raw_bits(tmp_path):
    x = torch.tensor([[-0.875, 1.875], [1.625, -0.8125]]).to(
        torch.float8_e4m3fn)
    save_pytree({"q": x}, str(tmp_path / "ck"))
    meta = json.loads((tmp_path / "ck" / "tree.json").read_text())
    assert meta["dtypes"] == ["float8_e4m3fn"]
    out = ref_store.load_pytree(str(tmp_path / "ck"),
                                {"q": jnp.zeros((2, 2), jnp.float8_e4m3fn)})
    np.testing.assert_array_equal(_bits(out["q"]), _bits(x))
    back = load_pytree(str(tmp_path / "ck"), {"q": torch.zeros_like(x)})
    assert torch.equal(back["q"].view(torch.uint8), x.view(torch.uint8))


def test_trainer_state_flattens_in_the_reference_order():
    """The port's ZeRO-3 state {"params": [...], "opt": {"m", "step",
    "v"}} lists its leaves as `jax.tree.leaves` lists the reference's
    state built by `shard_params_zero3` and `adamw_init` (one rank, the
    reference's smoke stablelm-12b init carried over)."""
    from repro.configs import get_config as ref_config
    from repro.launch.train import shard_params_zero3 as ref_shard
    from repro.models.config import smoke_config as ref_smoke
    from repro.models.registry import build as ref_build
    from repro.optim import adamw_init as ref_adamw_init
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.train import shard_params_zero3
    from repro_torch.optim import adamw_init

    api = ref_build(ref_smoke(ref_config("stablelm-12b")))
    params = api.init_params(jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref_state = {"params": ref_shard(params, mesh),
                 "opt": ref_adamw_init(ref_shard(params, mesh))}
    # distinct moments, so that their order shows too
    ref_state["opt"]["m"] = jax.tree.map(lambda p: p.astype(jnp.float32) + 1,
                                         ref_state["params"])
    ref_state["opt"]["v"] = jax.tree.map(lambda p: p.astype(jnp.float32) * 2,
                                         ref_state["params"])
    shards = shard_params_zero3(params_from_jax(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), params)), 1)
    shards = [s.to(torch.bfloat16) for s in shards]
    state = {"params": shards, "opt": adamw_init(shards)}
    state["opt"]["m"] = [s.float() + 1 for s in shards]
    state["opt"]["v"] = [s.float() * 2 for s in shards]
    got, treedef = tree_flatten(state)
    want = jax.tree.leaves(ref_state)
    assert len(got) == len(want) == 3 * 12 + 1
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert treedef.count("*") == len(got)


def test_tree_unflatten_inverts_flatten():
    tree = {"b": [torch.ones(1), (torch.zeros(2), None)], "a": torch.ones(3)}
    leaves, treedef = tree_flatten(tree)
    assert treedef == "PyTreeDef({'a': *, 'b': [*, (*, None)]})"
    out = tree_unflatten(tree, [x + 1 for x in leaves])
    assert list(out) == ["b", "a"] and out["b"][1][1] is None
    assert torch.equal(out["b"][1][0], torch.ones(2))
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, leaves + [torch.ones(1)])


# ---------------------------------------------------------------------------
# shapes, in-place restore
# ---------------------------------------------------------------------------
def test_leaf_shape_mismatch_raises(tmp_path):
    """A checkpoint of an 8-rank local mesh does not load into a 4-rank
    trainer's state: each leaf's shape must equal the target's (the
    reference checks the count only). The restore raises at once rather
    than trying older checkpoints, and leaves the target untouched."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, {"s": torch.ones((8, 5)), "t": torch.ones(2)})
    mgr.save(2, {"s": torch.ones((8, 5)), "t": torch.ones(2)})
    like = {"s": torch.zeros((4, 10)), "t": torch.zeros(2)}
    with pytest.raises(ValueError, match=r"leaf 0 has shape \(8, 5\)"):
        mgr.restore(like)
    with pytest.raises(LeafMismatch):
        load_pytree(str(tmp_path / "step_00000001"), like)
    with pytest.raises(ValueError, match="2 leaves, expected 3"):
        load_pytree(str(tmp_path / "step_00000001"),
                    {**like, "u": torch.zeros(1)})
    assert not like["s"].any() and not like["t"].any()


def test_restore_into_overwrites_in_place(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"p": [torch.arange(6.0).to(torch.bfloat16)],
                 "step": torch.tensor(3, dtype=torch.int32)})
    live = {"p": [torch.zeros(6, dtype=torch.bfloat16)],
            "step": torch.tensor(0, dtype=torch.int32)}
    p0 = live["p"][0]
    out, step = mgr.restore(live)
    assert step == 3 and out["p"][0] is p0
    assert torch.equal(p0, torch.arange(6.0).to(torch.bfloat16))
    assert int(out["step"]) == 3
    rs = mgr.last_restore
    assert rs["step"] == 3 and rs["bytes"] == 12 + 4
    assert min(rs["verify_s"], rs["read_s"], rs["copy_s"]) >= 0
