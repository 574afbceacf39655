"""The port's sharding rules (`repro_torch.launch.sharding`) against the
JAX package's (`repro.launch.sharding`), leaf by leaf, for every
configuration at full size on both production meshes: the parameters
of the stacked tree (`params_spec`), the AdamW moments with and without
FSDP, the batch of the train and prefill cells and of a one-row decode,
and the decode caches at 32 Ki and 512 Ki slots. The reference reads
its mesh through `tests/test_sharding_rules.py`'s shape stand-in; the
port's mesh is `make_production_mesh`'s (axis, size) pairs. Specs are
compared with each entry as its tuple of axis names and the trailing
unsharded dims dropped. Then `to_placements` on a 2 × 2 mesh."""
import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_shr
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.registry import build as ref_build
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import build
from repro_torch.models.tree import tree_items


class FakeMesh:
    """Shape/axis-name stand-in (the reference's rules only read these)."""
    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = names


MESHES = {"16x16": (False, FakeMesh((16, 16), ("data", "model"))),
          "2x16x16": (True, FakeMesh((2, 16, 16),
                                     ("pod", "data", "model")))}
WHATS = ["params", "opt_fsdp", "opt_zero1", "opt_no_mesh", "batch",
         "cache"]


def _canon(spec) -> tuple:
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in tuple(spec)]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _ref_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", p)) for p in path): _canon(s)
            for path, s in leaves}


def _port_flat(tree) -> dict:
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], prefix + (str(k),))
        else:
            yield "/".join(prefix), _canon(node)
    return dict(walk(tree, ()))


class _Trees:
    """One configuration's shape trees on both sides, each made once: the
    parameters (`params_spec`, stacked), and the batch and cache specs of
    a cell."""

    def __init__(self, arch):
        self.ref_api, self.api = ref_build(ref_config(arch)), build(
            get_config(arch))
        self._memo = {}

    def get(self, key, ref_fn, port_fn):
        if key not in self._memo:
            self._memo[key] = (ref_fn(self.ref_api), port_fn(self.api))
        return self._memo[key]


@pytest.fixture(scope="module")
def trees():
    return {a: _Trees(a) for a in ARCHS}


def _cases(what, t: _Trees, ref_mesh, mesh):
    """[(reference spec tree, port spec tree)] of one kind of tree."""
    if what in ("params", "opt_fsdp", "opt_zero1", "opt_no_mesh"):
        rp, pp = t.get("params", lambda a: a.params_spec(),
                       lambda a: a.params_spec())
        if what == "params":
            return [(ref_shr.params_specs(rp, ref_mesh),
                     shr.params_specs(pp, mesh))]
        fsdp = what != "opt_zero1"
        rs = ref_shr.params_specs(rp, ref_mesh, fsdp=fsdp)
        ps = shr.params_specs(pp, mesh, fsdp=fsdp)
        if what == "opt_no_mesh":
            return [(ref_shr.opt_specs({"m": rp}, rs),
                     shr.opt_specs({"m": pp}, ps))]
        return [(ref_shr.opt_specs({"m": rp}, rs, ref_mesh),
                 shr.opt_specs({"m": pp}, ps, mesh))]
    out = []
    if what == "batch":
        for name in ("train_4k", "prefill_32k"):
            fn = "train_specs" if name == "train_4k" else "prefill_specs"
            rb, pb = t.get(name, lambda a: getattr(a, fn)(REF_SHAPES[name]),
                           lambda a: getattr(a, fn)(SHAPES[name]))
            out.append((ref_shr.batch_specs(rb, ref_mesh),
                        shr.batch_specs(pb, mesh)))
    for name in ("decode_32k", "long_500k"):
        rd, pd = t.get(name, lambda a: a.decode_specs(REF_SHAPES[name]),
                       lambda a: a.decode_specs(SHAPES[name]))
        if what == "batch":
            if name == "long_500k":
                out.append((ref_shr.batch_specs(rd["batch"], ref_mesh),
                            shr.batch_specs(pd["batch"], mesh)))
            continue
        out.append((ref_shr.cache_specs(rd["cache"], ref_mesh),
                    shr.cache_specs(pd["cache"], mesh)))
    return out


@pytest.mark.parametrize("what", WHATS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(trees, arch, mesh_name, what):
    multi_pod, ref_mesh = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod)
    assert [a for a, _ in mesh] == list(ref_mesh.axis_names)
    assert [s for _, s in mesh] == list(ref_mesh.devices.shape)
    for want, got in _cases(what, trees[arch], ref_mesh, mesh):
        want, got = _ref_flat(want), _port_flat(got)
        assert got == want
    if what == "params":
        # some leaf of every model shards at full size
        assert any(s for s in got.values())


def test_port_params_are_the_stacked_tree(trees):
    """The auto engine's leaf order is the reference's stacked tree's."""
    for arch in ("stablelm-12b", "whisper-large-v3"):
        rp, pp = trees[arch.replace("-", "_").replace(".", "_")].get(
            "params", lambda a: a.params_spec(), lambda a: a.params_spec())
        ref_paths = list(_ref_flat(ref_shr.params_specs(
            rp, MESHES["16x16"][1])))
        assert ["/".join(p) for p, _ in tree_items(pp)] == ref_paths


MESH22 = (("pod", 2), ("data", 2))


@pytest.mark.parametrize("spec,want", [
    ((None, "data"), (Replicate(), Shard(1))),
    (("data", None), (Replicate(), Shard(0))),
    ((("pod", "data"), None), (Shard(0), Shard(0))),
    (("pod", "data"), (Shard(0), Shard(1))),
    ((None, None), (Replicate(), Replicate())),
    ((), (Replicate(), Replicate())),
], ids=["data-dim1", "data-dim0", "both-dim0", "pod0-data1", "none", "empty"])
def test_to_placements_on_a_2x2_mesh(spec, want):
    assert shr.spec_placements(spec, MESH22) == want
    tree = {"a": [spec, spec], "b": {"c": spec}}
    assert shr.to_placements(tree, MESH22) == {
        "a": [want, want], "b": {"c": want}}


@pytest.mark.parametrize("spec,match", [
    (("data", "data"), "named twice"),
    ((("pod", "data"), "pod"), "named twice"),
    (("model", None), "not axes"),
])
def test_to_placements_refuses_bad_specs(spec, match):
    with pytest.raises(ValueError, match=match):
        shr.spec_placements(spec, MESH22)


def test_production_meshes():
    assert make_production_mesh() == (("data", 16), ("model", 16))
    assert make_production_mesh(multi_pod=True) == (
        ("pod", 2), ("data", 16), ("model", 16))
    assert shr._dp_axes(make_production_mesh(True)) == ("pod", "data")
    assert shr._dp_size(make_production_mesh(True)) == 32
