"""The reference's auto engine in a JAX subprocess, for the auto-engine
tests (`test_torch_auto_train.py`, `test_torch_dist_auto.py`,
`test_torch_dist_tp*.py`).

The child runs the JAX package's `make_train_step` (jit + NamedSharding,
XLA SPMD inserting every collective) on a plain `jax.sharding.Mesh` of
forced host devices, never `jax.make_mesh`: a one-device (1, 1) mesh,
(4, 1) as ("data", "model") or (2, 2, 1) as ("pod", "data", "model");
with tensor parallelism (2, 2) or (1, 4) as ("data", "model") and
(2, 1, 2) as ("pod", "data", "model").
Each run starts from the reference's own `init_params(PRNGKey(0),
dtype)` of the smoke configuration (with the run's config overrides),
which the child writes first, under "init/<label>/<path>", as f32 (bf16
crosses exactly), so that the port's side starts from it while the
child trains; then it steps on the explicit batches of the inputs file
("batch/<batch key>/<step>/<key>") and writes "<label>/losses" and
"<label>/gnorms".

A run is (label, arch, dtype, mesh name, fsdp, overrides, batch key).
This module imports neither JAX nor torch: the child is a subprocess.
"""
import os
import subprocess
import sys
import time

import numpy as np

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch.train import make_train_step
from repro.models.config import smoke_config
from repro.models.registry import build
from repro.optim import AdamWConfig, adamw_init

init_path, out_path, in_path, spec = (sys.argv[1], sys.argv[2], sys.argv[3],
                                      eval(sys.argv[4]))
inp = dict(np.load(in_path))
devs = np.array(jax.devices()[:4])
MESHES = {"1x1": Mesh(devs[:1].reshape(1, 1), ("data", "model")),
          "4x1": Mesh(devs.reshape(4, 1), ("data", "model")),
          "2x2x1": Mesh(devs.reshape(2, 2, 1), ("pod", "data", "model")),
          "2x2": Mesh(devs.reshape(2, 2), ("data", "model")),
          "1x4": Mesh(devs.reshape(1, 4), ("data", "model")),
          "2x1x2": Mesh(devs.reshape(2, 1, 2), ("pod", "data", "model"))}
res = {}


def put(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)            # exact
        res[f"{prefix}/{key}"] = a


def api_of(arch, overrides):
    return build(dataclasses.replace(smoke_config(get_config(arch)),
                                     **overrides))


def batch_of(bkey, s):
    pre = f"batch/{bkey}/{s}/"
    return {k[len(pre):]: jnp.asarray(v) for k, v in inp.items()
            if k.startswith(pre)}


runs = spec["runs"]
for label, arch, dtype, _, _, overrides, _ in runs:
    put(f"init/{label}", api_of(arch, overrides).init_params(
        jax.random.PRNGKey(0), getattr(jnp, dtype)))
np.savez(init_path + ".tmp.npz", **res)
os.replace(init_path + ".tmp.npz", init_path)
res = {}
for label, arch, dtype, mname, fsdp, overrides, bkey in runs:
    api = api_of(arch, overrides)
    mesh = MESHES[mname]
    params = api.init_params(jax.random.PRNGKey(0), getattr(jnp, dtype))
    state = {"params": params, "opt": adamw_init(params)}
    jitted, _, _ = make_train_step(api, mesh, AdamWConfig(lr=spec["lr"]),
                                   fsdp=fsdp, donate=False)
    b0 = batch_of(bkey, 0)
    f = jitted(jax.eval_shape(lambda: state), jax.eval_shape(lambda: b0))
    losses, gnorms = [], []
    for s in range(spec["steps"]):
        state, m = f(state, batch_of(bkey, s))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res[f"{label}/losses"] = np.asarray(losses)
    res[f"{label}/gnorms"] = np.asarray(gnorms)
np.savez(out_path, **res)
"""


def spawn(d, name: str, runs, inputs_path, *, lr: float, steps: int):
    """Start one child on `runs`; returns (process, init path, out path)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    spec = repr({"runs": [tuple(r) for r in runs], "lr": lr,
                 "steps": steps})
    init, out = d / f"{name}.init.npz", d / f"{name}.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(init), str(out), str(inputs_path),
         spec], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, init, out


def wait_init(proc, init, timeout_s: float = 300.0) -> dict:
    """The child's init file, once written."""
    deadline = time.monotonic() + timeout_s
    while not init.exists():
        assert proc.poll() is None, proc.communicate()[1][-4000:]
        assert time.monotonic() < deadline, "no init from the reference"
        time.sleep(0.2)
    return dict(np.load(init))


def finish(proc, out, timeout_s: float = 600.0) -> dict:
    _, err = proc.communicate(timeout=timeout_s)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))
