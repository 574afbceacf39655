"""`repro_torch` stands alone: importing it and every submodule loads
neither JAX nor any module of the JAX package (`repro`, `repro.*`).

One subprocess imports the modules one after another and records, after
each, which forbidden modules `sys.modules` holds.
"""
import json
import os
import pkgutil
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_CHILD = r"""
import importlib, json, pkgutil, sys
import repro_torch

def forbidden():
    return sorted(k for k in sys.modules
                  if k == "jax" or k.startswith("jax.") or k == "repro"
                  or k.startswith("repro."))

names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."))
out = {}
for name in names:
    try:
        importlib.import_module(name)
        out[name] = {"ok": True, "forbidden": forbidden()}
    except Exception as e:
        out[name] = {"ok": False, "error": repr(e), "forbidden": forbidden()}
print(json.dumps(out))
"""


def _module_names():
    names = ["repro_torch"]
    path = [os.path.join(SRC, "repro_torch")]
    names += sorted(m.name for m in pkgutil.walk_packages(path,
                                                          "repro_torch."))
    return names


@pytest.fixture(scope="module")
def imports():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_is_listed(imports):
    assert sorted(imports) == sorted(_module_names())
    assert len(imports) > 20


@pytest.mark.parametrize("name", _module_names())
def test_module_imports_without_jax(imports, name):
    rec = imports[name]
    assert rec["ok"], rec.get("error")
    assert rec["forbidden"] == [], rec["forbidden"]
