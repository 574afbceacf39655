"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device
count (1 on this container); multi-device tests spawn their own meshes via
the xdist-safe `fake_devices` marker handled in test files that re-exec
with a device-count env (see test_collectives.py docstring)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
