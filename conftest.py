"""Repo-root conftest: make src/ and benchmarks importable in tests.

NOTE: deliberately does NOT set XLA_FLAGS — smoke tests and benches must see
the single real CPU device; multi-device tests spawn subprocesses.
"""
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's kernels); "
        "skips without one")
