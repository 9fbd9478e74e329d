"""Card-only test tier.

The main suite (tests/) runs on a CPU backend, so it only ever runs the
scoring kernel in interpret mode. The tests here are marked `gpu`: they
run the compiled programs and kernel on an NVIDIA GPU against backend-free
float64 numpy oracles and the XLA path, and skip on any other backend.

Run on a card:  python -m pytest tests_gpu -q   (chip_smoke.py also runs
this directory in-process, so that one process holds the card).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels and programs)")


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Decide per test, at run time, whether the card is there."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX backend is "
                    f"{jax.default_backend()}")
    from speaker_recognition.utils import compile_cache
    compile_cache.enable()
