"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding correctness is tested
on logical CPU devices exactly as SURVEY.md section 4(d) prescribes. x64 is
enabled so float64 oracle comparisons are meaningful. Tests that need the
GPU live in tests_gpu/.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

from speaker_recognition.utils import compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() >= 8, jax.devices()
