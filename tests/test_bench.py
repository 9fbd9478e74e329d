"""bench.py on the CPU: its trace-to-scope reduction on a small recorded
trace, and its refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402


@jax.jit
def _scoped(x):
    with jax.named_scope("features"):
        y = jnp.tanh(x @ x)
    with jax.named_scope("scoring"):
        z = jax.nn.logsumexp(y @ x.T, axis=-1)
    return z


def test_trace_reduction_by_scope(tmp_path):
    x = jnp.ones((256, 256), jnp.float32) / 256
    hlo = _scoped.lower(x).compile().as_text()
    op_scope = bench.scope_of_ops(hlo)
    assert set(op_scope.values()) == {"features", "scoring"}
    jax.block_until_ready(_scoped(x))
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            out = _scoped(x)
        jax.block_until_ready(out)
    ns = bench.device_time_by_scope(str(tmp_path), op_scope,
                                    plane_prefix="/host:CPU")
    assert ns.get("features", 0) > 0 and ns.get("scoring", 0) > 0


def test_bench_fails_without_gpu():
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert "audio" not in r.stdout


def test_scope_of_ops_gpu_kernel_names():
    hlo = (
        '  %gemm_fusion_dot.1 = f32[8,4]{1,0} fusion(%p0, %p1), '
        'kind=kCustom, metadata={op_name="jit(scores)/features/jit(fn)/'
        'dot_general" source_file="x.py"}\n'
        '  %custom-call.2 = f32[4,8]{1,0} custom-call(%a), '
        'metadata={op_name="jit(scores)/scoring/pallas_call"}\n'
        '  %copy.3 = f32[8]{0} copy(%b), metadata={op_name="jit(scores)/x"}\n')
    op_scope = bench.scope_of_ops(hlo)
    assert op_scope == {"gemm_fusion_dot.1": "features",
                        "gemm_fusion_dot_1": "features",
                        "custom-call.2": "scoring",
                        "custom-call_2": "scoring"}
