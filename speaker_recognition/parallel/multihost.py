"""Multi-host initialization and the scaling-measurement harness.

The reference is strictly single-node (pthreads); this module is the
framework's multi-host story: `initialize()` wraps
jax.distributed.initialize so the same ('data','bank') mesh code in
parallel/mesh.py spans hosts — the 'data' (frame/utterance) axis is laid
out across hosts so its psums cross the network once per EM iteration,
while 'bank' stays within a host on NVLink.

`scaling_report` measures audio-seconds/s at the current device count for
the EM and scoring workloads so runs at 1 card / 1 host / N hosts produce
comparable jsonl rows (BASELINE.md's scaling-efficiency requirement).
"""

from __future__ import annotations

import json
import time

import numpy as np

__all__ = ["initialize", "scaling_report"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Initialize the multi-host runtime. On a single host this is a no-op;
    across hosts, pass the coordinator address ('host:port'), the number
    of processes and this process's id — nothing in a plain GPU cluster
    lets JAX detect them. Must run before any jax device query."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    return jax


def scaling_report(frames_per_device: int = 262_144, mixtures: int = 32,
                   dim: int = 28, iters: int = 5, bank: int = 128,
                   seed: int = 0) -> dict:
    """One EM + one bank-scoring measurement over the full current mesh.

    Returns a jsonl-able record with devices/hosts and audio-s/s (16 ms
    frame shift). Run the same call at every scale to get the efficiency
    curve.
    """
    import jax
    import jax.numpy as jnp

    from ..config import GmmConfig
    from ..models import gmm
    from . import mesh as pmesh

    n_dev = jax.device_count()
    mesh = pmesh.make_mesh(data=n_dev, bank=1)
    n = frames_per_device * n_dev
    rng = np.random.RandomState(seed)
    X = rng.randn(n, dim).astype(np.float32)
    mask = np.ones(n, bool)
    cfg = GmmConfig(n_mixtures=mixtures, n_iterations=iters, threshold=0.0)

    fit = pmesh.sharded_fit(mesh, cfg)
    key = jax.random.PRNGKey(0)
    jax.block_until_ready(fit(X, mask, key)[0])  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(fit(X, mask, key)[0])
    em_s = time.perf_counter() - t0

    score = pmesh.sharded_bank_scores(pmesh.make_mesh(data=1, bank=n_dev))
    w = rng.rand(bank, mixtures) + 0.1
    bank_p = gmm.GmmParams(
        jnp.asarray(w / w.sum(1, keepdims=True), jnp.float32),
        jnp.asarray(rng.randn(bank, mixtures, dim), jnp.float32),
        jnp.asarray(0.5 + rng.rand(bank, mixtures, dim), jnp.float32))
    n_score = min(n, 65536)
    Xs = jnp.asarray(X[:n_score])
    ms = jnp.ones(n_score, dtype=bool)
    jax.block_until_ready(score(bank_p, Xs, ms))
    t0 = time.perf_counter()
    jax.block_until_ready(score(bank_p, Xs, ms))
    score_s = time.perf_counter() - t0

    audio_s = n * 0.016
    return {
        "devices": n_dev,
        "hosts": jax.process_count(),
        "em_workload_frames": n,
        "em_audio_s_per_s": round(audio_s * iters / em_s, 1),
        "bank": bank,
        "score_audio_s_per_s": round(n_score * 0.016 / score_s, 1),
    }


if __name__ == "__main__":
    initialize()
    print(json.dumps(scaling_report()))
