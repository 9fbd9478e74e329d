#!/usr/bin/env python3
"""GMM EM training benchmark — the reference's headline training workload
(doc/Final-Report-Complete/result.tex:38-50): 512k MFCC frames, 256
mixtures, 10 EM iterations, k-means init off. The reference reports 19x
over scikit-learn on 8 cores; here we report absolute EM throughput
(frame-component-iterations per second and wall time for the workload).

Run on a GPU: python experiments/bench_train.py
CPU smoke:  JAX_PLATFORMS=cpu python experiments/bench_train.py --frames 20000 --mixtures 32
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=512_000)
    ap.add_argument("--mixtures", type=int, default=256)
    ap.add_argument("--dim", type=int, default=13)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.models import gmm

    rng = np.random.RandomState(0)
    # speech-like: draw from a random 64-component mixture
    mu = rng.randn(64, args.dim) * 2
    comps = rng.randint(0, 64, args.frames)
    X = (mu[comps] + rng.randn(args.frames, args.dim)).astype(np.float32)
    Xj = jnp.asarray(X)
    mask = jnp.ones(args.frames, dtype=bool)
    # fixed iteration count (threshold 0 disables early stop, matching the
    # reference's benchmark conditions)
    cfg = GmmConfig(n_mixtures=args.mixtures, n_iterations=args.iters,
                    threshold=0.0)

    params, ll = gmm.fit(Xj, mask, cfg, jax.random.PRNGKey(0))
    jax.block_until_ready(ll)  # compile + first run

    ts = []
    for trial in range(5):  # median of 5 trials (r3 variance methodology)
        t0 = time.perf_counter()
        params, ll = gmm.fit(Xj, mask, cfg, jax.random.PRNGKey(1 + trial))
        float(ll)
        ts.append(time.perf_counter() - t0)
    import numpy as _np
    elapsed = float(_np.median(ts))

    fci = args.frames * args.mixtures * args.iters
    print(json.dumps({
        "workload": f"{args.frames} frames x {args.mixtures} mixtures x "
                    f"{args.iters} EM iters (d={args.dim})",
        "wall_seconds": round(elapsed, 3),
        "frame_component_iters_per_s": round(fci / elapsed),
        "final_total_ll": float(ll),
    }))


if __name__ == "__main__":
    main()
