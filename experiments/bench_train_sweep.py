#!/usr/bin/env python3
"""Train-path performance sweep at serving geometries (VERDICT r3 item 6).

The training-side counterpart of bench.py: median+IQR walls for

  * enrollment (vmapped per-speaker EM, the production train() program)
    over bank size {4, 20, 80} x init {none, kmeans||}
  * MAP adaptation from a UBM over the same bank sizes
    (adapt-ubm.py:25-36 semantics)
  * the reference's UBM workload: pooled frames, 32 mixtures, 500
    iterations at threshold 1e-15 (train-ubm.py:41-51) and its headline
    512k-frame/256-mix/10-iter benchmark workload (result.tex:38-50)

Enrollment rows report audio-s/s = (S speakers x train_seconds) / wall —
the throughput a CLI `-t enroll` user sees for the EM phase.

Usage: python experiments/bench_train_sweep.py \
    --out results/local/r4_train_sweep.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
                 ".jax_cache"))

import numpy as np

N_TRIALS = 5


def _measure(fit_once, n_trials=N_TRIALS):
    fit_once(0)  # compile + warm
    ts = []
    for i in range(n_trials):
        t0 = time.perf_counter()
        fit_once(1 + i)
        ts.append(time.perf_counter() - t0)
    return (float(np.median(ts)),
            float(np.percentile(ts, 75) - np.percentile(ts, 25)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--train-seconds", type=float, default=20.0)
    ap.add_argument("--dim", type=int, default=28)
    ap.add_argument("--skip-ubm-workloads", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.models import gmm

    backend = jax.default_backend()
    rng = np.random.RandomState(0)
    d = args.dim
    # frames of a train-duration utterance at the serving frame geometry
    T = int((args.train_seconds * 8000 - 256) // 128 + 1)

    rows = []
    outpath = None
    if args.out:
        outpath = args.out if os.path.isabs(args.out) else os.path.join(
            os.path.dirname(os.path.realpath(__file__)), args.out)

    def persist(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if outpath:
            with open(outpath, "a") as f:
                f.write(json.dumps({"ts": time.time(), **row}) + "\n")

    # mixture-drawn speech-like frames per speaker
    def bank_frames(S, seed):
        r = np.random.RandomState(seed)
        mu = r.randn(S, 16, d) * 2
        comp = r.randint(0, 16, (S, T))
        X = np.take_along_axis(mu, comp[:, :, None], axis=1) \
            + r.randn(S, T, d)
        return jnp.asarray(X.astype(np.float32)), jnp.ones((S, T), bool)

    cfg_plain = GmmConfig()                       # production enroll config
    cfg_kmeans = GmmConfig(init_with_kmeans=True)

    for S in (4, 20, 80):
        Xs, masks = bank_frames(S, 7)
        audio = S * args.train_seconds

        for init_name, cfg in (("none", cfg_plain), ("kmeansii", cfg_kmeans)):
            fit = jax.jit(jax.vmap(
                lambda x, m, k, _cfg=cfg: gmm.fit_with_init(x, m, _cfg, k)))

            def run(seed, _fit=fit):
                keys = jax.random.split(jax.random.PRNGKey(seed), S)
                params, ll = _fit(Xs, masks, keys)
                np.asarray(ll)
            med, iqr = _measure(run)
            persist({"kind": "enroll", "S": S, "init": init_name,
                     "frames_per_speaker": T, "dim": d,
                     "wall_s_median": round(med, 4),
                     "wall_s_iqr": round(iqr, 4),
                     "audio_s_per_s": round(audio / med, 1),
                     "n_trials": N_TRIALS, "backend": backend})

        # MAP adaptation from a 32-mix UBM
        ubm_frames = jnp.asarray(
            rng.randn(60_000, d).astype(np.float32))
        ubm, _ = gmm.fit(ubm_frames, jnp.ones(60_000, bool),
                         GmmConfig(n_iterations=50), jax.random.PRNGKey(3))
        map_fit = jax.jit(jax.vmap(
            lambda x, m: gmm.fit_from_ubm(x, m, ubm, cfg_plain)))

        def run_map(seed):
            params, ll = map_fit(Xs, masks)
            np.asarray(ll)
        med, iqr = _measure(run_map)
        persist({"kind": "map_adapt", "S": S,
                 "frames_per_speaker": T, "dim": d,
                 "wall_s_median": round(med, 4), "wall_s_iqr": round(iqr, 4),
                 "audio_s_per_s": round(audio / med, 1),
                 "n_trials": N_TRIALS, "backend": backend})

    if not args.skip_ubm_workloads:
        # reference UBM workload: ~300 utterances' pooled frames, 32 mix,
        # 500 iters, threshold 1e-15 (train-ubm.py:41-51)
        n = 560_000 if backend == "gpu" else 40_000
        X = jnp.asarray(rng.randn(n, d).astype(np.float32))
        mask = jnp.ones(n, bool)
        cfg = GmmConfig(n_mixtures=32, n_iterations=500, threshold=1e-15)

        def run_ubm(seed):
            params, ll = gmm.fit(X, mask, cfg, jax.random.PRNGKey(seed))
            np.asarray(ll)
        med, iqr = _measure(run_ubm, n_trials=3)
        persist({"kind": "ubm_500iter", "frames": n, "mixtures": 32,
                 "dim": d, "wall_s_median": round(med, 3),
                 "wall_s_iqr": round(iqr, 3), "n_trials": 3,
                 "backend": backend})

        # reference headline training benchmark: 512k x 256 x 10 iters
        n2 = 512_000 if backend == "gpu" else 30_000
        X2 = jnp.asarray(rng.randn(n2, 13).astype(np.float32))
        cfg2 = GmmConfig(n_mixtures=256, n_iterations=10, threshold=0.0)

        def run_big(seed):
            params, ll = gmm.fit(X2, jnp.ones(n2, bool), cfg2,
                                 jax.random.PRNGKey(seed))
            np.asarray(ll)
        med, iqr = _measure(run_big, n_trials=5)
        persist({"kind": "sklearn_19x_workload", "frames": n2,
                 "mixtures": 256, "iters": 10, "dim": 13,
                 "wall_s_median": round(med, 3),
                 "wall_s_iqr": round(iqr, 3), "n_trials": 5,
                 "backend": backend})

    if outpath:
        print(f"# wrote {len(rows)} rows to {outpath}", file=sys.stderr)


if __name__ == "__main__":
    main()
