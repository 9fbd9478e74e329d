#!/usr/bin/env python3
"""Feature-pipeline variant benchmark: where does predict time go?

Measures audio-s/s for the batched extractor under ablations (full, no
LPC, no CMVN, MFCC-only, pallas on/off) plus scoring-only, to steer kernel
work. One jsonl line per variant.
"""

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
    import jax
    import jax.numpy as jnp
    from speaker_recognition.config import FeatureConfig, MfccConfig
    from speaker_recognition.features.extract import _feature_fn

    fs, B, sec = 8000, 64, 5.0
    L = int(fs * sec)
    padded = -(-L // 4096) * 4096
    rng = np.random.RandomState(0)
    signals = jnp.asarray((rng.randn(B, padded) * 3000).astype(np.float32))
    lengths = jnp.asarray(np.full(B, L, np.int32))

    variants = {
        "full_xla": (FeatureConfig(), "off"),
        "full_pallas": (FeatureConfig(), "on"),
        "no_lpc_xla": (FeatureConfig(use_lpc=False), "off"),
        "no_cmvn_xla": (FeatureConfig(mfcc=MfccConfig(cmvn=False)), "off"),
    }

    def measure(fn):
        # reduce to a scalar INSIDE the program so the timing measures
        # the extractor, not a device-to-host copy
        red = jax.jit(lambda s, l: jnp.sum(fn(s, l)[0]))
        float(np.asarray(red(signals, lengths)))  # compile+sync
        t0 = time.perf_counter()
        float(np.asarray(red(signals, lengths)))
        once = time.perf_counter() - t0
        reps = max(3, min(300, int(1.0 / max(once, 1e-4))))
        ts = []
        for _ in range(5):  # median of 5 trials (r3 variance methodology)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = red(signals, lengths)
            float(np.asarray(out))
            ts.append(time.perf_counter() - t0)
        return B * sec * reps / float(np.median(ts))

    for name, (cfg, mode) in variants.items():
        try:
            fn = _feature_fn(fs, cfg, padded, "float32", mode)
            v = measure(fn)
            print(json.dumps({"variant": name, "audio_s_per_s": round(v)}),
                  flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"variant": name,
                              "error": f"{type(e).__name__}: {e}"[:160]}),
                  flush=True)


if __name__ == "__main__":
    main()
