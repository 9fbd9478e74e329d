#!/usr/bin/env python3
"""Headline predict throughput on one GPU (audio-seconds/s).

Workload: the reference's headline predict configuration — 5 s utterances
at 8 kHz, MFCC(13)+LPC(15) features, 32-component diagonal GMMs against a
4-speaker bank (log/final/final-log/nperson-mix-1523-t5.log) — run as the
serving program that ModelInterface.scores_batch runs on this backend
(api/fastpath.scores_fn with the scoring pallas_gmm.use_kernel picks), over a
padded batch of 512 utterances, timed until block_until_ready.

Baseline: the reference achieves ~22 audio-s/s/core for features and
~580 audio-s/s/core for scoring on its 2013 8-core CPU (BASELINE.md), i.e.
~21.2 audio-s/s/core end-to-end. vs_baseline reports the multiple of that
per-core number achieved by one card.

    python bench.py [--trace DIR]

--trace also records a profiler trace of a few calls into DIR and prints
each named scope's share of the device time (features vs scoring); it
turns off XLA's CUDA-graph replay for the whole run so that every kernel
in the trace names its op.
Fails without a GPU. Prints the device and card on stderr and ONE JSON
line on stdout: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))

REFERENCE_ENDTOEND_PER_CORE = 1.0 / (1.0 / 22.0 + 1.0 / 580.0)  # ~21.2


def scope_of_ops(hlo_text: str, scopes=("features", "scoring")) -> dict:
    """HLO instruction name -> named scope, from compiled HLO text. GPU
    kernels are named after their instruction with '.' written as '_'
    (fusion.3 -> fusion_3), so both spellings are keys."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         hlo_text):
        name, op_name = m.groups()
        for scope in scopes:
            if f"/{scope}/" in op_name or op_name.endswith(f"/{scope}"):
                out[name] = out[name.replace(".", "_")] = scope
                break
    return out


def device_time_by_scope(trace_dir: str, op_scope: dict,
                         plane_prefix: str = "/device:GPU") -> dict:
    """Sum of device event durations (ns) per named scope in a trace. An
    event is looked up by its kernel name, then by its hlo_op stat (XLA
    on the GPU reports 'command_buffer' there when it replays a CUDA
    graph); events of ops outside every scope count as 'other'."""
    from jax.profiler import ProfileData

    totals = {}
    for path in glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                       "*.xplane.pb")):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith(plane_prefix):
                continue
            for line in plane.lines:
                for ev in line.events:
                    op = dict(ev.stats).get("hlo_op")
                    if op is None:
                        continue
                    scope = op_scope.get(ev.name, op_scope.get(op, "other"))
                    totals[scope] = totals.get(scope, 0.0) + ev.duration_ns
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser(description="headline predict throughput")
    ap.add_argument("--trace", help="directory for a profiler trace")
    args = ap.parse_args(argv)
    if args.trace:
        # XLA replays a program as one CUDA graph, and the trace then names
        # every kernel's op 'command_buffer'; without graphs each kernel
        # keeps its HLO op, so library GEMMs can be attributed too
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py: needs an NVIDIA GPU; JAX found "
                         f"{jax.devices()[0].platform}")
    from speaker_recognition.api import fastpath
    from speaker_recognition.config import FeatureConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm
    from speaker_recognition.ops import pallas_gmm
    from speaker_recognition.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"# device_kind={dev.device_kind} card: {card}", file=sys.stderr)

    fs, utt_seconds, B, S, K = 8000, 5.0, 512, 4, 32
    L = int(fs * utt_seconds)
    padded = -(-L // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
    fcfg = FeatureConfig()
    d = fcfg.dim
    rng = np.random.RandomState(0)
    signals = (rng.randn(B, padded) * 3000).astype(np.float32)
    signals[:, L:] = 0
    lengths = np.full((B,), L, np.int32)
    bank = gmm.GmmParams(
        weights=jnp.asarray(np.full((S, K), 1.0 / K, np.float32)),
        means=jnp.asarray(rng.randn(S, K, d).astype(np.float32)),
        sigmas=jnp.asarray((0.5 + rng.rand(S, K, d)).astype(np.float32)))
    scoring = "kernel" if pallas_gmm.use_kernel("float32") else "xla"
    fn = fastpath.scores_fn(fs, fcfg, padded, "float32", scoring)
    inputs = (jnp.asarray(signals), jnp.asarray(lengths), bank)

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*inputs))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*inputs))
    iters = max(3, min(200, int(1.0 / max(time.perf_counter() - t0, 1e-4))))
    trials = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*inputs)
        jax.block_until_ready(out)
        trials.append(B * utt_seconds * iters / (time.perf_counter() - t0))
    value = float(np.median(trials))
    iqr = float(np.percentile(trials, 75) - np.percentile(trials, 25))
    print(f"# scoring={scoring} compile={compile_s:.1f}s iters={iters} "
          f"trials={[round(t, 1) for t in trials]} iqr={iqr:.1f}",
          file=sys.stderr)

    if args.trace:
        n_calls = 5
        hlo = fn.lower(*inputs).compile().as_text()
        with jax.profiler.trace(args.trace):
            for _ in range(n_calls):
                out = fn(*inputs)
            jax.block_until_ready(out)
        ns = device_time_by_scope(args.trace, scope_of_ops(hlo))
        busy = sum(ns.values())
        print("# device time by scope: " + ", ".join(
            f"{k}={v / n_calls / 1e6:.4f} ms/call ({v / busy:.3f})"
            for k, v in sorted(ns.items())), file=sys.stderr)

    print(json.dumps({
        "metric": "predict_audio_seconds_per_s",
        "value": round(value, 2),
        "unit": "audio-s/s",
        "vs_baseline": round(value / REFERENCE_ENDTOEND_PER_CORE, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
    }))


if __name__ == "__main__":
    main()
