#!/usr/bin/env python3
"""Scaling-efficiency measurement (BASELINE.md: 1 chip / 1 host / >=2 hosts).

Runs parallel/multihost.scaling_report on the CURRENT backend+mesh and
appends a jsonl row. Real multi-host hardware is not reachable from this
environment, so the recorded curve combines:

  * the real single-device point (run on the GPU), and
  * harness-proof points on virtual CPU meshes (run with
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N),
    which validate that the psum-sharded EM and bank-sharded scoring
    programs compile and execute at every mesh size with the expected
    per-device workload (weak-scaling shape) — the same programs a
    multi-host deployment would run, per SURVEY.md section 4(d).

CAVEAT: on a host with few physical cores, virtual-mesh rows beyond the
core count are core-OVERSUBSCRIBED — their throughput is non-monotone in
device count by construction and must not be read as scaling efficiency. The 2-process
cluster harness (experiments/multiproc_cluster.py) is the honest
multi-host datapoint this environment can produce.

Usage:
  python experiments/scaling.py --out results/local/scaling.jsonl
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python experiments/scaling.py --frames 16384 ...
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=262_144,
                    help="frames per device (weak scaling)")
    ap.add_argument("--mixtures", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--bank", type=int, default=128)
    args = ap.parse_args()

    import jax
    from speaker_recognition.parallel import multihost

    row = multihost.scaling_report(frames_per_device=args.frames,
                                   mixtures=args.mixtures, iters=args.iters,
                                   bank=args.bank)
    row.update(ts=time.time(), backend=jax.default_backend(),
               frames_per_device=args.frames)
    print(json.dumps(row))
    if args.out:
        path = args.out if os.path.isabs(args.out) else os.path.join(
            os.path.dirname(os.path.realpath(__file__)), args.out)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
