#!/usr/bin/env python3
"""Calibrated open-set rejection on the anchored corpus (VERDICT r4
item 4): the reference's own experiment shape (src/testbench/
test-reject.py:25-59 — enroll 2 speakers on ~8 s, genuine 3 s fragments
plus imposter files), served with a threshold CALIBRATED from a
development split (GMMSet.calibrate_rejection) instead of the fixed
constant 10 that r4 measured to reject 100% of genuine trials on this
corpus (r4_reject_ubm.jsonl).

Per seed: UBM from the dedicated background corpus; enroll E speakers
(MAP-adapted); calibrate on dev genuine/imposter margins (disjoint
speakers for dev imposters); evaluate predict_one_with_rejection on
held-out genuine tests + unseen eval imposters; round-trip the session
artifact and verify the calibrated threshold persists and the decisions
reproduce.

Usage (GPU):
  python experiments/reject_calibrated.py --out results/r5_reject_calibrated.jsonl
"""

import argparse
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
                 ".jax_cache"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="/tmp/ubmcorpus80/*.wav")
    ap.add_argument("--bg-corpus", default="/tmp/ubmbg200/*.wav")
    ap.add_argument("--corpus-label", default="ubm_v7_80")
    ap.add_argument("--enrolled", type=int, nargs="+", default=[2, 10])
    ap.add_argument("--enroll-seconds", type=float, default=8.0)
    ap.add_argument("--test-seconds", type=float, default=3.0)
    ap.add_argument("--dev-per-speaker", type=int, default=5)
    ap.add_argument("--eval-per-speaker", type=int, default=10)
    ap.add_argument("--dev-imposters", type=int, default=5)
    ap.add_argument("--eval-imposters", type=int, default=5)
    ap.add_argument("--bg-speakers", type=int, default=50)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    from harness import Sample, load_corpus
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models.gmmset import GMMSet
    from speaker_recognition.tools import ubm as ubm_tools
    from speaker_recognition.utils import serialization

    samples = load_corpus(args.corpus)
    bg_samples = load_corpus(args.bg_corpus)
    backend = jax.default_backend()
    all_labels = sorted(samples.keys())
    fs = samples[all_labels[0]].fs
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    # one UBM for all trials (offline, like the reference's)
    rngu = random.Random(99)
    bg_labels = sorted(bg_samples.keys())[: args.bg_speakers]
    bg = [extract.mix_feature(fs, bg_samples[l].get_fragment(10.0, rngu)[1])
          for l in bg_labels]
    ubm = ubm_tools.train_ubm(bg, n_mixtures=32, n_iterations=100, seed=0)

    for n_enrolled in args.enrolled:
        for seed in range(args.trials):
            rng = random.Random(seed)
            labels = list(all_labels)
            rng.shuffle(labels)
            enrolled = labels[:n_enrolled]
            k = n_enrolled
            dev_imp = labels[k: k + args.dev_imposters]
            eval_imp = labels[k + args.dev_imposters:
                              k + args.dev_imposters + args.eval_imposters]

            gs = GMMSet(ubm=ubm, config=GmmConfig(n_mixtures=32))
            works = {}
            for l in enrolled:
                work = Sample(fs, samples[l].signal.copy())
                _, sig, b, e = work.get_fragment_with_interval(
                    args.enroll_seconds, rng)
                work.remove_subsignal(b, e)
                gs.fit_new(extract.mix_feature(fs, sig), l)
                works[l] = work
            gs.train(seed=seed)

            def frags(source, n):
                return [extract.mix_feature(
                    fs, source.get_fragment(args.test_seconds, rng)[1])
                    for _ in range(n)]

            dev_gen = [f for l in enrolled
                       for f in frags(works[l], args.dev_per_speaker)]
            dev_bad = [f for l in dev_imp
                       for f in frags(Sample(fs, samples[l].signal.copy()),
                                      args.dev_per_speaker)]
            op = gs.calibrate_rejection(dev_gen, dev_bad, target="eer")

            # held-out evaluation at the calibrated threshold
            n_ca = n_fr = 0
            ev_gen = [(l, f) for l in enrolled
                      for f in frags(works[l], args.eval_per_speaker)]
            for l, f in ev_gen:
                got = gs.predict_one_with_rejection(f)
                n_ca += int(got == l)
                n_fr += int(got is None)
            n_fa = n_imp = 0
            for l in eval_imp:
                for f in frags(Sample(fs, samples[l].signal.copy()),
                               args.eval_per_speaker):
                    n_fa += int(gs.predict_one_with_rejection(f)
                                is not None)
                    n_imp += 1

            # persistence round-trip: the calibrated threshold serves
            st = gs.state()
            gs2 = GMMSet.from_state(st, config=GmmConfig(n_mixtures=32))
            same = all(
                gs2.predict_one_with_rejection(f)
                == gs.predict_one_with_rejection(f)
                for _, f in ev_gen[:5])

            emit({"kind": "reject_calibrated", "seed": seed,
                  "n_enrolled": n_enrolled,
                  "enroll_seconds": args.enroll_seconds,
                  "dev_eer": op["eer"], "threshold": round(op["threshold"], 3),
                  "fixed_threshold_10_would_reject_all":
                      bool(op["threshold"] < 10.0 and max(
                          op["genuine_margins"]) < 10.0),
                  "eval_genuine": len(ev_gen), "eval_imposter": n_imp,
                  "correct_accept_rate": round(n_ca / len(ev_gen), 4),
                  "false_reject_rate": round(n_fr / len(ev_gen), 4),
                  "false_accept_rate": round(n_fa / max(n_imp, 1), 4),
                  "roundtrip_decisions_match": bool(same)})

    if args.out:
        path = args.out if os.path.isabs(args.out) else os.path.join(
            os.path.dirname(os.path.realpath(__file__)), args.out)
        ts = time.time()
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps({"ts": ts, **row}) + "\n")
        print(f"# wrote {len(rows)} rows to {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
