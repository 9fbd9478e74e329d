#!/usr/bin/env python3
"""Open-set rejection experiment — equivalent of src/testbench/test-reject.py
(enroll a subset, test genuine fragments plus imposter speakers through
predict-with-rejection), extended to report EER over the LLR scores rather
than only the fixed threshold-10 decision.

Usage:
  python experiments/reject.py --corpus "/tmp/synthcorpus/*.wav" \
      --enrolled 10 --imposters 10
"""

import argparse
import json
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import Sample, load_corpus

from speaker_recognition.config import GmmConfig
from speaker_recognition.features import extract
from speaker_recognition.models.gmmset import GMMSet
from speaker_recognition.tools import ubm as ubm_tools
from speaker_recognition.utils.metrics import eer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--enrolled", type=int, default=10)
    ap.add_argument("--imposters", type=int, default=10)
    ap.add_argument("--enroll-duration", type=float, default=15.0)
    ap.add_argument("--test-duration", type=float, default=3.0)
    ap.add_argument("--tests", type=int, default=10, help="per speaker")
    ap.add_argument("--mixtures", type=int, default=32)
    ap.add_argument("--reject-threshold", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = random.Random(args.seed)
    samples = load_corpus(args.corpus)
    labels = sorted(samples)
    rng.shuffle(labels)
    enrolled = labels[: args.enrolled]
    imposters = labels[args.enrolled: args.enrolled + args.imposters]
    fs = samples[labels[0]].fs

    # UBM from everyone's leftovers (the reference trains it offline)
    bg = []
    for l in labels[: args.enrolled + args.imposters]:
        work = Sample(fs, samples[l].signal.copy())
        _, sig = work.get_fragment(10.0, rng)
        bg.append(extract.mix_feature(fs, sig))
    ubm = ubm_tools.train_ubm(bg, n_mixtures=args.mixtures, n_iterations=100)

    gs = GMMSet(ubm=ubm, reject_threshold=args.reject_threshold,
                config=GmmConfig(n_mixtures=args.mixtures))
    tests = []
    for l in enrolled:
        work = Sample(fs, samples[l].signal.copy())
        fs_, sig, b, e = work.get_fragment_with_interval(args.enroll_duration, rng)
        work.remove_subsignal(b, e)
        gs.fit_new(extract.mix_feature(fs, sig), l)
        for _ in range(args.tests):
            _, t = work.get_fragment(args.test_duration, rng)
            tests.append((l, t))
    gs.train()

    genuine, imposter_scores = [], []
    correct_accept = reject_genuine = 0
    for l, t in tests:
        feat = extract.mix_feature(fs, t)
        scores, u = gs.llr_scores(feat)
        best = int(np.argmax(scores))
        llr = float(scores[best]) - u
        genuine.append(llr)
        if llr < gs.reject_threshold:
            reject_genuine += 1
        elif gs.y[best] == l:
            correct_accept += 1

    false_accept = 0
    n_imp = 0
    for l in imposters:
        work = Sample(fs, samples[l].signal.copy())
        for _ in range(args.tests):
            _, t = work.get_fragment(args.test_duration, rng)
            feat = extract.mix_feature(fs, t)
            scores, u = gs.llr_scores(feat)
            llr = float(np.max(scores)) - u
            imposter_scores.append(llr)
            if llr >= gs.reject_threshold:
                false_accept += 1
            n_imp += 1

    eer_val, eer_thr = eer(genuine, imposter_scores)
    print(json.dumps({
        "enrolled": len(enrolled), "imposters": len(imposters),
        "genuine_tests": len(tests), "imposter_tests": n_imp,
        "correct_accept_rate": correct_accept / len(tests),
        "false_reject_rate": reject_genuine / len(tests),
        "false_accept_rate": false_accept / max(n_imp, 1),
        "reject_threshold": args.reject_threshold,
        "eer": round(eer_val, 4), "eer_threshold": round(eer_thr, 3),
    }))


if __name__ == "__main__":
    main()
