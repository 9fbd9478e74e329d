#!/usr/bin/env python3
"""Differential probe: does the REFERENCE CRBM trainer (crbm.cc, driven
through tests/ref_nn_shim.cc) classify speakers on the same bob-flavor
non-CMVN features where our trainer sits at chance?

Settles the last open question of the r5 CRBM bisect
(r5_crbm_faithful.jsonl: bobraw CRBM ~chance while bobraw GMM reaches
0.93-0.99 on the single-session corpus). If the reference collapses too,
the behavior is a property of the features/corpus and parity holds; if
the reference separates speakers, our trainer diverges from crbm.cc on
this input scale and that is a bug to pin.

Usage (CPU is fine — the reference side is C++):
  python experiments/crbm_ref_probe.py --out results/r5_crbm_faithful.jsonl
"""

import argparse
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.realpath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))), "tests"))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
                 ".jax_cache"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="/tmp/ubmcrbm150s/*.wav")
    ap.add_argument("--corpus-label", default="ubm_v7_crbm150_singlesession")
    ap.add_argument("--speakers", type=int, default=6)
    ap.add_argument("--train-seconds", type=float, default=15.0)
    ap.add_argument("--tests", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--hidden", type=int, default=25,
                    help="overall_test_train_crbm's nr_h")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from harness import load_corpus
    from refbuild import ensure_refnn
    from test_differential_nn import RefCrbm
    from speaker_recognition.config import FeatureConfig, bob_mfcc_config
    from speaker_recognition.features import extract
    from speaker_recognition.models import crbm as crbm_mod
    from speaker_recognition.vad.energy import remove_silence

    if ensure_refnn() is None:
        print("reference nn core unavailable; cannot run the probe",
              file=sys.stderr)
        sys.exit(1)

    samples = load_corpus(args.corpus)
    labels = sorted(samples.keys())[: args.speakers]
    fs = samples[labels[0]].fs
    cfg = FeatureConfig(mfcc=bob_mfcc_config(cmvn=False), use_lpc=False)
    FRAMES_PER_S = 62.5
    n_train = int(args.train_seconds * FRAMES_PER_S)
    test_frames = int(5.0 * FRAMES_PER_S)

    rng = random.Random(0)
    train, tests, truth = {}, [], []
    for l in labels:
        sig = remove_silence(fs, samples[l].signal, perc=0.01)
        F = extract.mix_feature(fs, sig, cfg)
        train[l] = np.asarray(F[:n_train], np.float64)
        for _ in range(args.tests):
            pos = n_train + rng.randint(0, F.shape[0] - test_frames - n_train)
            tests.append(np.asarray(F[pos: pos + test_frames], np.float64))
            truth.append(l)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # reference trainer: full batch, CD-1, lr 0.1 (main.cc:422-439)
    t0 = time.time()
    refs = {}
    for l in labels:
        refs[l] = RefCrbm.train(train[l], args.hidden, epochs=args.epochs,
                                lr=0.1, batch=len(train[l]), cd_k=1,
                                seed=hash(l) % (2**31))
    correct = 0
    for l, X in zip(truth, tests):
        errs = {k: r.reconstruction_error(X) for k, r in refs.items()}
        correct += int(min(errs, key=errs.get) == l)
    emit({"kind": "crbm_ref_probe", "impl": "reference_crbm_cc",
          "corpus": args.corpus_label, "flavor": "bobraw",
          "train_seconds": args.train_seconds, "n_hidden": args.hidden,
          "n_speakers": len(labels), "n_tests": len(tests),
          "accuracy": round(correct / len(tests), 4),
          "wall_s": round(time.time() - t0, 1)})

    # our trainer on the identical arrays
    T = max(f.shape[0] for f in train.values())
    d = train[labels[0]].shape[1]
    Xs = np.zeros((len(labels), T, d), np.float32)
    masks = np.zeros((len(labels), T), bool)
    for i, l in enumerate(labels):
        Xs[i, : train[l].shape[0]] = train[l]
        masks[i, : train[l].shape[0]] = True
    ccfg = crbm_mod.CrbmTrainConfig(n_epochs=args.epochs, batch_size=T)
    bank = crbm_mod.fit_bank(jnp.asarray(Xs), jnp.asarray(masks),
                             args.hidden, ccfg, jax.random.PRNGKey(0))
    correct = 0
    for l, X in zip(truth, tests):
        got = crbm_mod.predict_bank(bank, labels,
                                    jnp.asarray(X, jnp.float32),
                                    jnp.ones(X.shape[0], bool))
        correct += int(got == l)
    emit({"kind": "crbm_ref_probe", "impl": "ours",
          "corpus": args.corpus_label, "flavor": "bobraw",
          "train_seconds": args.train_seconds, "n_hidden": args.hidden,
          "n_speakers": len(labels), "n_tests": len(tests),
          "accuracy": round(correct / len(tests), 4)})

    if args.out:
        path = args.out if os.path.isabs(args.out) else os.path.join(
            os.path.dirname(os.path.realpath(__file__)), args.out)
        ts = time.time()
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps({"ts": ts, **row}) + "\n")


if __name__ == "__main__":
    main()
