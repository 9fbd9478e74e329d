#!/usr/bin/env python3
"""Attribute the 40-speaker accuracy shortfall (VERDICT r4 weak 1 / item 1).

r4 measured 0.887 at 40 speakers / 5 s tests on the anchored corpus vs the
reference's published 0.952-0.968 (log/final/final-log/nperson-mix-1523-
t5.log tail). Two hypotheses:

  (a) MODEL degradation: the bank scores worse as S grows (a bug — the
      scoring program is one joint matmul; nothing should degrade);
  (b) CORPUS crowding: the synthetic speaker distribution has a heavier
      close-pair tail than 40 real voices, so more tests have a near-twin
      competitor — the per-model quality is unchanged.

Isolation: train ONE 40-speaker bank, score every test against all 40,
then re-decide each test under restricted argmax over random n-sub-speaker
subsets that contain the true speaker. The restricted decision uses the
SAME trained models and SAME test features — only the competitor count
changes. If D(n_sub) (density curve, bank trained at 40) matches A(n)
(true curve, bank trained at n — r5_accuracy_ubm.jsonl) at n = 4/10/20,
the bank does not degrade with size and the whole drop is competitor
density (b). Margin and per-pair error concentration quantify the
crowding: if the top few speaker pairs carry most errors, the corpus has
close-twin pairs real voices would not produce at this density.

Usage:
  python experiments/nperson_attribution.py --corpus "/tmp/ubmcorpus80/*.wav" \
      --out results/r5_nperson_attribution.jsonl
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


def scored_trial(samples, n_persons, train_s, test_s, tests_per_person,
                 config, seed):
    """Like harness.closed_set_trial but returns the raw [n_tests, S]
    score matrix (speaker order = model.gmmset.y) plus truth indices."""
    from harness import Sample
    from speaker_recognition.api.interface import ModelInterface

    rng = random.Random(seed)
    labels = sorted(samples.keys())
    rng.shuffle(labels)
    labels = labels[:n_persons]

    model = ModelInterface(config)
    test_pool = []
    for label in labels:
        s = samples[label]
        work = Sample(s.fs, s.signal.copy())
        fs, sig, b, e = work.get_fragment_with_interval(train_s, rng)
        work.remove_subsignal(b, e)  # unbiased split (test-feature.py:178)
        model.enroll(label, fs, sig)
        for _ in range(tests_per_person):
            _, tsig = work.get_fragment(test_s, rng)
            test_pool.append((label, tsig))
    model.train()
    fs = samples[labels[0]].fs
    scores, valid = model.scores_batch(fs, [s for _, s in test_pool])
    order = {l: i for i, l in enumerate(model.gmmset.y)}
    truth = np.asarray([order[l] for l, _ in test_pool])
    assert valid.all()
    return scores, truth, model.gmmset.y


def density_curve(scores, truth, n_sub, n_subsets, rng):
    """Accuracy under restricted argmax over random subsets containing
    the true speaker — same models, same tests, fewer competitors."""
    n_tests, S = scores.shape
    correct = 0
    total = 0
    others = np.arange(S)
    for i in range(n_tests):
        t = truth[i]
        pool = others[others != t]
        for _ in range(n_subsets):
            sub = rng.choice(pool, size=n_sub - 1, replace=False)
            best_other = scores[i, sub].max()
            correct += int(scores[i, t] > best_other)
            total += 1
    return correct / total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="/tmp/ubmcorpus80/*.wav")
    ap.add_argument("--corpus-label", default="ubm_v7_80")
    ap.add_argument("--out", default=None)
    ap.add_argument("--n-bank", type=int, default=40)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--tests-per-person", type=int, default=10)
    ap.add_argument("--test-seconds", type=float, default=5.0)
    ap.add_argument("--train-seconds", type=float, default=20.0)
    ap.add_argument("--n-subsets", type=int, default=16)
    args = ap.parse_args()

    import jax
    from harness import load_corpus
    from speaker_recognition.config import PipelineConfig

    samples = load_corpus(args.corpus)
    backend = jax.default_backend()
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label,
               "n_bank": args.n_bank, "test_seconds": args.test_seconds,
               **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    sub_sizes = [n for n in (4, 10, 20) if n < args.n_bank]
    full_accs, dens = [], {n: [] for n in sub_sizes}
    margins_all, err_pairs = [], {}
    for seed in range(args.trials):
        scores, truth, labels = scored_trial(
            samples, args.n_bank, args.train_seconds, args.test_seconds,
            args.tests_per_person, PipelineConfig(), seed)
        pred = scores.argmax(axis=-1)
        full_accs.append(float((pred == truth).mean()))
        # margin of the truth over the best competitor (negative = error)
        comp = scores.copy()
        comp[np.arange(len(truth)), truth] = -np.inf
        margins = scores[np.arange(len(truth)), truth] - comp.max(axis=-1)
        margins_all.extend(margins.tolist())
        for i in np.nonzero(pred != truth)[0]:
            pair = tuple(sorted((labels[truth[i]], labels[pred[i]])))
            err_pairs[pair] = err_pairs.get(pair, 0) + 1
        rng = np.random.RandomState(1000 + seed)
        for n in sub_sizes:
            dens[n].append(density_curve(scores, truth, n,
                                         args.n_subsets, rng))

    emit({"kind": "full_bank", "accuracy_mean":
          round(float(np.mean(full_accs)), 4), "trials":
          [round(a, 4) for a in full_accs]})
    for n in sub_sizes:
        emit({"kind": "density_curve", "n_sub": n,
              "accuracy_mean": round(float(np.mean(dens[n])), 4),
              "accuracy_sd": round(float(np.std(dens[n])), 4),
              "trials": [round(a, 4) for a in dens[n]],
              "note": "same 40-trained bank, restricted argmax — compare "
                      "with the A(n) rows of r5_accuracy_ubm.jsonl"})
    m = np.asarray(margins_all)
    n_err = int((m < 0).sum())
    emit({"kind": "margins", "n_tests": len(m),
          "n_errors": n_err,
          "margin_p5": round(float(np.percentile(m, 5)), 3),
          "margin_p25": round(float(np.percentile(m, 25)), 3),
          "margin_median": round(float(np.median(m)), 3),
          "frac_margin_below_half_nat": round(float((m < 0.5).mean()), 4)})
    top = sorted(err_pairs.items(), key=lambda kv: -kv[1])[:8]
    total_err = sum(err_pairs.values()) or 1
    emit({"kind": "error_pair_concentration",
          "n_distinct_pairs": len(err_pairs),
          "total_errors": total_err,
          "top8_share": round(sum(c for _, c in top) / total_err, 3),
          "top_pairs": [{"pair": list(p), "count": c} for p, c in top]})

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
