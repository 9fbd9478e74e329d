#!/usr/bin/env python3
"""Non-saturated accuracy benchmark + precision/accuracy table (VERDICT r3
item 5).

Part A (curve): closed-set accuracy vs speaker count on the HARD synthetic
corpus (make_synth_corpus.py --hard: overlapping prototype voices, session
drift, additive noise), tuned to land in the reference's 0.92-0.99 golden
regime (log/final/final-log/nperson-mix-1523-t5.log, -t3.log) so precision
claims are falsifiable.

Part B (serving-knob table): the SAME trial re-run under every knob the
serving path exposes — SRTPU_PALLAS auto/off — recorded as accuracy
deltas. Run Part B on the GPU: the knob only changes the program there.

Usage:
  python experiments/make_synth_corpus.py /tmp/hardcorpus --speakers 40 \
      --seconds 60 --hard --seed 7
  python experiments/accuracy_hard.py --corpus "/tmp/hardcorpus/*.wav" \
      --out results/r3_accuracy_hard.jsonl [--skip-curve|--skip-precision]
"""

import argparse
import json
import os
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
    ap.add_argument("--corpus", default="/tmp/hardcorpus/*.wav")
    ap.add_argument("--corpus-label", default="hard_v1",
                    help="recorded with every row (generator params)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-curve", action="store_true")
    ap.add_argument("--skip-precision", action="store_true")
    ap.add_argument("--trials", type=int, default=3,
                    help="seeds per configuration")
    ap.add_argument("--tests-per-person", type=int, default=10)
    ap.add_argument("--nspeakers", default="4,10,20,40",
                    help="comma list for the curve (r5 extends to 80)")
    ap.add_argument("--test-seconds", default="3,5",
                    help="comma list of test fragment durations")
    args = ap.parse_args()

    import jax
    from harness import load_corpus, closed_set_trial
    from speaker_recognition.config import PipelineConfig

    samples = load_corpus(args.corpus)
    backend = jax.default_backend()
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def run(n, test_s, seed, train_s=20.0):
        acc, t = closed_set_trial(
            samples, n, train_duration=train_s, test_duration=test_s,
            n_tests_per_person=args.tests_per_person,
            config=PipelineConfig(), seed=seed)
        return acc, t

    if not args.skip_curve:
        for test_s in [float(x) for x in args.test_seconds.split(",")]:
            for n in [int(x) for x in args.nspeakers.split(",")]:
                if n > len(samples):
                    continue
                accs = []
                for seed in range(args.trials):
                    acc, _ = run(n, test_s, seed)
                    accs.append(acc)
                emit({"kind": "nperson_curve", "n_speakers": n,
                      "test_seconds": test_s,
                      "n_tests": n * args.tests_per_person * args.trials,
                      "accuracy_mean": round(float(np.mean(accs)), 4),
                      "accuracy_min": round(float(np.min(accs)), 4),
                      "accuracy_max": round(float(np.max(accs)), 4),
                      "trials": accs})

    if not args.skip_precision:
        # each knob combination re-runs the SAME trials; PAIRED per-seed
        # deltas vs the default row answer "does this precision knob cost
        # accuracy?" with real statistics (VERDICT r3 item 3: >=10 seeds,
        # a paired test, and a confidence interval)
        KNOBS = [
            # (name, env overrides)
            ("default", {}),
            ("pallas_off", {"SRTPU_PALLAS": "off"}),
        ]
        KEYS = ["SRTPU_PALLAS"]
        n, test_s = min(20, len(samples)), 3.0
        knob_accs: dict[str, list] = {}
        for name, env in KNOBS:
            saved = {k: os.environ.get(k) for k in KEYS}
            for k in KEYS:
                os.environ.pop(k, None)
            os.environ.update(env)
            try:
                accs = []
                t0 = time.time()
                for seed in range(args.trials):
                    acc, _ = run(n, test_s, seed)
                    accs.append(acc)
                knob_accs[name] = accs
                emit({"kind": "precision_table", "knob": name,
                      "n_speakers": n, "test_seconds": test_s,
                      "n_tests": n * args.tests_per_person * args.trials,
                      "accuracy_mean": round(float(np.mean(accs)), 4),
                      "trials": accs,
                      "wall_s": round(time.time() - t0, 1)})
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        base = np.asarray(knob_accs.get("default", []))
        for name, accs in knob_accs.items():
            if name == "default" or len(accs) != len(base) or len(base) < 2:
                continue
            d = np.asarray(accs) - base          # paired per-seed deltas
            m = len(d)
            sd = float(d.std(ddof=1))
            se = sd / np.sqrt(m) if sd > 0 else 0.0
            t = float(d.mean() / se) if se > 0 else 0.0
            # 95% CI with the t_{m-1} critical value (table lookup keeps
            # this scipy-free; m>=31 uses the normal 1.96)
            TCRIT = {2: 12.71, 3: 4.30, 4: 3.18, 5: 2.78, 6: 2.57,
                     7: 2.45, 8: 2.36, 9: 2.31, 10: 2.26, 11: 2.23,
                     12: 2.20, 15: 2.14, 20: 2.09, 25: 2.06, 30: 2.05}
            # smallest tabulated key >= m (t decreases with df, so this is
            # the conservative neighbor); beyond the table, normal 1.96
            above = [k_ for k_ in TCRIT if k_ >= m]
            tc = TCRIT[min(above)] if above else 1.96
            emit({"kind": "precision_paired", "knob": name,
                  "vs": "default", "n_seeds": m,
                  "delta_mean": round(float(d.mean()), 4),
                  "delta_sd": round(sd, 4),
                  "ci95": [round(float(d.mean() - tc * se), 4),
                           round(float(d.mean() + tc * se), 4)],
                  "t_stat": round(t, 2),
                  "seeds_above": int(np.sum(d > 0)),
                  "seeds_below": int(np.sum(d < 0))})

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
