#!/usr/bin/env python3
"""Parameter sweeps — the reference's test-nperson.py / test-mixture.py /
test-feature.py in one driver, emitting structured jsonl.

Examples (corpus = glob of per-speaker wavs):
  python experiments/sweep.py nperson  --corpus "corpus/*.wav" --values 4 10 20 40
  python experiments/sweep.py mixture  --corpus "corpus/*.wav" --values 16 32 64 128
  python experiments/sweep.py duration --corpus "corpus/*.wav" --values 2 3 5
  python experiments/sweep.py nceps    --corpus "corpus/*.wav" --values 13 15 19
  python experiments/sweep.py nfilter  --corpus "corpus/*.wav" --values 20 50 55
  python experiments/sweep.py nlpc     --corpus "corpus/*.wav" --values 10 15 23
  python experiments/sweep.py frontend --corpus "corpus/*.wav" --values 0 1
                              (0 = melfb.m fallback bank, 1 = bob-style
                               bounded bank; src/feature/{MFCC,BOB}.py)
"""

import argparse
import dataclasses

from harness import closed_set_trial, emit, load_corpus

from speaker_recognition.config import (FeatureConfig, GmmConfig,
                                            LpcConfig, MfccConfig,
                                            PipelineConfig, bob_mfcc_config)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sweep", choices=["nperson", "mixture", "duration",
                                      "nceps", "nfilter", "nlpc", "frontend"])
    ap.add_argument("--corpus", required=True, help="glob of wav files")
    ap.add_argument("--values", nargs="+", type=float, required=True)
    ap.add_argument("--n-persons", type=int, default=10)
    ap.add_argument("--train-duration", type=float, default=20.0)
    ap.add_argument("--test-duration", type=float, default=5.0)
    ap.add_argument("--tests-per-person", type=int, default=20)
    ap.add_argument("--mixtures", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None, help="jsonl output file")
    args = ap.parse_args()

    samples = load_corpus(args.corpus)
    print(f"# corpus: {len(samples)} speakers")

    for v in args.values:
        n_persons = args.n_persons
        mixtures = args.mixtures
        test_duration = args.test_duration
        features = FeatureConfig()
        if args.sweep == "nperson":
            n_persons = int(v)
        elif args.sweep == "mixture":
            mixtures = int(v)
        elif args.sweep == "duration":
            test_duration = float(v)
        elif args.sweep == "nceps":
            # the reference sweeps MFCC cepstra counts, test-feature.py
            features = dataclasses.replace(
                features, mfcc=dataclasses.replace(features.mfcc,
                                                   n_ceps=int(v)))
        elif args.sweep == "nfilter":
            features = dataclasses.replace(
                features, mfcc=dataclasses.replace(features.mfcc,
                                                   n_filters=int(v)))
        elif args.sweep == "nlpc":
            features = dataclasses.replace(features, lpc=LpcConfig(n_lpc=int(v)))
        elif args.sweep == "frontend":
            features = (FeatureConfig(mfcc=bob_mfcc_config()) if int(v)
                        else FeatureConfig())

        cfg = PipelineConfig(gmm=GmmConfig(n_mixtures=mixtures),
                             features=features)
        acc, timings = closed_set_trial(
            samples, n_persons, args.train_duration, test_duration,
            args.tests_per_person, cfg, seed=args.seed)
        emit({"sweep": args.sweep, "value": v, "n_persons": n_persons,
              "mixtures": mixtures, "train_duration": args.train_duration,
              "test_duration": test_duration,
              "tests_per_person": args.tests_per_person,
              "accuracy": acc, **timings}, args.log)


if __name__ == "__main__":
    main()
