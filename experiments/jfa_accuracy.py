#!/usr/bin/env python3
"""JFA channel compensation vs GMM-UBM MAP on the anchored corpus.

The reference only ever ran its JFA subsystem offline in MATLAB on
precomputed stats; this harness exercises the full JAX JFA chain
(tools/jfa_pipeline) END TO END on corpus audio and measures whether
channel compensation pays on a corpus with real session variability (the
UBM-anchored generator drifts the vocal-tract warp per 7.5 s session —
exactly the variability JFA's eigenchannels model).

Protocol (speakers split disjointly):
  background half: per-speaker multi-session stats -> train v (eigenvoices)
                   and u (eigenchannels); pooled frames -> 32-mix UBM
  eval half:       enroll sessions per speaker; test fragments scored by
                   (a) MAP-adapted GMM LLR (the production open-set path)
                   (b) JFA linear scoring (sc_score_dot_product.m shape)
  metrics:         closed-set accuracy (argmax over models) and
                   verification EER over the (model, test) score matrix

Usage:
  python experiments/jfa_accuracy.py --corpus "/tmp/ubmcorpus/*.wav" \
      --out results/local/r4_jfa_accuracy.jsonl
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
    ap.add_argument("--corpus", default="/tmp/ubmcorpus/*.wav")
    ap.add_argument("--corpus-label", default="ubm_v6_cast")
    ap.add_argument("--eval-speakers", type=int, default=20)
    ap.add_argument("--sessions", type=int, default=5,
                    help="background sessions per speaker")
    ap.add_argument("--session-seconds", type=float, default=10.0)
    ap.add_argument("--enroll-sessions", type=int, default=2)
    ap.add_argument("--tests", type=int, default=10, help="per speaker")
    ap.add_argument("--test-seconds", type=float, default=3.0)
    ap.add_argument("--nv", type=int, default=4,
                    help="eigenvoices (kscore_famous_19.m config)")
    ap.add_argument("--nu", type=int, default=2, help="eigenchannels")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from harness import Sample, load_corpus
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm as gmm_mod
    from speaker_recognition.tools import jfa_pipeline, ubm as ubm_tools
    from speaker_recognition.utils.metrics import eer

    samples = load_corpus(args.corpus)
    backend = jax.default_backend()
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    all_labels = sorted(samples.keys())
    fs = samples[all_labels[0]].fs

    for seed in range(args.trials):
        rng = random.Random(seed)
        labels = list(all_labels)
        rng.shuffle(labels)
        eval_labels = labels[: args.eval_speakers]
        bg_labels = labels[args.eval_speakers:]

        # -- background: multi-session stats + UBM -----------------------
        bg_feats, bg_ids = [], []
        for si, label in enumerate(bg_labels):
            s = samples[label]
            for _ in range(args.sessions):
                _, sig = s.get_fragment(args.session_seconds, rng)
                bg_feats.append(extract.mix_feature(fs, sig))
            bg_ids.extend([si] * args.sessions)
        ubm = ubm_tools.train_ubm(bg_feats, n_mixtures=32, n_iterations=100,
                                  seed=seed)
        N_bg, F_bg = jfa_pipeline.collect_session_stats(ubm, bg_feats)
        model = jfa_pipeline.train_jfa(ubm, N_bg, F_bg, bg_ids,
                                       nv=args.nv, nu=args.nu,
                                       n_iter=20, seed=seed)

        # -- eval: enroll sessions + test fragments ----------------------
        enroll_feats, enroll_ids, test_feats, truth = [], [], [], []
        for si, label in enumerate(eval_labels):
            s = samples[label]
            work = Sample(s.fs, s.signal.copy())
            for _ in range(args.enroll_sessions):
                _, sig, b, e = work.get_fragment_with_interval(
                    args.session_seconds, rng)
                work.remove_subsignal(b, e)
                enroll_feats.append(extract.mix_feature(fs, sig))
                enroll_ids.append(si)
            for _ in range(args.tests):
                _, tsig = work.get_fragment(args.test_seconds, rng)
                test_feats.append(extract.mix_feature(fs, tsig))
                truth.append(si)
        S = len(eval_labels)
        truth = np.asarray(truth)

        # (a) JFA linear scoring
        N_en, F_en = jfa_pipeline.collect_session_stats(ubm, enroll_feats)
        y, z = jfa_pipeline.enroll(model, N_en, F_en, enroll_ids, S)
        N_te, F_te = jfa_pipeline.collect_session_stats(ubm, test_feats)
        scores_jfa = jfa_pipeline.score(model, y, z, N_te, F_te)  # [S, n]
        pred = scores_jfa.argmax(axis=0)
        acc_jfa = float((pred == truth).mean())

        # (b) MAP-adapted GMM LLR (production open-set quantities)
        per_spk = [[] for _ in range(S)]
        for f, si in zip(enroll_feats, enroll_ids):
            per_spk[si].append(f)
        feat_dict = {i: np.concatenate(fl, axis=0)
                     for i, fl in enumerate(per_spk)}
        _, bank = ubm_tools.adapt_speakers(ubm, feat_dict)
        T = max(f.shape[0] for f in test_feats)
        d = test_feats[0].shape[1]
        X = np.zeros((len(test_feats), T, d), np.float32)
        mask = np.zeros((len(test_feats), T), bool)
        for i, f in enumerate(test_feats):
            X[i, : f.shape[0]] = f
            mask[i, : f.shape[0]] = True
        bank_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), bank)
        ubm_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ubm)
        bs = np.asarray(gmm_mod.batch_bank_avg_loglik(
            bank_j, jnp.asarray(X), jnp.asarray(mask)))        # [n, S]
        us = np.asarray(jax.jit(jax.vmap(
            lambda x, m: gmm_mod.avg_loglik(ubm_j, x, m)))(
            jnp.asarray(X), jnp.asarray(mask)))                # [n]
        scores_map = (bs - us[:, None]).T                      # [S, n]
        acc_map = float((scores_map.argmax(axis=0) == truth).mean())

        def ver_eer(scores):
            genuine = scores[truth, np.arange(len(truth))]
            mask_imp = np.ones_like(scores, bool)
            mask_imp[truth, np.arange(len(truth))] = False
            rate, _thr = eer(genuine, scores[mask_imp])
            return float(rate)

        e_jfa = ver_eer(scores_jfa)
        e_map = ver_eer(scores_map)

        emit({"kind": "jfa_vs_map", "seed": seed,
              "n_eval": S, "n_bg": len(bg_labels),
              "nv": args.nv, "nu": args.nu,
              "n_tests": len(test_feats),
              "acc_jfa": round(acc_jfa, 4), "acc_map": round(acc_map, 4),
              "eer_jfa": None if e_jfa is None else round(e_jfa, 4),
              "eer_map": None if e_map is None else round(e_map, 4)})

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
