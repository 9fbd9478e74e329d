#!/usr/bin/env python3
"""JFA vs MAP with a FAIR background population and deliberate channel
mismatch (VERDICT r4 item 2).

r4's negative result (MAP dominates JFA at every configuration,
r4_jfa_accuracy.jsonl) was forced by construction: the background half of
a 40-speaker corpus leaves 20-32 background speakers, so a low-rank
eigenvoice space has nothing to estimate from. This harness gives JFA the
fight it was designed for (linear_scoring.m:50-71, estimate_x_and_u.m):

  * background: a DEDICATED generator cast of 100-300 speakers (the
    reference's own UBM reflects 300 utterances), multi-session;
  * channel mismatch: every session (background, enrollment, test) passes
    through its own random linear channel — spectral tilt + two peaking
    EQs at +-strength dB (telephone/room-EQ family). Enrollment and test
    channels differ, which is exactly the variability the eigenchannels
    u exist to absorb. Note the MFCC block is per-utterance CMVN'd
    (MFCC.py:74-77) so a linear channel mostly survives in the LPC dims
    — compensation has to come from the model, not the features;
  * sweep nv x nu at fixed background scale, plus a bg-size axis, with a
    channel-free control of every cell.

Usage (GPU, exclusive host):
  python experiments/jfa_channel.py --bg-corpus "/tmp/ubmbg200/*.wav" \
      --eval-corpus "/tmp/ubmcorpus80/*.wav" \
      --out results/r5_jfa_channel.jsonl
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
import scipy.signal as sig_mod


def apply_channel(sig, fs, rng, strength_db):
    """One session's linear channel: first-order spectral tilt + two
    RBJ peaking EQs with gains drawn in +-strength_db. strength 0 = identity."""
    if strength_db <= 0:
        return sig
    out = np.asarray(sig, np.float64)
    # tilt: H(z) = 1 - c z^-1 (c>0 brightens, c<0 darkens), scaled so
    # strength_db ~ 6 gives |c| up to ~0.4
    c = (rng.rand() * 2 - 1) * min(0.4 * strength_db / 6.0, 0.8)
    out = sig_mod.lfilter([1.0, -c], [1.0], out)
    for _ in range(2):
        f0 = 300.0 + rng.rand() * 3200.0
        q = 1.0 + rng.rand() * 2.0
        gain = (rng.rand() * 2 - 1) * strength_db
        A = 10.0 ** (gain / 40.0)
        w0 = 2 * np.pi * f0 / fs
        alpha = np.sin(w0) / (2 * q)
        b = [1 + alpha * A, -2 * np.cos(w0), 1 - alpha * A]
        a = [1 + alpha / A, -2 * np.cos(w0), 1 - alpha / A]
        out = sig_mod.lfilter(b, a, out)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bg-corpus", default="/tmp/ubmbg200/*.wav")
    ap.add_argument("--eval-corpus", default="/tmp/ubmcorpus80/*.wav")
    ap.add_argument("--corpus-label", default="ubm_v7_bg200")
    ap.add_argument("--eval-speakers", type=int, default=20)
    ap.add_argument("--bg-speakers", type=int, nargs="+", default=[200])
    ap.add_argument("--bg-sessions", type=int, default=3)
    ap.add_argument("--session-seconds", type=float, default=10.0)
    ap.add_argument("--enroll-sessions", type=int, default=2)
    ap.add_argument("--tests", type=int, default=10, help="per speaker")
    ap.add_argument("--test-seconds", type=float, default=3.0)
    ap.add_argument("--nv", type=int, nargs="+", default=[4, 8, 16, 32, 50])
    ap.add_argument("--nu", type=int, nargs="+", default=[2, 16])
    ap.add_argument("--channel-db", type=float, nargs="+", default=[0.0, 6.0])
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--jfa-iters", type=int, default=20)
    ap.add_argument("--train-d", action="store_true",
                    help="train the residual diagonal d (train_all.m's "
                         "third stage) — the high-rank speaker term")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from harness import Sample, load_corpus
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm as gmm_mod
    from speaker_recognition.tools import jfa_pipeline, ubm as ubm_tools
    from speaker_recognition.utils.metrics import eer

    bg_samples = load_corpus(args.bg_corpus)
    ev_samples = load_corpus(args.eval_corpus)
    backend = jax.default_backend()
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    bg_all = sorted(bg_samples.keys())
    ev_all = sorted(ev_samples.keys())
    fs = bg_samples[bg_all[0]].fs

    def ver_eer(scores, truth):
        genuine = scores[truth, np.arange(len(truth))]
        m = np.ones_like(scores, bool)
        m[truth, np.arange(len(truth))] = False
        rate, _thr = eer(genuine, scores[m])
        return float(rate)

    for seed in range(args.trials):
        for ch_db in args.channel_db:
            rng = random.Random(seed)
            nrng = np.random.RandomState(10_000 * seed + int(ch_db * 10))
            ev_labels = list(ev_all)
            rng.shuffle(ev_labels)
            ev_labels = ev_labels[: args.eval_speakers]

            # -- eval features (shared across every bg/nv/nu cell) -------
            enroll_feats, enroll_ids, test_feats, truth = [], [], [], []
            for si, label in enumerate(ev_labels):
                s = ev_samples[label]
                work = Sample(s.fs, s.signal.copy())
                for _ in range(args.enroll_sessions):
                    _, sg, b, e = work.get_fragment_with_interval(
                        args.session_seconds, rng)
                    work.remove_subsignal(b, e)
                    sg = apply_channel(sg, fs, nrng, ch_db)
                    enroll_feats.append(extract.mix_feature(fs, sg))
                    enroll_ids.append(si)
                for _ in range(args.tests):
                    _, tsig = work.get_fragment(args.test_seconds, rng)
                    tsig = apply_channel(tsig, fs, nrng, ch_db)
                    test_feats.append(extract.mix_feature(fs, tsig))
                    truth.append(si)
            S = len(ev_labels)
            truth_a = np.asarray(truth)

            for n_bg in args.bg_speakers:
                bg_labels = list(bg_all)
                random.Random(100 + seed).shuffle(bg_labels)
                bg_labels = bg_labels[:n_bg]

                bg_feats, bg_ids = [], []
                for si, label in enumerate(bg_labels):
                    s = bg_samples[label]
                    for _ in range(args.bg_sessions):
                        _, sg = s.get_fragment(args.session_seconds, rng)
                        sg = apply_channel(sg, fs, nrng, ch_db)
                        bg_feats.append(extract.mix_feature(fs, sg))
                    bg_ids.extend([si] * args.bg_sessions)
                ubm = ubm_tools.train_ubm(bg_feats, n_mixtures=32,
                                          n_iterations=100, seed=seed)
                N_bg, F_bg = jfa_pipeline.collect_session_stats(ubm, bg_feats)
                N_en, F_en = jfa_pipeline.collect_session_stats(
                    ubm, enroll_feats)
                N_te, F_te = jfa_pipeline.collect_session_stats(
                    ubm, test_feats)

                # -- MAP baseline (once per seed/channel/bg cell) --------
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
                bank_j = jax.tree.map(
                    lambda a: jnp.asarray(a, jnp.float32), bank)
                ubm_j = jax.tree.map(
                    lambda a: jnp.asarray(a, jnp.float32), ubm)
                bs = np.asarray(gmm_mod.batch_bank_avg_loglik(
                    bank_j, jnp.asarray(X), jnp.asarray(mask)))
                us = np.asarray(jax.jit(jax.vmap(
                    lambda x, m: gmm_mod.avg_loglik(ubm_j, x, m)))(
                    jnp.asarray(X), jnp.asarray(mask)))
                scores_map = (bs - us[:, None]).T
                acc_map = float((scores_map.argmax(axis=0) == truth_a).mean())
                eer_map = ver_eer(scores_map, truth_a)
                emit({"kind": "map_baseline", "seed": seed,
                      "channel_db": ch_db, "n_bg": n_bg, "n_eval": S,
                      "n_tests": len(test_feats),
                      "acc_map": round(acc_map, 4),
                      "eer_map": round(eer_map, 4)})

                for nv in args.nv:
                    for nu in args.nu:
                        t0 = time.time()
                        model = jfa_pipeline.train_jfa(
                            ubm, N_bg, F_bg, bg_ids, nv=nv, nu=nu,
                            n_iter=args.jfa_iters, seed=seed,
                            train_d=args.train_d)
                        y, z = jfa_pipeline.enroll(
                            model, N_en, F_en, enroll_ids, S)
                        scores_jfa = jfa_pipeline.score(
                            model, y, z, N_te, F_te)
                        acc_jfa = float(
                            (scores_jfa.argmax(axis=0) == truth_a).mean())
                        eer_jfa = ver_eer(scores_jfa, truth_a)
                        emit({"kind": "jfa_cell", "seed": seed,
                              "channel_db": ch_db, "n_bg": n_bg,
                              "nv": nv, "nu": nu,
                              "train_d": bool(args.train_d),
                              "acc_jfa": round(acc_jfa, 4),
                              "eer_jfa": round(eer_jfa, 4),
                              "acc_map": round(acc_map, 4),
                              "eer_map": round(eer_map, 4),
                              "train_wall_s": round(time.time() - t0, 1)})

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
