#!/usr/bin/env python3
"""Conversation-mode accuracy over time on corpus audio (VERDICT r4
item 5).

The reference published streaming identification as a GUI feature
(conversation mode: classify the last 1.5 s every 0.4 s with one-step
label smoothing, src/gui/gui.py:165-213; doc/Final-Report/img/
conversation.png shows a timeline). r4 measured only tick LATENCY; this
harness measures streaming ACCURACY: anchored-corpus speakers are
concatenated into synthetic conversations with known turn boundaries,
streamed through api/conversation.ConversationSession, and scored per
tick against the ground-truth speaker of the trailing window.

Metrics per conversation:
  * raw per-tick accuracy (the predict() label) and shown accuracy (after
    the GUI's one-step smoothing), each split into steady ticks (window
    entirely inside one turn) and transition ticks (window straddles a
    boundary — where the 1.5 s window genuinely contains two speakers);
  * smoothing gain = shown - raw on steady ticks (the smoothing exists to
    suppress single-tick flips, gui.py:196-203);
  * tick wall latency vs the 0.4 s real-time budget (the model is warmed
    up first, as a serving deployment would — ModelInterface.warmup).

Usage (GPU):
  python experiments/conversation_corpus.py --corpus "/tmp/ubmcorpus80/*.wav" \
      --out results/r5_conversation.jsonl
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
    ap.add_argument("--corpus-label", default="ubm_v7_80")
    ap.add_argument("--speakers", type=int, default=6)
    ap.add_argument("--enroll-seconds", type=float, default=20.0)
    ap.add_argument("--conv-seconds", type=float, default=120.0)
    ap.add_argument("--turn-min", type=float, default=3.0)
    ap.add_argument("--turn-max", type=float, default=8.0)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    from harness import Sample, load_corpus
    from speaker_recognition.api.conversation import ConversationSession
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.config import PipelineConfig

    samples = load_corpus(args.corpus)
    backend = jax.default_backend()
    rows = []

    def emit(row):
        row = {"backend": backend, "corpus": args.corpus_label, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    labels_all = sorted(samples.keys())
    fs = samples[labels_all[0]].fs

    for seed in range(args.trials):
        rng = random.Random(seed)
        nrng = np.random.RandomState(seed)
        labels = list(labels_all)
        rng.shuffle(labels)
        labels = labels[: args.speakers]

        model = ModelInterface(PipelineConfig())
        pools = {}
        for label in labels:
            s = samples[label]
            work = Sample(s.fs, s.signal.copy())
            _, sg, b, e = work.get_fragment_with_interval(
                args.enroll_seconds, rng)
            work.remove_subsignal(b, e)
            model.enroll(label, fs, sg)
            pools[label] = work
        model.train(seed=seed)
        # VAD noise profile: a near-silent clip like the GUI's noise
        # recording step (gui.py records ambient noise; the generator's
        # pauses are 0.003 * 12000 ~ 36-amplitude noise)
        model.init_noise(fs, 30.0 * nrng.randn(fs * 2))
        model.warmup(fs, durations=(1.5,))

        # build the conversation: random turn sequence, no back-to-back
        # repeats, each turn cut from the speaker's held-out audio
        t_total = 0.0
        turns = []  # (label, start_s, end_s)
        audio = []
        prev = None
        while t_total < args.conv_seconds:
            label = rng.choice([l for l in labels if l != prev])
            prev = label
            dur = rng.uniform(args.turn_min, args.turn_max)
            _, sg = pools[label].get_fragment(dur, rng)
            turns.append((label, t_total, t_total + len(sg) / fs))
            audio.append(sg)
            t_total += len(sg) / fs
        conv = np.concatenate(audio)

        def truth_at(t0, t1):
            """(majority speaker of [t0, t1], is_transition)."""
            best, best_ov = None, 0.0
            n_cover = 0
            for label, a, b in turns:
                ov = min(b, t1) - max(a, t0)
                if ov > 0.01:
                    n_cover += 1
                    if ov > best_ov:
                        best, best_ov = label, ov
            return best, n_cover > 1

        sess = ConversationSession(model, fs)
        chunk = int(ConversationSession.CONV_INTERVAL * fs)
        tick_walls = []
        raw, shown, is_tr = [], [], []
        for i in range(0, len(conv) - chunk + 1, chunk):
            t0 = time.perf_counter()
            sess.feed(conv[i: i + chunk])
            tick_walls.append(time.perf_counter() - t0)
            t_now = sess.now_pos / fs
            tr_label, tr_flag = truth_at(
                t_now - ConversationSession.CONV_DURATION, t_now)
            raw.append((sess.result_list[-1], tr_label))
            shown.append((sess._last_shown, tr_label))
            is_tr.append(tr_flag)

        def acc(pairs, sel):
            xs = [(p == t) for (p, t), s in zip(pairs, is_tr) if sel(s)
                  and t is not None]
            return round(float(np.mean(xs)), 4) if xs else None

        tick_ms = np.asarray(tick_walls[1:]) * 1e3  # drop first-feed
        emit({"kind": "conversation", "seed": seed,
              "n_speakers": args.speakers, "n_ticks": len(raw),
              "n_turns": len(turns),
              "n_transition_ticks": int(np.sum(is_tr)),
              "acc_raw_all": acc(raw, lambda s: True),
              "acc_shown_all": acc(shown, lambda s: True),
              "acc_raw_steady": acc(raw, lambda s: not s),
              "acc_shown_steady": acc(shown, lambda s: not s),
              "acc_raw_transition": acc(raw, lambda s: s),
              "acc_shown_transition": acc(shown, lambda s: s),
              "none_rate": round(float(np.mean(
                  [p is None for p, _ in raw])), 4),
              "tick_ms_median": round(float(np.median(tick_ms)), 1),
              "tick_ms_p90": round(float(np.percentile(tick_ms, 90)), 1),
              "tick_ms_max": round(float(tick_ms.max()), 1),
              "budget_ms": 400.0,
              "timeline_events": len(sess.timeline)})

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
