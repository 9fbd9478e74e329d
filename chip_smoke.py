#!/usr/bin/env python3
"""Smoke test of the speaker-ID system on one NVIDIA GPU.

Drives the enroll -> train -> predict path through the entry points a user
calls (cli.main, ModelInterface.scores_batch / predict, the conversation
tick) at the repo's full model width: MFCC13+LPC15 features (d=28) at
8 kHz, GMM-32 speaker models, and an 80-speaker x 256-mixture bank
MAP-adapted from a UBM. Audio is synthetic and made from --seed. Every
phase is compared with the plain reference (the XLA extractor plus
gmm.bank_avg_loglik under float32 "highest" matmul precision, and the
float64 feature oracles of tests/oracles.py).

    python chip_smoke.py           # all one-card phases
    python chip_smoke.py --four    # the multi-device paths on 4 GPUs only

Exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 8000

# -- tolerances ------------------------------------------------------------
# Features against the float64 oracle, medians of |err| over frames. The
# extractor computes float32 products, so only float32 rounding remains:
# the CPU's float32 run of this phase measures MFCC 3.4e-6 and LPC 6.2e-4
# (float32 Levinson on the corpus's sharply resonant voices is
# ill-conditioned), hence the looser LPC bound.
FEAT_MEDIAN_TOL = {"mfcc": 1e-4, "lpc": 5e-3}
# Per-frame average log-likelihoods (nats/frame) of the served path against
# the reference: a score may differ by SCORE_RTOL * |ref| + SCORE_ATOL, plus
# the rounding and floor slacks below. Both compute float32 products
# (models/gmm.PRECISION, the kernel's 3xTF32 dots) in different summation
# orders. Decision rule: every argmax that disagrees with the reference
# must have a reference top-2 margin below that score's tolerance.
SCORE_RTOL = 1e-4
SCORE_ATOL = 1e-3
# Rounding of the expanded log-density x^2 A + x B + c is relative to the
# size of its terms, not of their sum: with EM's floor sigma
# sqrt(min_covar) = 0.032 and feature values up to ~190, one term reaches
# ~1e7 nats while the density is ~1. Each score's bound therefore grows by
# MAG_RTOL times the masked frame mean of sum_k p_k |terms_k| (p_k the
# component posterior: the first-order error of the logsumexp). float32
# products round at 2^-24 relative and the kernel's 3xTF32 split at about
# 2^-21 (the TF32 rounding of the lo operand), so 2e-6 leaves a factor of
# four over the kernel's worst case.
MAG_RTOL = 2e-6
# The reference's probability floor is a step: a frame whose log-density
# falls below gmm._UNDERFLOW_LOG (-745) scores log(1e-15) = -34.5 instead.
# A frame within float32 rounding of that step may land on either side in
# two correct programs, and one such frame moves a 5 s clip's average by
# 710 / 311 = 2.3 nats. Each reference frame within FLOOR_BAND nats of the
# step (far wider than any per-frame rounding) widens its score's bound by
# the largest jump such a frame can make, 710 + FLOOR_BAND nats, over the
# clip's frame count.
FLOOR_BAND = 1.0
# One EM iteration of the trained UBM on the card against the float64
# oracle transcribed from the reference's gmm.cc (tests/oracles.py): the
# largest parameter error over the largest parameter magnitude. Float32
# statistics summed over ~50k frames, and variances formed as
# E[x^2] - mean^2, leave ~1e-5 of relative error.
UBM_RTOL = 1e-3
# Multi-device paths against one device, both at "highest".
SHARDED_RTOL = 1e-4
# Closed-set accuracy on the easily separated synthetic corpus.
MIN_ACCURACY = 0.95


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    """`nvidia-smi` name and power limit of the visible cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def require_gpu(n: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n:
        raise SystemExit(
            f"chip_smoke: needs {n} NVIDIA GPU(s); JAX found "
            f"{len(devices)} {devices[0].platform} device(s)")
    return devices


def _import_repo():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from speaker_recognition.utils import compile_cache
    compile_cache.enable()


# -- synthetic audio -------------------------------------------------------

def make_voices(n_speakers: int, seed: int):
    import make_synth_corpus as msc
    rng = np.random.RandomState(seed)
    return [msc.make_speaker(rng) for _ in range(n_speakers)]


def speak(voice, seconds: float, rng) -> np.ndarray:
    import make_synth_corpus as msc
    return msc.synth(voice, seconds, rng)


# -- the plain reference ---------------------------------------------------

def reference_scores(bank, sigs, cfg=None) -> tuple:
    """extract_batch + vmapped gmm.bank_avg_loglik at float32 'highest',
    with the floor and rounding slacks of each score's bound."""
    import jax
    import jax.numpy as jnp
    from speaker_recognition.config import FeatureConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm

    cfg = cfg or FeatureConfig()
    batch, lengths = pad_batch(sigs)
    fn = extract._feature_fn(FS, cfg, batch.shape[1], "float32")
    bank = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), bank)
    with jax.default_matmul_precision("highest"):
        feats, mask = fn(jnp.asarray(batch), jnp.asarray(lengths))
        scores = jax.jit(jax.vmap(
            lambda X, m: gmm.bank_avg_loglik(bank, X, m)))(feats, mask)
    return (np.asarray(scores), floor_slack(bank, feats, mask),
            rounding_slack(bank, feats, mask))


def rounding_slack(bank, feats, mask) -> np.ndarray:
    """[B, S] MAG_RTOL x the masked frame mean of the posterior-weighted
    magnitude of the log-density's terms (frames the reference floors
    carry none: the floor is exact)."""
    import jax
    import jax.numpy as jnp
    from speaker_recognition.models import gmm

    def frame_mag(X):                                      # [T, d] -> [S, T]
        def one(p):
            inv = 1.0 / (p.sigmas * p.sigmas)              # [K, d]
            mag = ((X * X) @ (0.5 * inv).T + jnp.abs(X) @ jnp.abs(
                p.means * inv).T
                + jnp.sum(0.5 * p.means * p.means * inv
                          + jnp.abs(gmm.LOG_SQRT_2_PI + jnp.log(p.sigmas)),
                          axis=-1)
                + jnp.abs(jnp.log(p.weights)))             # [T, K]
            logp = gmm.log_joint(p, X)
            lse = jax.scipy.special.logsumexp(logp, axis=-1)
            post = jnp.exp(logp - lse[:, None])
            return jnp.where(lse > gmm._UNDERFLOW_LOG,
                             jnp.sum(post * mag, axis=-1), 0.0)
        return jax.vmap(one)(bank)

    with jax.default_matmul_precision("highest"):
        mag = np.asarray(jax.jit(lambda F: jax.lax.map(frame_mag, F))(feats))
    mask = np.asarray(mask)
    return (MAG_RTOL * (mag * mask[:, None]).sum(-1)
            / np.maximum(mask.sum(-1), 1)[:, None])


def floor_slack(bank, feats, mask) -> np.ndarray:
    """[B, S] extra score tolerance: the reference frames within FLOOR_BAND
    of the underflow step, times their largest jump over the frame count."""
    import jax
    from speaker_recognition.models import gmm

    def frame_lse(X):                                      # [T, d] -> [S, T]
        return jax.vmap(lambda p: jax.scipy.special.logsumexp(
            gmm.log_joint(p, X), axis=-1))(bank)

    with jax.default_matmul_precision("highest"):
        lse = np.asarray(jax.jit(lambda F: jax.lax.map(frame_lse, F))(feats))
    mask = np.asarray(mask)
    near = (np.abs(lse - gmm._UNDERFLOW_LOG) < FLOOR_BAND) & mask[:, None]
    jump = np.log(1e-15) - gmm._UNDERFLOW_LOG + FLOOR_BAND
    return near.sum(-1) * jump / np.maximum(mask.sum(-1), 1)[:, None]


def pad_batch(sigs, rows=None):
    """[rows or len(sigs), L] float32 batch padded to the length bucket,
    with its lengths (padding rows have length 0)."""
    from speaker_recognition.features import extract
    L = max(len(s) for s in sigs)
    L = -(-L // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
    batch = np.zeros((rows or len(sigs), L), np.float32)
    lengths = np.zeros(len(batch), np.int32)
    for i, s in enumerate(sigs):
        batch[i, :len(s)] = s
        lengths[i] = len(s)
    return batch, lengths


def check_scores(name: str, got: np.ndarray, want: np.ndarray,
                 slack=0.0, rounding=0.0) -> dict:
    """Served scores against the reference, with the decision rule;
    `slack` and `rounding` are floor_slack's and rounding_slack's
    widening of each score's bound."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape} "
                             f"or non-finite scores")
    tol = SCORE_RTOL * np.abs(want) + SCORE_ATOL + slack + rounding
    err = np.abs(got - want)
    if (err > tol).any():
        i = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(f"{name}: score {got[i]:.4f} vs reference "
                             f"{want[i]:.4f} exceeds its tolerance")
    top2 = np.sort(want, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    flips = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
    bad = [int(i) for i in flips
           if margin[i] >= tol[i, want[i].argmax()]]
    if bad:
        raise AssertionError(f"{name}: decisions differ where the "
                             f"reference margin exceeds the tolerance: {bad}")
    return {"max_abs_err": float(err.max()),
            "median_abs_err": float(np.median(err)),
            "argmax_flips": int(len(flips)),
            "min_ref_margin": float(margin.min()),
            "max_err_over_tol": float((err / tol).max()),
            "floor_step_scores": int(np.count_nonzero(slack))}


# -- phases ----------------------------------------------------------------

def check_features(sigs, feats) -> dict:
    """Rows of a batched feature array against the float64 oracles, per
    stage (MFCC columns, LPC columns): medians and p99 of |err|."""
    from oracles import oracle_lpc, oracle_mfcc
    from speaker_recognition.config import frame_geometry, n_frames

    flen, fshift = frame_geometry(FS, 32, 16)
    errs = {"mfcc": [], "lpc": []}
    for s, f in zip(sigs, feats):
        s = np.asarray(s, np.float64)
        want = np.concatenate([oracle_mfcc(FS, s), oracle_lpc(FS, s)], axis=1)
        e = np.abs(np.asarray(f)[:n_frames(len(s), flen, fshift)] - want)
        errs["mfcc"].append(e[:, :13].ravel())
        errs["lpc"].append(e[:, 13:].ravel())
    out = {}
    for stage, parts in errs.items():
        e = np.concatenate(parts)
        med = float(np.median(e))
        out[f"{stage}_median"] = med
        out[f"{stage}_p99"] = float(np.percentile(e, 99))
        if not med < FEAT_MEDIAN_TOL[stage]:
            raise AssertionError(f"features {stage}: median |err| {med:.3g}"
                                 f" >= {FEAT_MEDIAN_TOL[stage]}")
    return out


def phase_features(voices, seed: int, n_utts: int = 3,
                   seconds: float = 5.0) -> dict:
    """The batched extractor against the float64 oracles, per stage, on
    clips of different lengths."""
    import jax.numpy as jnp
    from speaker_recognition.config import FeatureConfig
    from speaker_recognition.features import extract

    rng = np.random.RandomState(seed + 1)
    sigs = [speak(voices[i % len(voices)], seconds * (1 - 0.1 * i), rng)
            for i in range(n_utts)]
    batch, lengths = pad_batch(sigs)
    fn = extract._feature_fn(FS, FeatureConfig(), batch.shape[1], "float32")
    return check_features(sigs, fn(jnp.asarray(batch),
                                   jnp.asarray(lengths))[0])


def write_corpus(root: str, voices, seed: int, enroll_clips: int,
                 test_clips: int, seconds: float):
    """Speaker dirs of enrollment wavs plus a test dir; returns the test
    files with their true labels."""
    import scipy.io.wavfile as wavfile
    rng = np.random.RandomState(seed + 2)
    dirs, tests = [], []
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    for k, voice in enumerate(voices):
        label = f"spk{k:03d}"
        d = os.path.join(root, label)
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
        for j in range(enroll_clips):
            wavfile.write(os.path.join(d, f"e{j}.wav"), FS,
                          speak(voice, seconds, rng))
        for j in range(test_clips):
            f = os.path.join(root, "test", f"{label}_t{j}.wav")
            wavfile.write(f, FS, speak(voice, seconds, rng))
            tests.append((f, label))
    return dirs, tests


def phase_cli(workdir: str, voices, seed: int, enroll_clips: int = 4,
              test_clips: int = 2, seconds: float = 5.0):
    """cli.main enroll + predict in-process; decisions must be right."""
    from speaker_recognition import cli
    from speaker_recognition.api.interface import ModelInterface

    dirs, tests = write_corpus(workdir, voices, seed, enroll_clips,
                               test_clips, seconds)
    model_path = os.path.join(workdir, "model.out")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["-t", "enroll", "-i", " ".join(dirs), "-m", model_path])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["-t", "predict", "-i",
                  os.path.join(workdir, "test", "*.wav"), "-m", model_path])
    got = dict(line.split(" -> ") for line in buf.getvalue().splitlines()
               if " -> " in line)
    acc = float(np.mean([got.get(f) == label for f, label in tests]))
    if acc < MIN_ACCURACY:
        raise AssertionError(f"cli predict accuracy {acc} < {MIN_ACCURACY}")
    return ModelInterface.load(model_path), {"speakers": len(voices),
                                             "tests": len(tests),
                                             "accuracy": acc}


def clips(voices, n: int, seconds: float, seed: int):
    """n clips cycling over the voices, with their speaker indices."""
    rng = np.random.RandomState(seed)
    who = [i % len(voices) for i in range(n)]
    return [speak(voices[i], seconds, rng) for i in who], np.asarray(who)


def phase_batch(name: str, model, sigs, truth=None,
                feature_rows: int = 8) -> dict:
    """ModelInterface.scores_batch against the reference; `feature_rows`
    rows, spread over the batch, of the features the serving geometry's
    extractor computes (the program scores_batch fuses with the scoring)
    against the float64 oracles."""
    import jax.numpy as jnp
    from speaker_recognition.api.interface import batch_bucket
    from speaker_recognition.config import FeatureConfig
    from speaker_recognition.features import extract

    scores, valid = model.scores_batch(FS, sigs)
    if not valid.all():
        raise AssertionError(f"{name}: utterances without valid frames")
    stats = check_scores(name, scores, *reference_scores(model.gmmset.bank,
                                                         sigs))
    if truth is not None:
        labels = np.asarray(model.gmmset.y)
        stats["accuracy"] = float(np.mean(
            labels[scores.argmax(-1)] == labels[truth]))
    batch, lengths = pad_batch(sigs, batch_bucket(len(sigs)))
    feats = extract._feature_fn(FS, FeatureConfig(), batch.shape[1],
                                "float32")(jnp.asarray(batch),
                                           jnp.asarray(lengths))[0]
    rows = np.linspace(0, len(sigs) - 1, feature_rows).astype(int)
    stats.update({f"features_{k}": v for k, v in check_features(
        [sigs[i] for i in rows], np.asarray(feats)[rows]).items()})
    stats["batch"] = len(sigs)
    return stats


def phase_large_bank(voices, seed: int, n_mixtures: int = 256,
                     ubm_iters: int = 5, enroll_seconds: float = 10.0,
                     batch: int = 128, seconds: float = 5.0):
    """UBM (few EM iterations) -> MAP-adapted bank -> scores_batch."""
    import jax
    import jax.numpy as jnp
    from oracles import oracle_gmm_em_iteration
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm
    from speaker_recognition.models.gmmset import GMMSet
    from speaker_recognition.tools import ubm as ubm_tools

    rng = np.random.RandomState(seed + 3)
    enroll = [speak(v, enroll_seconds, rng) for v in voices]
    b, lengths = pad_batch(enroll)
    feats, mask = extract.extract_batch(jnp.asarray(b), jnp.asarray(lengths),
                                        FS)
    feats, mask = np.asarray(feats), np.asarray(mask)
    per_spk = [feats[i][mask[i]] for i in range(len(voices))]

    ubm = ubm_tools.train_ubm(per_spk, n_mixtures=n_mixtures,
                              n_iterations=ubm_iters, threshold=0.0,
                              seed=seed)
    X = np.concatenate(per_spk)
    cfg = GmmConfig(n_mixtures=n_mixtures)
    step = jax.jit(lambda p, x, m: gmm.m_step(gmm.sufficient_stats(p, x, m),
                                              cfg))
    got = step(jax.tree.map(jnp.asarray, ubm), jnp.asarray(X, jnp.float32),
               jnp.ones(X.shape[0], bool))
    want = oracle_gmm_em_iteration(
        X.astype(np.float64), *(np.asarray(a, np.float64) for a in ubm),
        min_covar=cfg.min_covar, min_nk=cfg.min_nk)[:3]
    em_err = max(float(np.abs(np.asarray(g) - w).max() / np.abs(w).max())
                 for g, w in zip(got, want))
    if not em_err < UBM_RTOL:
        raise AssertionError(f"UBM EM step vs float64 oracle: {em_err:.3g}")

    labels, bank = ubm_tools.adapt_speakers(
        ubm, {f"spk{k:03d}": f for k, f in enumerate(per_spk)})
    model = ModelInterface()
    model.gmmset = GMMSet(ubm=ubm, config=GmmConfig(n_mixtures=n_mixtures))
    model.gmmset.y = labels
    model.gmmset.bank = bank
    sigs, who = clips(voices, batch, seconds, seed + 4)
    stats = phase_batch("large_bank", model, sigs, who)
    stats.update(ubm_em_step_rel_err=em_err,
                 bank=list(np.asarray(bank.means).shape))
    return model, sigs, stats


def phase_serial(model, voices, seed: int, seconds: float = 3.0) -> dict:
    """One serial predict and conversation ticks; labels must be right."""
    from speaker_recognition.api.conversation import ConversationSession

    rng = np.random.RandomState(seed + 5)
    sig = speak(voices[0], seconds, rng)
    want = "spk000"
    label = model.predict(FS, sig)
    if label != want:
        raise AssertionError(f"serial predict: {label!r} != {want!r}")
    model.init_noise(FS, 30.0 * rng.randn(2 * FS))
    session = ConversationSession(model, FS)
    session.feed(sig)
    tick = session.result_list[-1]
    if tick != want:
        raise AssertionError(f"conversation tick: {tick!r} != {want!r}")
    return {"predict": label, "ticks": len(session.result_list),
            "last_tick": tick}


@contextlib.contextmanager
def forced_scoring(scoring: str):
    """Serve 'xla' (SRTPU_PALLAS=off) or 'kernel' (auto) scoring."""
    old_env = os.environ.get("SRTPU_PALLAS")
    if scoring == "xla":
        os.environ["SRTPU_PALLAS"] = "off"
    else:
        os.environ.pop("SRTPU_PALLAS", None)
    try:
        yield
    finally:
        if old_env is None:
            os.environ.pop("SRTPU_PALLAS", None)
        else:
            os.environ["SRTPU_PALLAS"] = old_env


def phase_kernel(name: str, model, sigs, trials: int = 7,
                 interpret: bool = False) -> dict:
    """The scoring kernel compiled at this geometry against the XLA
    scoring on the same features, then each scoring timed, interleaved
    (median and IQR of `trials` turns): alone on device-resident
    features, inside the serving program, and inside scores_batch. The
    batch is padded to the rows scores_batch serves it with (min 8), and
    only the real rows are compared."""
    import jax
    import jax.numpy as jnp
    from speaker_recognition.api.interface import batch_bucket
    from speaker_recognition.config import FeatureConfig
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm
    from speaker_recognition.ops import pallas_gmm

    bank = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                        model.gmmset.bank)
    batch, lengths = pad_batch(sigs, batch_bucket(len(sigs)))
    feats, mask = extract._feature_fn(FS, FeatureConfig(), batch.shape[1],
                                      "float32")(jnp.asarray(batch),
                                                 jnp.asarray(lengths))
    n = len(sigs)
    S, K = bank.weights.shape
    B, T, d = feats.shape
    compiled = pallas_gmm.frame_speaker_lse.lower(
        bank, feats.reshape(B * T, d), K=K, interpret=interpret).compile()
    mem = compiled.memory_analysis()
    got = np.asarray(pallas_gmm.batch_bank_avg_loglik(
        bank, feats, mask, interpret=interpret))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(gmm.batch_bank_avg_loglik)(
            bank, feats, mask))
    stats = check_scores(f"{name} kernel", got[:n], want[:n],
                         floor_slack(bank, feats, mask)[:n],
                         rounding_slack(bank, feats, mask)[:n])
    out = {f"kernel_{k}": v for k, v in stats.items()}
    out["memory_analysis"] = str(mem)
    if interpret:
        return out
    from speaker_recognition.api import fastpath

    audio_s = sum(len(s) for s in sigs) / FS
    scoring_fns = {"xla": jax.jit(gmm.batch_bank_avg_loglik),
                   "kernel": jax.jit(pallas_gmm.batch_bank_avg_loglik)}
    program = {k: fastpath.scores_fn(FS, FeatureConfig(), batch.shape[1],
                                     "float32", k) for k in scoring_fns}
    dev_args = (jnp.asarray(batch), jnp.asarray(lengths), bank)

    def scores_batch(scoring):
        with forced_scoring(scoring):
            model.scores_batch(FS, sigs)

    levels = {
        # scoring alone on device-resident features
        "scoring": lambda k: jax.block_until_ready(
            scoring_fns[k](bank, feats, mask)),
        # the whole serving program on device-resident inputs
        "program": lambda k: jax.block_until_ready(program[k](*dev_args)),
        # ModelInterface.scores_batch: host padding, transfer, fetch
        "scores_batch": scores_batch,
    }
    for level, fn in levels.items():
        times = interleaved(fn, ("xla", "kernel"), trials)
        for scoring, (med, iqr) in times.items():
            out[f"{level}_{scoring}_ms"] = med * 1e3
            out[f"{level}_{scoring}_iqr_ms"] = iqr * 1e3
        if level != "scoring":
            for scoring in times:
                out[f"{level}_{scoring}_audio_s_per_s"] = (
                    audio_s / times[scoring][0])
    out["geometry"] = f"B={B} T={T} S={S} K={K}"
    return out


def interleaved(fn, names, trials: int) -> dict:
    """fn(name) timed in turns a, b, b, a after one warm-up call each;
    returns {name: (median seconds, IQR seconds)}."""
    for name in names:
        fn(name)
    times = {name: [] for name in names}
    for _ in range(trials):
        for name in tuple(names) + tuple(reversed(names)):
            t0 = time.perf_counter()
            fn(name)
            times[name].append(time.perf_counter() - t0)
    return {name: (float(np.median(ts)),
                   float(np.percentile(ts, 75) - np.percentile(ts, 25)))
            for name, ts in times.items()}


def phase_gpu_tests() -> dict:
    import pytest
    rc = pytest.main([os.path.join(ROOT, "tests_gpu"), "-q",
                      "-p", "no:cacheprovider"])
    if rc != 0:
        raise AssertionError(f"tests_gpu failed (pytest exit {rc})")
    return {"pytest_exit": int(rc)}


def phase_four(devices, seed: int, n_mixtures: int = 64,
               ubm_iters: int = 5, n_speakers: int = 8,
               seconds: float = 10.0, bank_speakers: int = 80) -> dict:
    """train_ubm sharded over a 4-device 'data' axis and bank scoring
    sharded over a 4-device 'bank' axis, each against one device."""
    import jax
    import jax.numpy as jnp
    from speaker_recognition.features import extract
    from speaker_recognition.models import gmm
    from speaker_recognition.parallel import mesh as pmesh
    from speaker_recognition.tools import ubm as ubm_tools

    n = len(devices)
    voices = make_voices(n_speakers, seed)
    rng = np.random.RandomState(seed + 6)
    b, lengths = pad_batch([speak(v, seconds, rng) for v in voices])
    feats, mask = extract.extract_batch(jnp.asarray(b), jnp.asarray(lengths),
                                        FS)
    feats, mask = np.asarray(feats), np.asarray(mask)
    per_spk = [feats[i][mask[i]] for i in range(n_speakers)]
    out = {"devices": n}
    with jax.default_matmul_precision("highest"):
        data_mesh = pmesh.make_mesh(data=n, bank=1, devices=devices)
        kw = dict(n_mixtures=n_mixtures, n_iterations=ubm_iters,
                  threshold=0.0, seed=seed)
        u_n = ubm_tools.train_ubm(per_spk, mesh=data_mesh, **kw)
        u_1 = ubm_tools.train_ubm(per_spk, **kw)
        err = max(float(np.abs(np.asarray(a) - np.asarray(c)).max()
                        / (np.abs(np.asarray(c)).max() + 1e-30))
                  for a, c in zip(u_n, u_1))
        if not err < SHARDED_RTOL:
            raise AssertionError(f"sharded train_ubm vs one device: {err}")
        out["train_ubm_rel_err"] = err

        S = -(-bank_speakers // n) * n
        rs = np.random.RandomState(seed + 7)
        w = rs.rand(S, n_mixtures) + 0.1
        bank = gmm.GmmParams(
            jnp.asarray(w / w.sum(1, keepdims=True), jnp.float32),
            jnp.asarray(rs.randn(S, n_mixtures, feats.shape[-1]),
                        jnp.float32),
            jnp.asarray(0.5 + rs.rand(S, n_mixtures, feats.shape[-1]),
                        jnp.float32))
        X = jnp.asarray(per_spk[0], jnp.float32)
        ones = jnp.ones(X.shape[0], bool)
        bank_mesh = pmesh.make_mesh(data=1, bank=n, devices=devices)
        got = np.asarray(pmesh.sharded_bank_scores(bank_mesh)(bank, X, ones))
        want = np.asarray(jax.jit(gmm.bank_avg_loglik)(bank, X, ones))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if not err < SHARDED_RTOL or got.argmax() != want.argmax():
            raise AssertionError(f"sharded bank scores vs one device: {err}")
        out["bank_scores_rel_err"] = err
    return out


def run(phases, name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    stats = result[-1] if isinstance(result, tuple) else result
    log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
        + json.dumps(stats, default=str))
    phases[name] = stats
    return result


def first_speakers(model, n: int):
    """A ModelInterface serving the first n speakers of `model`'s bank."""
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.models.gmm import GmmParams
    head = ModelInterface(model.config)
    head.gmmset.y = model.gmmset.y[:n]
    head.gmmset.bank = GmmParams(*(np.asarray(a)[:n]
                                   for a in model.gmmset.bank))
    return head


def first_mixtures(model, k: int):
    """A ModelInterface serving `model`'s speakers with only the first k
    components of each GMM (weights renormalised): a mid-size bank."""
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.models.gmm import GmmParams
    w, mu, sig = (np.asarray(a)[:, :k] for a in model.gmmset.bank)
    head = ModelInterface(model.config)
    head.gmmset.y = model.gmmset.y
    head.gmmset.bank = GmmParams(w / w.sum(-1, keepdims=True), mu, sig)
    return head


def one_card(phases: dict, seed: int, speakers: int = 24,
             seconds: float = 5.0, headline_batch: int = 512,
             large_speakers: int = 80, large_mixtures: int = 256,
             large_batch: int = 128, interpret: bool = False,
             gpu_tests: bool = True):
    """Every one-card phase; the defaults are the full-width run."""
    voices = make_voices(speakers, seed)
    run(phases, "features", phase_features, voices, seed, seconds=seconds)
    with tempfile.TemporaryDirectory() as work:
        model, _ = run(phases, "cli", phase_cli, work, voices, seed,
                       seconds=seconds)
    head = first_speakers(model, 4)
    sigs, who = clips(voices[:4], headline_batch, seconds, seed + 8)
    run(phases, "headline_batch", phase_batch, "headline", head, sigs, who)
    run(phases, "serial", phase_serial, model, voices, seed)
    big_voices = make_voices(large_speakers, seed + 100)
    big, big_sigs, _ = run(phases, "large_bank", phase_large_bank,
                           big_voices, seed, n_mixtures=large_mixtures,
                           batch=large_batch, seconds=seconds)
    run(phases, "kernel_headline", phase_kernel, "headline", head, sigs,
        interpret=interpret)
    run(phases, "kernel_large_bank", phase_kernel, "large_bank", big,
        big_sigs, interpret=interpret)
    # between the two: 24 x 32 and 80 x 32 banks at the large-bank batch
    mid_sigs, _ = clips(voices, large_batch, seconds, seed + 9)
    run(phases, "kernel_mid_24x32", phase_kernel, "mid_24x32", model,
        mid_sigs, interpret=interpret)
    run(phases, "kernel_mid_80x32", phase_kernel, "mid_80x32",
        first_mixtures(big, 32), big_sigs, interpret=interpret)
    # the serial predict / conversation tick geometry: one window of
    # ConversationSession.CONV_DURATION, served in the minimum batch bucket
    rng = np.random.RandomState(seed + 10)
    for tag, m, v in (("24x32", model, voices), ("80x256", big, big_voices)):
        run(phases, f"kernel_serial_{tag}", phase_kernel, f"serial_{tag}", m,
            [speak(v[0], 1.5, rng)], interpret=interpret)
    if gpu_tests:
        run(phases, "gpu_tests", phase_gpu_tests)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.four else 1)
    _import_repo()
    card = card_info()
    log(f"device_kind={devices[0].device_kind} count={len(devices)}")
    phases = {}
    if args.four:
        run(phases, "four_devices", phase_four, devices[:4], args.seed)
    else:
        one_card(phases, args.seed)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
