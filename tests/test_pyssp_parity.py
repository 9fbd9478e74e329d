"""Executable pyssp parity packet for the LTSD VAD (VERDICT r3 missing 3).

The reference delegates its LTSD computation to the external pyssp package
(/root/reference/src/filters/ltsd.py:14,36-38: `from pyssp.vad.ltsd import
LTSD`, `ltsd.compute_with_noise(signal, noise)`), then wraps it with the
MAGIC_NUMBER window, lambda0/lambda1 calibration, and interval-to-sample
arithmetic. pyssp is not installed on this machine and cannot be vendored
(no network), so vad/ltsd.py's claim to match pyssp's conventions —
per-bin AVERAGE noise amplitude profile, score formula, two-threshold
segmentation — is otherwise only argued (vad/ltsd.py:92-112,154-174).

This module makes the claim executable: on any machine where pyssp IS
importable it verifies, on shared synthetic clips:

  P1  noise profile: our `noise_profile` == pyssp `compute_noise_avg_spectrum`
      restricted to the one-sided bins (pyssp keeps the full FFT; bins k and
      n-k are conjugate so the one-sided half carries the same information).
  P2  score parity: our `ltsd_scores` == pyssp's per-frame LTSD sequence
      (`compute_with_noise`'s second return value), including the zeroed
      edge frames.
  P3  calibration parity: lambda0/lambda1 derived via the reference wrapper
      recipe (1.1 * max noise-clip score, x2) match LtsdVad's.
  P4  interval parity: the reference wrapper's sample intervals
      ([start*ws/2, (finish+1)*ws/2), ltsd.py:52-64) computed from pyssp's
      segmentation == LtsdVad.filter's intervals, and the concatenated
      voiced samples are identical.

Here (no pyssp) every test skips with a pointed message rather than
passing vacuously, so the suite stays honest about what was executed.
"""

import numpy as np
import pytest

pyssp_ltsd = pytest.importorskip(
    "pyssp.vad.ltsd",
    reason="pyssp not installed: LTSD<->pyssp parity is an ARGUED equivalence "
           "on this machine (vad/ltsd.py:92-112,154-174). Install pyssp "
           "(pip install pyssp) to execute score/interval-level parity "
           "against the exact library the reference calls "
           "(reference src/filters/ltsd.py:36-38).")

from speaker_recognition.vad.ltsd import (  # noqa: E402
    LtsdVad, ltsd_scores, noise_profile, segment_intervals)

FS = 8000
WINDOW_SIZE = int(0.04644 * FS)  # reference MAGIC_NUMBER, ltsd.py:17,68


def _clips():
    """(noise clip, speech-like clip) shared by both implementations."""
    rng = np.random.RandomState(20260821)
    noise = (rng.randn(FS * 2) * 80.0).astype(np.float64)
    # speech-like: noise floor + three voiced bursts (tone stacks with
    # formant-ish partials) separated by silence gaps
    sig = rng.randn(FS * 6) * 80.0
    t = np.arange(FS * 6) / FS
    for (a, b, f0) in ((0.5, 1.4, 180.0), (2.2, 3.5, 140.0), (4.4, 5.2, 220.0)):
        seg = slice(int(a * FS), int(b * FS))
        burst = sum(3000.0 / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * t[seg])
                    for h in range(5))
        sig[seg] += burst
    return noise, sig.astype(np.float64)


def _pyssp_reference_wrapper(noise, signal):
    """Transcription of the reference wrapper's pyssp usage
    (src/filters/ltsd.py:32-64): calibrate on the noise clip, then filter."""
    window = np.hanning(WINDOW_SIZE)
    ltsd = pyssp_ltsd.LTSD(WINDOW_SIZE, window, 5)
    _, noise_ltsds = ltsd.compute_with_noise(noise, noise)
    lambda0 = float(np.max(noise_ltsds)) * 1.1
    lambda1 = lambda0 * 2.0
    ltsd2 = pyssp_ltsd.LTSD(WINDOW_SIZE, window, 5,
                            lambda0=lambda0, lambda1=lambda1)
    res, ltsds = ltsd2.compute_with_noise(signal, noise)
    sample_ivs = [(start * WINDOW_SIZE // 2, (finish + 1) * WINDOW_SIZE // 2)
                  for start, finish in res]
    voiced = (np.concatenate([signal[s:f] for s, f in sample_ivs])
              if sample_ivs else np.array([]))
    return {"lambda0": lambda0, "lambda1": lambda1,
            "ltsds": np.asarray(ltsds, np.float64),
            "frame_intervals": [tuple(map(int, iv)) for iv in res],
            "sample_intervals": sample_ivs, "voiced": voiced}


@pytest.fixture(scope="module")
def shared():
    noise, sig = _clips()
    ref = _pyssp_reference_wrapper(noise, sig)
    vad = LtsdVad()
    vad.init_params_by_noise(FS, noise)
    return noise, sig, ref, vad


def test_noise_profile_matches_pyssp(shared):
    """P1: per-bin average amplitude == pyssp compute_noise_avg_spectrum."""
    noise, _, _, _ = shared
    window = np.hanning(WINDOW_SIZE)
    ltsd = pyssp_ltsd.LTSD(WINDOW_SIZE, window, 5)
    theirs_full = np.asarray(ltsd.compute_noise_avg_spectrum(noise))
    ours = noise_profile(noise, WINDOW_SIZE)
    nb = ours.shape[0]  # one-sided bin count = ws//2 + 1
    np.testing.assert_allclose(ours, theirs_full[:nb], rtol=2e-4,
                               err_msg="noise profile convention diverges "
                                       "from pyssp's average amplitude")


def test_score_parity(shared):
    """P2: per-frame LTSD sequence matches pyssp's on the speech clip."""
    _, sig, ref, vad = shared
    ours = ltsd_scores(sig, vad.noise_amp, WINDOW_SIZE, order=5)
    theirs = ref["ltsds"]
    assert len(ours) == len(theirs), (
        f"frame count differs: ours {len(ours)} vs pyssp {len(theirs)} "
        f"(windownum = len//(ws/2) - 1 convention)")
    np.testing.assert_allclose(ours, theirs, atol=5e-3,
                               err_msg="LTSD score formula diverges")


def test_calibration_parity(shared):
    """P3: lambda0/lambda1 from the noise clip match the wrapper recipe."""
    _, _, ref, vad = shared
    assert vad.lambda0 == pytest.approx(ref["lambda0"], rel=1e-3)
    assert vad.lambda1 == pytest.approx(ref["lambda1"], rel=1e-3)


def test_interval_and_sample_parity(shared):
    """P4: segmentation intervals and concatenated voiced samples match."""
    _, sig, ref, vad = shared
    voiced, sample_ivs = vad.filter(sig)
    assert sample_ivs == ref["sample_intervals"], (
        "two-threshold segmentation state machine "
        "(vad/ltsd.py:154-174) diverges from pyssp's interval logic: "
        f"ours {sample_ivs} vs pyssp {ref['sample_intervals']}")
    np.testing.assert_array_equal(voiced, ref["voiced"])


def test_our_segmentation_of_pyssp_scores(shared):
    """Cross-check isolating the state machine: running OUR segment_intervals
    on PYSSP's score sequence must reproduce pyssp's frame intervals —
    separates score-formula drift from segmentation-logic drift."""
    _, _, ref, _ = shared
    ours = segment_intervals(ref["ltsds"], ref["lambda0"], ref["lambda1"])
    assert [tuple(iv) for iv in ours] == ref["frame_intervals"]
