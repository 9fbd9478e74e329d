"""Plain-NumPy float64 oracles transcribing the reference semantics.

These are deliberately written in the most literal loop-level style (one
frame at a time, double loops for the filterbank) so that the vectorized
JAX implementations are checked against an independent rendering of the same
math. Reference sources: src/feature/MFCC.py, src/feature/LPC.py,
src/gmm/src/gmm.cc.
"""

from __future__ import annotations

import math

import numpy as np


def oracle_hamming(n):
    return 0.54 - 0.46 * np.cos(2 * np.pi / n * (np.arange(n) + 0.5))


def oracle_mel_filterbank(fs, fft_size, n_bands):
    """Literal double-loop transcription of src/feature/MFCC.py:81-105."""
    f0 = 700.0 / fs
    fn2 = int(np.floor(fft_size / 2))
    lr = np.log(1 + 0.5 / f0) / (n_bands + 1)
    bl = fft_size * f0 * (np.exp(np.array([0, 1, n_bands, n_bands + 1]) * lr) - 1)
    b1 = int(np.floor(bl[0])) + 1
    b2 = int(np.ceil(bl[1]))
    b3 = int(np.floor(bl[2]))
    b4 = min(fn2, int(np.ceil(bl[3]))) - 1
    pf = np.log(1 + np.arange(b1, b4 + 1) / f0 / fft_size) / lr
    fp = np.floor(pf)
    pm = pf - fp
    M = np.zeros((n_bands, 1 + fn2))
    for c in range(b2 - 1, b4):
        r = int(fp[c] - 1)
        M[r, c + 1] += 2 * (1 - pm[c])
    for c in range(b3):
        r = int(fp[c])
        M[r, c + 1] += 2 * pm[c]
    return M


def oracle_dctmtx(n):
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    D = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * x + 1) * y / (2 * n))
    D[0] /= np.sqrt(2)
    return D


def oracle_mfcc(fs, signal, win_length_ms=32, win_shift_ms=16, fft_size=2048,
                n_filters=50, n_ceps=13, pre_emph=0.95, floor=1e-100):
    """Frame-loop MFCC, mirroring src/feature/MFCC.py:49-79."""
    signal = np.asarray(signal, dtype=np.float64)
    flen = int(float(win_length_ms) / 1000 * fs)
    fshift = int(float(win_shift_ms) / 1000 * fs)
    window = oracle_hamming(flen)
    M = oracle_mel_filterbank(fs, fft_size, n_filters)
    D = oracle_dctmtx(n_filters)[1 : n_ceps + 1]
    T = (len(signal) - flen) // fshift + 1
    feats = []
    for f in range(T):
        frame = signal[f * fshift : f * fshift + flen] * window
        frame[1:] -= frame[:-1] * pre_emph
        X = np.abs(np.fft.fft(frame, fft_size)[: fft_size // 2 + 1]) ** 2
        X[X < floor] = floor
        feats.append(D @ np.log(M @ X))
    feats = np.vstack(feats)
    if feats.shape[0] > 1:
        mu = feats.mean(axis=0)
        sigma = feats.std(axis=0)
        feats = (feats - mu) / sigma
    return feats


def oracle_mel_filterbank_bounded(fs, fft_size, n_bands, f_min, f_max,
                                  mel_scale=True):
    """Bin-loop triangular bank between f_min/f_max (bob.ap.Ceps-style)."""
    def warp(f):
        return 2595.0 * math.log10(1.0 + f / 700.0) if mel_scale else f

    edges = [warp(f_min) + (warp(f_max) - warp(f_min)) * i / (n_bands + 1)
             for i in range(n_bands + 2)]
    M = np.zeros((n_bands, fft_size // 2 + 1))
    for k in range(fft_size // 2 + 1):
        m = warp(k * fs / fft_size)
        for b in range(n_bands):
            lo, c, hi = edges[b], edges[b + 1], edges[b + 2]
            if lo <= m <= c:
                M[b, k] = (m - lo) / (c - lo)
            elif c < m <= hi:
                M[b, k] = (hi - m) / (hi - c)
    return M


def oracle_mfcc_bob(fs, signal, win_length_ms=32, win_shift_ms=16,
                    fft_size=2048, n_filters=55, n_ceps=19, pre_emph=0.95,
                    f_min=0.0, f_max=4000.0, floor=1e-100, cmvn=True):
    """Frame-loop MFCC with the bob.ap.Ceps conventions the reference
    prefers (src/feature/BOB.py:13-18): pre-emphasis before the window
    (first sample scaled 1-a), bounded triangular mel bank, DCT coefs
    1..n_ceps."""
    signal = np.asarray(signal, dtype=np.float64)
    flen = int(float(win_length_ms) / 1000 * fs)
    fshift = int(float(win_shift_ms) / 1000 * fs)
    window = oracle_hamming(flen)
    M = oracle_mel_filterbank_bounded(fs, fft_size, n_filters, f_min, f_max)
    D = oracle_dctmtx(n_filters)[1 : n_ceps + 1]
    T = (len(signal) - flen) // fshift + 1
    feats = []
    for f in range(T):
        frame = signal[f * fshift : f * fshift + flen].copy()
        pf = frame.copy()
        pf[1:] -= frame[:-1] * pre_emph
        pf[0] *= 1.0 - pre_emph
        pf *= window
        X = np.abs(np.fft.fft(pf, fft_size)[: fft_size // 2 + 1]) ** 2
        X[X < floor] = floor
        feats.append(D @ np.log(M @ X))
    feats = np.vstack(feats)
    if cmvn and feats.shape[0] > 1:
        feats = (feats - feats.mean(axis=0)) / feats.std(axis=0)
    return feats


def oracle_levinson(r, order):
    """Scalar Levinson-Durbin as in talkbox levinson_1d."""
    a = np.zeros(order + 1)
    a[0] = 1.0
    e = r[0]
    for i in range(1, order + 1):
        acc = r[i]
        for j in range(1, i):
            acc += a[j] * r[i - j]
        k = -acc / e
        t = a.copy()
        for j in range(1, i):
            a[j] += k * t[i - j]
        a[i] = k
        e *= 1 - k * k
    return a, e


def oracle_lpc(fs, signal, win_length_ms=32, win_shift_ms=16, n_lpc=15,
               pre_emph=0.95):
    """Frame-loop LPC, mirroring src/feature/LPC.py:46-57."""
    signal = np.asarray(signal, dtype=np.float64)
    flen = int(float(win_length_ms) / 1000 * fs)
    fshift = int(float(win_shift_ms) / 1000 * fs)
    window = oracle_hamming(flen)
    T = (len(signal) - flen) // fshift + 1
    feats = []
    for f in range(T):
        frame = signal[f * fshift : f * fshift + flen] * window
        frame[1:] -= frame[:-1] * pre_emph
        n = len(frame)
        r = np.array([np.dot(frame[: n - j], frame[j:]) for j in range(n_lpc + 1)]) / n
        a, _ = oracle_levinson(r, n_lpc)
        feats.append(a[1:])
    feats = np.array(feats)
    feats[np.isnan(feats)] = 0
    return feats


def oracle_gmm_em_iteration(X, weights, means, sigmas, min_covar=1e-3,
                            min_prob_sum=1e-15, min_nk=1e-6):
    """One EM iteration in the reference's linear probability space,
    transcribed from src/gmm/src/gmm.cc:439-531 (E-step joint probabilities,
    per-frame normalization with 1e-15 floor, N_k with 1e-6 floor, then
    weight/mean/sigma updates with the sqrt(min_covar) sigma floor).

    X: [n, d]; weights: [K]; means/sigmas: [K, d]. Returns updated params.
    """
    n, d = X.shape
    K = len(weights)
    SQRT_2_PI = 2.5066282746310002
    prob = np.zeros((K, n))
    for k in range(K):
        logp = np.zeros(n)
        for i in range(d):
            s = sigmas[k, i]
            dd = X[:, i] - means[k, i]
            logp += -np.log(SQRT_2_PI * s) - 1.0 / (2 * s * s) * dd * dd
        prob[k] = weights[k] * np.exp(logp)
    psum = prob.sum(axis=0)
    psum[~(psum > 0)] = min_prob_sum
    gamma = prob / psum
    N_k = gamma.sum(axis=1)
    N_k[N_k == 0] = min_nk

    new_w = N_k / n
    new_w = new_w / new_w.sum()
    new_means = (gamma @ X) / N_k[:, None]
    new_sigmas = np.zeros_like(sigmas)
    min_sigma = np.sqrt(min_covar)
    for k in range(K):
        diff2 = (X - new_means[k]) ** 2
        var = (gamma[k][:, None] * diff2).sum(axis=0) / N_k[k]
        new_sigmas[k] = np.maximum(np.sqrt(var), min_sigma)
    return new_w, new_means, new_sigmas, gamma, N_k


def oracle_gmm_log_likelihood(X, weights, means, sigmas):
    """Per-frame log p(x) = safe_log(sum_k w_k N(x; mu_k, sigma_k)),
    src/gmm/src/gmm.cc:229-244 with the 1e-15 safe_log floor."""
    n, d = X.shape
    SQRT_2_PI = 2.5066282746310002
    total = np.zeros(n)
    for k in range(len(weights)):
        logp = np.zeros(n)
        for i in range(d):
            s = sigmas[k, i]
            dd = X[:, i] - means[k, i]
            logp += -np.log(SQRT_2_PI * s) - 1.0 / (2 * s * s) * dd * dd
        total += weights[k] * np.exp(logp)
    total[total <= 0] = 1e-15
    return np.log(total)
