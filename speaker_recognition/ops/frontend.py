"""Host-side construction of the constant linear operators of the frontend.

The reference extracts MFCC frame-by-frame in a Python loop
(src/feature/MFCC.py:57-70): window, pre-emphasis, |FFT|^2, mel matmul, log,
DCT. Here the whole pipeline is three matmuls over a *batch* of frames:

    power[t, b] = (frames @ DFT_re)^2 + (frames @ DFT_im)^2
    mel[t, m]   = log(power @ MEL^T)
    ceps[t, c]  = mel @ DCT_slice^T

All matrices here are built once per (fs, config) in float64 NumPy and cast
to the compute dtype; they are compile-time constants under jit.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "hamming",
    "mel_filterbank",
    "mel_filterbank_bounded",
    "dct_matrix",
    "dft_power_projection",
    "windowed_preemph_operator",
    "halfspec_to_fullspec",
    "packed_frontend_operators",
]


def hamming(n: int) -> np.ndarray:
    """Hamming window with the reference's half-sample phase offset.

    Mirrors src/feature/MFCC.py:14-16:
        0.54 - 0.46*cos(2*pi/n * (arange(n)+0.5))
    (note the +0.5 — this differs from numpy.hamming and matters for parity).
    """
    return 0.54 - 0.46 * np.cos(2 * np.pi / n * (np.arange(n) + 0.5))


def mel_filterbank(fs: int, fft_size: int, n_bands: int) -> np.ndarray:
    """Exponentially-spaced mel filterbank, transcribed from the melfb.m
    formulation used by the reference (src/feature/MFCC.py:81-105).

    Returns M of shape [n_bands, fft_size//2 + 1]; mel energies are
    M @ power_spectrum. Weights are the "2*(1-pm)" / "2*pm" triangular pair
    accumulated per FFT bin.
    """
    f0 = 700.0 / fs
    fn2 = fft_size // 2
    lr = math.log(1 + 0.5 / f0) / (n_bands + 1)
    bl = fft_size * f0 * (np.exp(np.array([0.0, 1.0, n_bands, n_bands + 1]) * lr) - 1)
    b1 = int(math.floor(bl[0])) + 1
    b2 = int(math.ceil(bl[1]))
    b3 = int(math.floor(bl[2]))
    b4 = min(fn2, int(math.ceil(bl[3]))) - 1
    # The reference indexes pf[] by loop counter c while writing to FFT-bin
    # column c+1, which is only coherent because bl[0] == 0 -> b1 == 1 always
    # (exp(0)-1 == 0). Assert the invariant rather than silently inherit it.
    assert b1 == 1, f"mel filterbank derivation assumes b1 == 1, got {b1}"
    pf = np.log(1 + np.arange(b1, b4 + 1, dtype=np.float64) / f0 / fft_size) / lr
    fp = np.floor(pf).astype(np.int64)
    pm = pf - fp

    M = np.zeros((n_bands, 1 + fn2), dtype=np.float64)
    # Falling edge of filter fp[c]-1 over bins [b2, b4]
    c1 = np.arange(b2 - 1, b4)
    np.add.at(M, (fp[c1] - 1, c1 + 1), 2 * (1 - pm[c1]))
    # Rising edge of filter fp[c] over bins [1, b3]
    c2 = np.arange(0, b3)
    np.add.at(M, (fp[c2], c2 + 1), 2 * pm[c2])
    return M


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_filterbank_bounded(fs: int, fft_size: int, n_bands: int,
                           f_min: float, f_max: float,
                           mel_scale: bool = True) -> np.ndarray:
    """Frequency-bounded triangular filterbank — the bob.ap.Ceps-style bank.

    The reference's preferred extractor is the bob wrapper
    (src/feature/__init__.py:11-13 tries BOB first) whose defaults are
    55 filters, 19 cepstra, f in [0, 6000] Hz (src/feature/BOB.py:13-18).
    Unlike the melfb.m fallback bank (`mel_filterbank`, which always spans
    [0, fs/2] with exponential spacing), this bank places n_bands triangular
    filters with peaks equally spaced on the mel scale (2595*log10(1+f/700))
    between f_min and f_max; `mel_scale=False` spaces them linearly (bob's
    mel_scale flag). Triangle weights are evaluated in the warped domain.

    Returns M of shape [n_bands, fft_size//2 + 1]; mel energies are
    M @ power_spectrum.
    """
    # NOTE: the reference passes bob's default f_max=6000 against fs=8000
    # corpora (src/feature/BOB.py:14); clamp to Nyquist so no filter is
    # left without FFT-bin support (a zero mel energy would hit the log
    # floor and poison CMVN).
    f_max = min(float(f_max), fs / 2.0)
    assert 0.0 <= f_min < f_max, (f_min, f_max, fs)
    warp = _hz_to_mel if mel_scale else (
        lambda f: np.asarray(f, dtype=np.float64))
    edges = np.linspace(warp(f_min), warp(f_max), n_bands + 2)
    freqs = np.arange(fft_size // 2 + 1, dtype=np.float64) * fs / fft_size
    m = warp(freqs)[None, :]                      # [1, bins]
    left = edges[:-2, None]                        # [n_bands, 1]
    center = edges[1:-1, None]
    right = edges[2:, None]
    rising = (m - left) / np.maximum(center - left, 1e-30)
    falling = (right - m) / np.maximum(right - center, 1e-30)
    return np.clip(np.minimum(rising, falling), 0.0, None)


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix of order n, src/feature/MFCC.py:107-113."""
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    D = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * x + 1) * y / (2 * n))
    D[0] /= np.sqrt(2)
    return D


def dft_power_projection(frame_len: int, fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag projection matrices of a zero-padded DFT.

    For a real frame x[0:frame_len] zero-padded to fft_size, the one-sided
    spectrum (bins 0..fft_size//2) is
        re[k] = sum_n x[n] cos(2 pi n k / N),  im[k] = -sum_n x[n] sin(...)
    so |FFT|^2 = (x @ C)^2 + (x @ S)^2 with C, S of shape
    [frame_len, fft_size//2+1]. For 256-sample frames this matmul-DFT is
    one dense matmul and replaces the per-frame fft.fft of
    src/feature/MFCC.py:66.
    """
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(fft_size // 2 + 1, dtype=np.float64)[None, :]
    ang = 2 * np.pi * n * k / fft_size
    return np.cos(ang), -np.sin(ang)


def halfspec_to_fullspec(frame_len: int, fft_small: int, fft_big: int) -> np.ndarray:
    """Exact linear map from a small one-sided power spectrum to a big one.

    The reference zero-pads frame_len-sample frames to a 2048-point FFT
    (src/feature/MFCC.py:66,116) — an 8x-oversampled spectrum. Because the
    frame's autocorrelation has support 2*frame_len-1 <= fft_small, the
    fft_small-point power spectrum already determines the autocorrelation
    exactly (Wiener-Khinchin, no circular aliasing), and hence every bin of
    the fft_big-point power spectrum:

        r[l]      = (1/Ns) (p[0] + (-1)^l p[Ns/2] + 2 sum_k p[k] cos(2pi kl/Ns))
        P_big[k]  = r[0] + 2 sum_{l>=1} r[l] cos(2pi kl/Nb)

    Returns H of shape [fft_small//2+1, fft_big//2+1] with P_big = p_small @ H
    (float64, exact to rounding). Requires fft_small >= 2*frame_len.
    """
    assert fft_small >= 2 * frame_len and fft_small % 2 == 0
    nbs = fft_small // 2 + 1
    k = np.arange(nbs, dtype=np.float64)[:, None]
    l = np.arange(frame_len, dtype=np.float64)[None, :]
    P2R = 2.0 * np.cos(2.0 * np.pi * k * l / fft_small) / fft_small
    P2R[0] /= 2.0
    P2R[-1] /= 2.0
    kb = np.arange(fft_big // 2 + 1, dtype=np.float64)[None, :]
    lc = np.arange(frame_len, dtype=np.float64)[:, None]
    R2P = 2.0 * np.cos(2.0 * np.pi * lc * kb / fft_big)
    R2P[0] /= 2.0
    return P2R @ R2P


def packed_frontend_operators(frame_len: int, fft_size: int, pre_emph: float,
                              mel_t: np.ndarray,
                              lpc_order: int | None = None,
                              preemph_first: bool = False):
    """Operators for the packed (half-spectrum) frontend.

    The full pipeline per frame is
        window+preemph (B) -> |DFT_2048|^2 -> mel / autocorr projections
    where everything after the squaring is LINEAR in the power spectrum. So:
      * compute only the 2*frame_len-point spectrum (exactness per
        halfspec_to_fullspec) — 4x fewer DFT FLOPs at fft_size=2048;
      * fold B into the DFT operators (no separate windowing pass);
      * pack [re bins 0..F-1 | im bins 1..F-1 | re Nyquist] into ONE
        [frame_len, 2*frame_len] operator D — 2*frame_len = 512 is a
        power of two, and since every power bin is a sum of squared
        columns of X = frames @ D, any post-power projection P becomes
        Y @ (E P) with Y = X*X and E the column->bin expansion.

    Returns (D [frame_len, 2*frame_len], W_mel [2*frame_len, n_mel],
    A_acorr [2*frame_len, order+1] or None). All float64.
    Combined with the mel/DCT matmuls this is ~7x fewer FLOPs than the
    direct 2048-bin path with bit-comparable (f64-exact) results.
    """
    F = frame_len
    fft2 = 2 * F
    C, S = dft_power_projection(F, fft2)          # [F, F+1] each
    B = windowed_preemph_operator(F, pre_emph, preemph_first)  # y = x @ B.T
    Cw = B.T @ C
    Sw = B.T @ S
    # packed columns: [re 0..F-1 | im 1..F-1 | re F(Nyquist)] = 2F columns
    D = np.concatenate([Cw[:, :F], Sw[:, 1:F], Cw[:, F:F + 1]], axis=1)
    # expansion E: power[bin] = sum of squared packed columns
    E = np.zeros((2 * F, F + 1), np.float64)
    E[np.arange(F), np.arange(F)] = 1.0                    # re^2, bins 0..F-1
    E[F + np.arange(F - 1), 1 + np.arange(F - 1)] = 1.0    # im^2, bins 1..F-1
    E[2 * F - 1, F] = 1.0                                  # Nyquist
    H = halfspec_to_fullspec(F, fft2, fft_size)            # [F+1, big bins]
    W_mel = E @ H @ mel_t                                  # [2F, n_mel]
    A = None
    if lpc_order is not None:
        # biased autocorrelation r[l]/F directly from the small spectrum
        # (identical to power2048 @ levinson.autocorr_operator, fewer hops)
        k = np.arange(F + 1, dtype=np.float64)[:, None]
        j = np.arange(lpc_order + 1, dtype=np.float64)[None, :]
        P2R = 2.0 * np.cos(2.0 * np.pi * k * j / fft2) / fft2
        P2R[0] /= 2.0
        P2R[-1] /= 2.0
        A = E @ (P2R / F)
    return D, W_mel, A


def windowed_preemph_operator(frame_len: int, pre_emph: float,
                              preemph_first: bool = False) -> np.ndarray:
    """Combined window+pre-emphasis as one [frame_len, frame_len] operator.

    Default (`preemph_first=False`): the reference applies pre-emphasis AFTER
    windowing (src/feature/MFCC.py:61-64: frame *= window;
    frame[1:] -= 0.95*frame[:-1]) — nonstandard order, load-bearing for
    parity. As a linear map:
        y = A @ (w * x),  A = I - pre_emph * subdiag
    Returned operator B satisfies y = x @ B^T i.e. B = A @ diag(w).

    `preemph_first=True` is the bob.ap order (pre-emphasize the raw frame,
    then window; first sample scaled by 1-a like bob's FrameExtractor):
        y = w * (A' @ x),  A'[0,0] = 1 - pre_emph  ->  B = diag(w) @ A'.
    """
    w = hamming(frame_len)
    A = np.eye(frame_len)
    A[np.arange(1, frame_len), np.arange(frame_len - 1)] = -pre_emph
    if preemph_first:
        A[0, 0] = 1.0 - pre_emph
        return w[:, None] * A
    return A * w[None, :]
