"""Batched Levinson-Durbin recursion for LPC.

The reference computes LPC per frame through scikits.talkbox's
levinson_lpc.lpc (src/feature/LPC.py:40-44): biased autocorrelation followed
by an order-p Levinson recursion returning a = [1, a_1..a_p]. The recursion
is inherently sequential in the *order* dimension (p=15), but embarrassingly
parallel across frames — so we run a `lax.fori_loop` of p steps where every
step is a vectorized op over the whole [..., T] frame batch (elementwise; the
sequential depth is only 15).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["autocorrelation", "levinson", "lpc_from_frames"]


def autocorrelation(frames: jnp.ndarray, order: int) -> jnp.ndarray:
    """Biased autocorrelation r[0..order] of each frame.

    r_j = sum_t x[t] x[t+j] / n — the same quantity talkbox's acorr_lpc
    produces (the 1/n scale cancels in the Levinson recursion but is kept for
    oracle comparisons). frames: [..., n] -> [..., order+1].
    """
    n = frames.shape[-1]
    cols = []
    for j in range(order + 1):
        cols.append(jnp.sum(frames[..., : n - j] * frames[..., j:], axis=-1))
    return jnp.stack(cols, axis=-1) / n


def autocorr_operator(frame_len: int, fft_size: int, order: int):
    """Wiener-Khinchin projection: power spectrum -> autocorrelation.

    For a frame zero-padded to fft_size >= 2*frame_len, the linear (biased)
    autocorrelation is exactly the inverse DFT of the one-sided power
    spectrum: r_j = (1/(fft_size*n)) [p_0 + p_{N/2} cos(pi j)
    + 2 sum_k p_k cos(2 pi j k / N)]. Returns R of shape
    [fft_size//2+1, order+1] so r = power @ R — one tiny matmul that reuses
    the power spectrum the MFCC path already computes, replacing order+1
    separate passes over the raw frames.
    """
    import numpy as np
    nb = fft_size // 2 + 1
    k = np.arange(nb, dtype=np.float64)[:, None]
    j = np.arange(order + 1, dtype=np.float64)[None, :]
    R = 2.0 * np.cos(2.0 * np.pi * k * j / fft_size)
    R[0] /= 2.0
    if fft_size % 2 == 0:
        R[-1] /= 2.0
    return R / (fft_size * frame_len)


def levinson(r: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Levinson-Durbin: solve the Toeplitz normal equations.

    r: [..., p+1] autocorrelation. Returns (a, e) with a: [..., p+1],
    a[..., 0] = 1, and e the final prediction error. An all-zero frame
    (r[0] == 0) yields NaN coefficients, exactly like talkbox — the caller
    zeroes them (src/feature/LPC.py:56).
    """
    p = r.shape[-1] - 1
    idx = jnp.arange(p + 1)

    a0 = jnp.zeros_like(r).at[..., 0].set(1.0)
    e0 = r[..., 0]

    def body(i, carry):
        a, e = carry
        # acc = r[i] + sum_{j=1..i-1} a[j] * r[i-j]
        gather = jnp.clip(i - idx, 0, p)
        r_rev = jnp.take(r, gather, axis=-1)          # r[i-j] at position j
        inner = (idx >= 1) & (idx < i)
        acc = jnp.take(r, i, axis=-1) + jnp.sum(jnp.where(inner, a * r_rev, 0.0), axis=-1)
        k = -acc / e
        a_rev = jnp.take(a, gather, axis=-1)          # a[i-j] at position j
        a = a + jnp.where(inner, k[..., None] * a_rev, 0.0)
        a = jnp.where(idx == i, k[..., None], a)
        e = e * (1.0 - k * k)
        return a, e

    return jax.lax.fori_loop(1, p + 1, body, (a0, e0))


def lpc_from_frames(frames: jnp.ndarray, order: int) -> jnp.ndarray:
    """LPC feature of each (already windowed+pre-emphasized) frame.

    Returns a[1:] with NaNs zeroed, matching src/feature/LPC.py:40-57
    (lpc(signal, n_lpc)[0][1:], then feature[isnan] = 0).
    """
    r = autocorrelation(frames, order)
    return lpc_from_autocorr(r)


def lpc_from_autocorr(r: jnp.ndarray) -> jnp.ndarray:
    """LPC from precomputed autocorrelation [..., order+1] (the spectral
    path: r = power @ autocorr_operator).

    Uses the statically-unrolled recursion: a fori_loop carries its state
    through device memory every one of the p iterations (~15 round-trips
    of the [B, T, p+1] coefficient tensor), while the unrolled form is one
    fused elementwise XLA kernel bounded by reading r and writing a once."""
    return levinson_unrolled(r, r.shape[-1] - 1)


def levinson_unrolled(r: jnp.ndarray, order: int) -> jnp.ndarray:
    """Levinson-Durbin with the order-p recursion statically unrolled.

    r: [..., order+1] -> LPC a[1..p]: [..., order]. Same math as
    `levinson` (talkbox semantics, src/feature/LPC.py:40-44) but with
    compile-time indices only: XLA fuses the whole ~p^2/2-op chain into one
    elementwise kernel (no dynamic gathers). Non-finite coefficients (all-zero frames: e
    underflows to 0 -> 0/0) are zeroed like LPC.py:56.
    """
    rc = [r[..., j:j + 1] for j in range(order + 1)]
    e = rc[0]
    a: list = []                              # a[1..i] as [..., 1] columns
    for i in range(1, order + 1):
        acc = rc[i]
        for j in range(1, i):
            acc = acc + a[j - 1] * rc[i - j]
        k = -acc / e
        a = [a[j - 1] + k * a[i - j - 1] for j in range(1, i)] + [k]
        e = e * (1.0 - k * k)
    lpc = jnp.concatenate(a, axis=-1)
    return jnp.where(jnp.isfinite(lpc), lpc, 0.0)


def lpcc_from_lpc(a: jnp.ndarray, n_lpcc: int) -> jnp.ndarray:
    """LPC cepstra via the reference's recursion, batched over frames.

    Transcribes lpc_to_cc (src/feature/LPC.py:27-38; dormant there but part
    of the documented feature surface): with a = [1, a_1..a_p] the full
    Levinson output and c the cepstral sequence,

        c[0] = a[0]
        c[n] = (a[n] if n < p else 0)
             + sum_{l=0}^{min(n,p)-1} a[l] c[n-l-1] (n-l)/(n+1)

    returning -c[1:] (n_lpcc-1 values). Sequential in the cepstral index
    (fori_loop), vectorized over the [..., :] frame batch.
    """
    p = a.shape[-1] - 1  # reference's self.n_lpc
    c0 = jnp.zeros(a.shape[:-1] + (n_lpcc,), a.dtype)
    c0 = c0.at[..., 0].set(a[..., 0])
    idx = jnp.arange(n_lpcc)

    def body(n, c):
        # term = sum over l in [0, min(n, p)) of a[l]*c[n-l-1]*(n-l)/(n+1)
        l = idx
        inner = l < jnp.minimum(n, p)
        a_l = jnp.where(inner, jnp.take(a, jnp.clip(l, 0, p), axis=-1), 0.0)
        c_rev = jnp.take(c, jnp.clip(n - l - 1, 0, n_lpcc - 1), axis=-1)
        w = (n - l) / (n + 1)
        term = jnp.sum(jnp.where(inner, a_l * c_rev * w, 0.0), axis=-1)
        direct = jnp.where(n < p, jnp.take(a, jnp.clip(n, 0, p), axis=-1), 0.0)
        return c.at[..., n].set(direct + term)

    c = jax.lax.fori_loop(1, n_lpcc, body, c0)
    return -c[..., 1:]
