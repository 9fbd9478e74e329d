"""Fused speaker-bank GMM scoring: one Pallas kernel on the Triton route.

The XLA scoring program (models/gmm.batch_bank_avg_loglik) computes the
joint log-density of every frame against every (speaker, component) pair
as one [n, 2d] @ [2d, S*K] matmul and writes that [n, S*K] tensor to
device memory before the per-speaker logsumexp reads it back. At a
UBM-scale bank (80 speakers x 256 components) and 128 clips of 5 s that
tensor is about 3.3 GB. This kernel never writes it: each block of frames
is multiplied against one speaker's components at a time and the
logsumexp over K is reduced in registers, so only the [S, n] per-frame
per-speaker log-likelihoods leave the kernel.

Layout (natural [n, d] frames, no transpose):

    Z = [x^2 | x]          [n, 2*dp]   dp = d padded to a power of two >= 16
    W = [A ; B]            [2*dp, S*Kp] A = -1/(2 sigma^2), B = mu/sigma^2
    c = const + log w      [S*Kp]       Kp = K padded to a power of two >= 16
    logp[t, (s, k)] = Z[t] @ W[:, s*Kp + k] + c[s*Kp + k]

Grid = (frame blocks, speaker blocks). A program loads its [bn, 2*dp]
frame block once and, for each of its speakers, runs one `pl.dot` of depth
2*dp per chunk of components with an online (running max, running sum)
logsumexp. Padded components carry c = -1e30, so they add exp(-inf) = 0;
padded speakers and frames are sliced off. The masked per-utterance mean
and the reference's underflow floor are a small XLA epilogue on [S, n].

Precision: the dots run on the TF32 tensor cores (`allow_tf32=True`,
float32 accumulation) in three passes, hi*hi + lo*hi + hi*lo, where
hi = x truncated to TF32's 10 mantissa bits and lo = x - hi (the 3xTF32
split), so each log-density carries float32-class error (~2^-21
relative) like gmm.PRECISION's XLA matmuls. A single TF32 pass is not
enough: its rounding of the bank operands biases whole scores (see
models/gmm.PRECISION).
"""

from __future__ import annotations

import functools
import math
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..models import gmm as gmm_mod

__all__ = ["kernel_available", "use_kernel", "frame_speaker_lse",
           "batch_bank_avg_loglik", "block_config"]

# Frames per program, components per dot, warps and pipeline stages, and
# speakers per program (the frame block is reused across them). On an
# H100 SXM most block choices score the 80 x 256 bank in 3.0-3.5 ms; this
# one measured 3.04 ms there and 0.37 ms at 4 x 32, while 64-frame blocks
# with 8 warps took 6.78 ms at 80 x 256 (PERF.md).
FRAME_BLOCK = 128
K_CHUNK = 32
NUM_WARPS = 8
NUM_STAGES = 2
SPK_BLOCK = 4
# Log-weight of a padded component: exp(-1e30 - m) == 0 for any real m,
# and finite, so a chunk that is all padding cannot produce inf - inf.
_PAD_LOG = -1e30


def kernel_available() -> bool:
    """The one capability check: the kernel is compiled for CUDA GPUs."""
    return jax.default_backend() == "gpu"


def use_kernel(dtype="float32") -> bool:
    """Whether serving scores with the kernel instead of XLA: for every
    float32 bank where kernel_available() holds, since on an H100 it ties
    or beats the XLA scoring at every bank and batch measured (PERF.md).

    SRTPU_PALLAS: 'auto' (default) or 'off' (always XLA). Anything else
    raises, so a request for a kernel the backend cannot run is never
    silently served by another program."""
    mode = os.environ.get("SRTPU_PALLAS", "auto")
    if mode not in ("auto", "off"):
        raise ValueError(
            f"SRTPU_PALLAS={mode!r}: expected 'auto' or 'off' (the scoring "
            "kernel runs where kernel_available() holds; "
            f"backend here: {jax.default_backend()})")
    return (mode == "auto" and kernel_available()
            and jnp.dtype(dtype) == jnp.float32)


def split_tf32(x: jnp.ndarray):
    """float32 x -> (hi, lo): hi keeps TF32's 10 mantissa bits (the low 13
    bits cleared), lo = x - hi is exact, so hi and lo both enter a TF32
    dot with (almost) no further rounding."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFE000),
                                      jnp.float32)
    return hi, x - hi


def _pow2(x: int, lo: int = 16) -> int:
    return max(lo, 1 << (max(int(x), 1) - 1).bit_length())


def block_config(n: int, S: int, K: int, d: int) -> dict:
    """Padded sizes and block shapes the kernel uses for an [n, d] frame
    matrix against an [S, K] bank (all powers of two, as Triton needs)."""
    dp = _pow2(d)
    kp = _pow2(K)
    kb = min(K_CHUNK, kp)
    sb = min(SPK_BLOCK, _pow2(S, lo=1))
    bn = min(FRAME_BLOCK, _pow2(n))
    return {"dp": dp, "kp": kp, "kb": kb, "sb": sb, "bn": bn,
            "s_pad": -(-S // sb) * sb, "n_pad": -(-max(n, 1) // bn) * bn}


def _lse_kernel(zh_ref, zl_ref, wh_ref, wl_ref, c_ref, o_ref, *, sb: int,
                kp: int, kb: int):
    zh, zl = zh_ref[...], zl_ref[...]                      # [bn, 2*dp]
    for i in range(sb):
        m = jnp.full((zh.shape[0],), _PAD_LOG, jnp.float32)
        l = jnp.zeros((zh.shape[0],), jnp.float32)
        for j in range(kp // kb):
            lo = i * kp + j * kb
            wh = wh_ref[:, lo:lo + kb]
            logp = (pl.dot(zh, wh, allow_tf32=True)
                    + pl.dot(zl, wh, allow_tf32=True)
                    + pl.dot(zh, wl_ref[:, lo:lo + kb], allow_tf32=True)
                    + c_ref[lo:lo + kb][None, :])          # [bn, kb]
            m_new = jnp.maximum(m, jnp.max(logp, axis=1))
            l = (l * jnp.exp(m - m_new)
                 + jnp.sum(jnp.exp(logp - m_new[:, None]), axis=1))
            m = m_new
        o_ref[i, :] = m + jnp.log(l)


@functools.partial(jax.jit, static_argnames=("K", "interpret"))
def frame_speaker_lse(bank: gmm_mod.GmmParams, X: jnp.ndarray, K: int,
                      interpret: bool = False) -> jnp.ndarray:
    """[n, d] frames x bank [S, K] -> [S, n] per-frame per-speaker
    log sum_k w_k N(x_t; mu_k, sigma_k) (no underflow floor)."""
    n, d = X.shape
    S = bank.weights.shape[0]
    cfg = block_config(n, S, K, d)
    dp, kp, kb, sb, bn = (cfg[k] for k in ("dp", "kp", "kb", "sb", "bn"))
    s_pad, n_pad = cfg["s_pad"], cfg["n_pad"]

    X = X.astype(jnp.float32)
    Xp = jnp.pad(X, ((0, n_pad - n), (0, dp - d)))
    Z = jnp.concatenate([Xp * Xp, Xp], axis=-1)            # [n_pad, 2dp]

    sig = bank.sigmas.astype(jnp.float32)
    mu = bank.means.astype(jnp.float32)
    inv_var = 1.0 / (sig * sig)                            # [S, K, d]
    pad_sk = ((0, s_pad - S), (0, kp - K))
    A = jnp.pad(-0.5 * inv_var, pad_sk + ((0, dp - d),))
    B = jnp.pad(mu * inv_var, pad_sk + ((0, dp - d),))
    W = jnp.concatenate([A, B], axis=-1).reshape(s_pad * kp, 2 * dp).T
    c = (-0.5 * jnp.sum(mu * mu * inv_var, axis=-1)
         - jnp.sum(gmm_mod.LOG_SQRT_2_PI + jnp.log(sig), axis=-1)
         + jnp.log(bank.weights.astype(jnp.float32)))       # [S, K]
    c = jnp.pad(c, ((0, 0), (0, kp - K)), constant_values=_PAD_LOG)
    c = jnp.pad(c, ((0, s_pad - S), (0, 0))).reshape(s_pad * kp)

    frames = pl.BlockSpec((bn, 2 * dp), lambda i, s: (i, 0))
    operator = pl.BlockSpec((2 * dp, sb * kp), lambda i, s: (0, s))
    out = pl.pallas_call(
        functools.partial(_lse_kernel, sb=sb, kp=kp, kb=kb),
        grid=(n_pad // bn, s_pad // sb),
        in_specs=[frames, frames, operator, operator,
                  pl.BlockSpec((sb * kp,), lambda i, s: (s,))],
        out_specs=pl.BlockSpec((sb, bn), lambda i, s: (s, i)),
        out_shape=jax.ShapeDtypeStruct((s_pad, n_pad), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=3 * 2 * n_pad * 2 * dp * s_pad * kp,
            transcendentals=n_pad * s_pad * kp,
            bytes_accessed=4 * 2 * (n_pad * 2 * dp + 2 * dp * s_pad * kp)
            + 4 * s_pad * n_pad),
        interpret=interpret,
        name="gmm_bank_lse",
    )(*split_tf32(Z), *split_tf32(W), c)
    return out[:S, :n]


def batch_bank_avg_loglik(bank: gmm_mod.GmmParams, feats: jnp.ndarray,
                          mask: jnp.ndarray, interpret: bool = False,
                          min_prob_sum: float = 1e-15) -> jnp.ndarray:
    """[B, T, d] x bank [S, K] -> [B, S] masked per-frame averages; the
    same quantity, floor and mask rule as gmm.batch_bank_avg_loglik."""
    B, T, d = feats.shape
    S, K = bank.weights.shape
    lse = frame_speaker_lse(bank, feats.reshape(B * T, d), K,
                            interpret=interpret).reshape(S, B, T)
    lse = jnp.where(lse > gmm_mod._UNDERFLOW_LOG, lse, math.log(min_prob_sum))
    m = mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    return jnp.einsum("sbt,bt->bs", lse, m,
                      precision=gmm_mod.PRECISION) / n[:, None]
