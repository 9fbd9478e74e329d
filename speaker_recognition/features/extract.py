"""Batched MFCC+LPC feature extraction — the JAX equivalent of
src/feature/{__init__,MFCC,LPC}.py.

Design: one jitted function per (fs, config, padded-length) triple computes
features for a whole padded batch of utterances:

  gather frames -> window+preemph -> matmul-DFT power
  -> mel matmul + log -> DCT matmul -> masked CMVN
  and, sharing the same windowed frames, autocorrelation + batched
  Levinson-Durbin for LPC.

The reference loops per frame in Python and per utterance in a
multiprocessing pool; here the frame axis and the utterance axis are both
array axes, so XLA runs the whole pipeline as a few large matmuls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FeatureConfig, LpcConfig, MfccConfig, frame_geometry, n_frames
from ..ops import frontend, levinson
from ..ops.framing import frame_signal, frame_validity_mask, window_preemph

# Pad single-utterance calls up to a multiple of this many samples so the jit
# cache stays small (one compile per bucket, not per wav length).
LENGTH_BUCKET = 4096


def _frontend_mode() -> str:
    """SRTPU_FRONTEND=packed|full.

    'packed' (default) computes the 512-point half-spectrum with the
    window/pre-emphasis folded in (one [256, 512] matmul) and
    derives the 2048-bin mel energies and the LPC autocorrelation through
    exact precomputed linear maps (ops/frontend.packed_frontend_operators)
    — ~7x fewer FLOPs than 'full', identical to f64 rounding. 'full'
    materializes the 2048-bin power spectrum like the reference does."""
    import os
    return os.environ.get("SRTPU_FRONTEND", "packed")


# The frontend's DFT, mel, DCT and autocorrelation matmuls always compute
# full float32 products. Rounding their operands to TF32 (the GPU's
# DEFAULT) puts a noise floor about 66 dB under each frame's energy: on an
# H100 that moved the MFCCs by a median 0.016 (p99 3.2) and the LPCs by a
# median 0.49 against the float64 oracle, and flipped most decisions of a
# bank trained on such features when scored against reference features
# (PERF.md). At float32 the medians are 4e-6 and 8e-4.
_FRONTEND_PRECISION = jax.lax.Precision.HIGHEST


def masked_cmvn(feat: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Per-utterance mean/variance normalization over valid frames.

    Mirrors src/feature/MFCC.py:74-77 ((f-mu)/sigma with population std),
    but mask-aware so zero padding cannot perturb the statistics. Skipped
    (identity) when an utterance has <= 1 valid frame, like the reference's
    `if feature.shape[0] > 1` guard.
    """
    m = mask[..., None].astype(feat.dtype)
    count = jnp.sum(m, axis=-2, keepdims=True)
    safe = jnp.maximum(count, 1.0)
    mu = jnp.sum(feat * m, axis=-2, keepdims=True) / safe
    var = jnp.sum((feat - mu) ** 2 * m, axis=-2, keepdims=True) / safe
    sigma = jnp.sqrt(var)
    normed = (feat - mu) / sigma
    return jnp.where(count > 1, normed, feat)


def apply_deltas(feat: jnp.ndarray, mask: jnp.ndarray, nd: int):
    """Reference diff_feature ROW semantics on a masked padded batch
    (src/feature/utils.py:24-31): nd frames are consumed from the front, so
    the output has nd fewer rows and the valid prefix shrinks by nd (the
    contiguous-prefix invariant the GMM init relies on is preserved).

    Column-order deviation: this diffs the already-concatenated MFCC+LPC
    vector, yielding [mfcc, lpc, d_mfcc, d_lpc]; the reference applies
    diff_feature per extractor before concatenation, yielding
    [mfcc, d_mfcc, lpc, d_lpc]. The GMM (diagonal, per-dim) is invariant to
    the column permutation so decisions/scores match, but feature matrices
    are NOT directly comparable column-for-column with reference-diffed
    features."""
    if nd == 0:
        return feat, mask
    d1 = feat[..., 1:, :] - feat[..., :-1, :]
    if nd == 1:
        return (jnp.concatenate([feat[..., 1:, :], d1], axis=-1),
                mask[..., 1:])
    if nd == 2:
        d2 = d1[..., 1:, :] - d1[..., :-1, :]
        return (jnp.concatenate([feat[..., 2:, :], d1[..., 1:, :], d2],
                                axis=-1),
                mask[..., 2:])
    raise ValueError(f"n_deltas must be 0, 1 or 2, got {nd}")


@functools.lru_cache(maxsize=64)
def _feature_fn(fs: int, cfg: FeatureConfig, padded_len: int, dtype: str,
                frontend_mode: str | None = None):
    """Build and jit the batched extractor for one static geometry."""
    if frontend_mode is None:
        frontend_mode = _frontend_mode()
    mm = functools.partial(jnp.matmul, precision=_FRONTEND_PRECISION)
    mf: MfccConfig = cfg.mfcc
    lp: LpcConfig = cfg.lpc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    if cfg.use_lpc:
        lgeom = frame_geometry(fs, lp.win_length_ms, lp.win_shift_ms)
        assert lgeom == (flen, fshift), (
            "MFCC and LPC must share frame geometry to be concatenated per "
            "frame (src/feature/__init__.py:25-30)")
        assert lp.pre_emph == mf.pre_emph, "shared windowed frames require equal pre-emphasis"
    T = n_frames(padded_len, flen, fshift)
    dt = jnp.dtype(dtype)

    # Compile-time constant operators (float64 on host, cast once).
    C_np, S_np = frontend.dft_power_projection(flen, mf.fft_size)
    if mf.f_max is not None:
        mel_np = frontend.mel_filterbank_bounded(
            fs, mf.fft_size, mf.n_filters, mf.f_min, mf.f_max,
            mf.mel_scale).T                                    # [bins, nb]
    else:
        mel_np = frontend.mel_filterbank(fs, mf.fft_size, mf.n_filters).T
    dct_np = frontend.dct_matrix(mf.n_filters)[1 : mf.n_ceps + 1].T
    # [nb, nceps]; drops c0, MFCC.py:36-38
    C = jnp.asarray(C_np, dt)
    S = jnp.asarray(S_np, dt)
    mel_t = jnp.asarray(mel_np, dt)
    dct_t = jnp.asarray(dct_np, dt)
    # The reference's 1e-100 floor (MFCC.py:7,67) is below the float32
    # range (a host-to-device cast flushes it to zero, so zero-padded
    # frames would produce log(0) = -inf). Clamp to 1e-35: f64 rounding
    # noise keeps real speech power far above it, so parity is unaffected.
    floor = max(mf.power_floor, 1e-35)

    # LPC autocorrelation comes from the same power spectrum via the
    # Wiener-Khinchin projection (one tiny matmul) instead of order+1
    # passes over the raw frames.
    acorr_t = (jnp.asarray(levinson.autocorr_operator(
        flen, mf.fft_size, lp.n_lpc), dt) if cfg.use_lpc else None)

    use_packed = frontend_mode == "packed" and mf.fft_size >= 2 * flen
    if use_packed:
        D_np, W_np, A_np = frontend.packed_frontend_operators(
            flen, mf.fft_size, mf.pre_emph, mel_np,
            lpc_order=lp.n_lpc if cfg.use_lpc else None,
            preemph_first=mf.preemph_first)
        D_c = jnp.asarray(D_np, dt)
        W_c = jnp.asarray(W_np, dt)
        A_c = jnp.asarray(A_np, dt) if cfg.use_lpc else None

    @jax.jit
    def fn(signals: jnp.ndarray, lengths: jnp.ndarray):
        signals = signals.astype(dt)
        frames = frame_signal(signals, flen, fshift)            # [B, T, flen]
        mask = frame_validity_mask(lengths, T, flen, fshift)    # [B, T]

        r = None
        if use_packed:
            # window + pre-emphasis folded into one [flen, 2*flen] DFT
            X = mm(frames, D_c)                                 # [B, T, 2*flen]
            Y = X * X
            logmel = jnp.log(jnp.maximum(mm(Y, W_c), floor))
            ceps = mm(logmel, dct_t)
            if cfg.use_lpc:
                r = mm(Y, A_c)
        else:
            wp = window_preemph(frames, flen, mf.pre_emph, mf.preemph_first)
            re = mm(wp, C)
            im = mm(wp, S)
            power = jnp.maximum(re * re + im * im, floor)
            logmel = jnp.log(mm(power, mel_t))
            ceps = mm(logmel, dct_t)                            # [B, T, nceps]
            if cfg.use_lpc:
                r = mm(power, acorr_t)                          # [B, T, p+1]
        if mf.cmvn:
            ceps = masked_cmvn(ceps, mask)

        if cfg.use_lpc:
            if lp.n_lpcc > 0:
                a, _ = levinson.levinson(r)
                lpc = jnp.nan_to_num(
                    levinson.lpcc_from_lpc(a, lp.n_lpcc),
                    nan=0.0, posinf=0.0, neginf=0.0)            # [B, T, n_lpcc-1]
            else:
                lpc = levinson.lpc_from_autocorr(r)             # [B, T, n_lpc]
            feat = jnp.concatenate([ceps, lpc], axis=-1)
        else:
            feat = ceps
        feat, mask = apply_deltas(feat, mask, cfg.n_deltas)
        return jnp.where(mask[..., None], feat, 0.0), mask

    return fn


def extract_batch(signals: jnp.ndarray, lengths: jnp.ndarray, fs: int,
                  cfg: FeatureConfig = FeatureConfig(), dtype: str = "float32"):
    """Features for a zero-padded batch: [B, L] -> ([B, T, d], [B, T] mask)."""
    return _feature_fn(int(fs), cfg, int(signals.shape[-1]), dtype,
                       _frontend_mode())(signals, lengths)


def _pad_to_bucket(signal: np.ndarray) -> np.ndarray:
    L = len(signal)
    padded = -(-max(L, 1) // LENGTH_BUCKET) * LENGTH_BUCKET
    out = np.zeros(padded, dtype=np.float32)
    out[:L] = signal
    return out


def signal_too_short(fs: int, cfg: FeatureConfig, n_samples: int) -> bool:
    """The reference's minimum-length rule (MFCC.py:56: <= 5 frame lengths
    raises 'Signal too short!'). One source of truth for every caller that
    must agree with mix_feature on which signals are extractable."""
    flen, _ = frame_geometry(fs, cfg.mfcc.win_length_ms,
                             cfg.mfcc.win_shift_ms)
    return n_samples <= 5 * flen


def mix_feature(fs: int, signal, cfg: FeatureConfig = FeatureConfig(),
                dtype: str = "float32") -> np.ndarray:
    """Single-utterance convenience wrapper: concat(MFCC, LPC) per frame.

    Drop-in for src/feature/__init__.py:25-30 (mix_feature). Accepts int or
    float PCM; multi-channel input is averaged like MFCC.py:52-54.
    """
    signal = np.asarray(signal, dtype=np.float64)
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    mf = cfg.mfcc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    if signal_too_short(fs, cfg, len(signal)):
        raise ValueError("Signal too short!")  # MFCC.py:56
    T = n_frames(len(signal), flen, fshift)
    if dtype == "float64":
        padded = np.zeros(-(-len(signal) // LENGTH_BUCKET) * LENGTH_BUCKET)
        padded[: len(signal)] = signal
    else:
        padded = _pad_to_bucket(signal.astype(np.float32))
    feat, _ = _feature_fn(int(fs), cfg, len(padded), dtype,
                          _frontend_mode())(
        jnp.asarray(padded)[None, :], jnp.asarray([len(signal)]))
    # fetch-then-slice: slicing the device array here would dispatch eager
    # slice ops that compile once per distinct T
    return np.asarray(feat)[0, :T - cfg.n_deltas]


def mfcc_extract(fs: int, signal, cfg: MfccConfig = MfccConfig(),
                 dtype: str = "float32") -> np.ndarray:
    """MFCC only — equivalent of src/feature/MFCC.py:extract."""
    feats = mix_feature(fs, signal, FeatureConfig(mfcc=cfg, use_lpc=False), dtype)
    return feats


def lpc_extract(fs: int, signal, cfg: LpcConfig = LpcConfig(),
                dtype: str = "float32") -> np.ndarray:
    """LPC only — equivalent of src/feature/LPC.py:extract."""
    fcfg = FeatureConfig(
        mfcc=MfccConfig(win_length_ms=cfg.win_length_ms,
                        win_shift_ms=cfg.win_shift_ms,
                        pre_emph=cfg.pre_emph),
        lpc=cfg, use_lpc=True)
    feats = mix_feature(fs, signal, fcfg, dtype)
    return feats[:, fcfg.mfcc.n_ceps:]


def diff_feature(feat: np.ndarray, nd: int = 1) -> np.ndarray:
    """Delta / delta-delta features, src/feature/utils.py:24-31."""
    diff = feat[1:] - feat[:-1]
    feat = feat[1:]
    if nd == 1:
        return np.concatenate((feat, diff), axis=1)
    elif nd == 2:
        d2 = diff[1:] - diff[:-1]
        return np.concatenate((feat[1:], diff[1:], d2), axis=1)
    raise ValueError(f"nd must be 1 or 2, got {nd}")
