"""Sequence-sharded feature extraction for long utterances.

SURVEY.md section 5: frames are i.i.d. given the GMM, so the honest
analogue of context parallelism for this workload is sharding the *frame
axis* of one long utterance across chips. Each chip frames and transforms
its contiguous sample chunk; the only couplings are

  * a halo of (frame_len - frame_shift) samples at each chunk boundary —
    exchanged with the right neighbor via jax.lax.ppermute, and
  * the per-utterance CMVN statistics (MFCC.py:74-77) — one psum of
    (sum, sum-of-squares, count) over the 'data' axis.

Numerics match the single-device extractor exactly: the union of per-shard
frame starts equals the unsharded frame grid, and the one trailing frame
whose window would cross the signal end (its halo wraps around the ring) is
masked out, exactly where the unsharded extractor stops framing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FeatureConfig, frame_geometry
from ..ops import frontend, levinson
from ..ops.framing import window_preemph

__all__ = ["sharded_mix_feature"]


def _build(mesh: Mesh, fs: int, cfg: FeatureConfig, chunk: int, dtype):
    mf = cfg.mfcc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    assert chunk % fshift == 0, "chunk must be a multiple of the frame shift"
    halo = flen - fshift
    assert halo < chunk, "chunk too small for the frame window"
    frames_per_shard = chunk // fshift
    n_shards = int(np.prod([mesh.shape[a] for a in ("data",)]))

    C, S = frontend.dft_power_projection(flen, mf.fft_size)
    mel_t = frontend.mel_filterbank(fs, mf.fft_size, mf.n_filters).T
    dct_t = frontend.dct_matrix(mf.n_filters)[1: mf.n_ceps + 1].T
    dt = jnp.dtype(dtype)
    Cj, Sj = jnp.asarray(C, dt), jnp.asarray(S, dt)
    mel_j, dct_j = jnp.asarray(mel_t, dt), jnp.asarray(dct_t, dt)
    floor = max(mf.power_floor, 1e-35)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data"), P()),
        out_specs=(P("data"), P("data")),
    )
    def fn(sig_chunk, total_len):
        # halo exchange: receive the head of the right neighbor's chunk
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        head = jax.lax.ppermute(sig_chunk[:halo][None, :], "data", perm)[0]
        ext = jnp.concatenate([sig_chunk, head])          # [chunk + halo]

        idx = (jnp.arange(frames_per_shard)[:, None] * fshift
               + jnp.arange(flen)[None, :])
        frames = ext[idx]                                  # [T_s, flen]
        shard = jax.lax.axis_index("data")
        # global start of each frame; frame valid iff window inside signal
        starts = shard * chunk + jnp.arange(frames_per_shard) * fshift
        mask = starts + flen <= total_len

        wp = window_preemph(frames, flen, mf.pre_emph)
        re = wp @ Cj
        im = wp @ Sj
        power = jnp.maximum(re * re + im * im, floor)
        ceps = jnp.log(power @ mel_j) @ dct_j              # [T_s, nceps]

        if mf.cmvn:
            m = mask[:, None].astype(dt)
            s1 = jax.lax.psum(jnp.sum(ceps * m, axis=0), "data")
            s2 = jax.lax.psum(jnp.sum(ceps * ceps * m, axis=0), "data")
            n = jax.lax.psum(jnp.sum(m), "data")
            mu = s1 / n
            sigma = jnp.sqrt(s2 / n - mu * mu)
            ceps = jnp.where(n > 1, (ceps - mu[None, :]) / sigma[None, :], ceps)

        if cfg.use_lpc:
            lpc = levinson.lpc_from_frames(wp, cfg.lpc.n_lpc)
            feat = jnp.concatenate([ceps, lpc], axis=-1)
        else:
            feat = ceps
        return jnp.where(mask[:, None], feat, 0.0), mask

    return jax.jit(fn), frames_per_shard, fshift, flen


def sharded_mix_feature(mesh: Mesh, fs: int, signal, cfg: FeatureConfig =
                        FeatureConfig(), dtype: str = "float32"):
    """One long utterance -> [T, d] features, frame axis sharded over the
    mesh's 'data' axis during extraction. Returns the valid frames only,
    numerically equal to features/extract.mix_feature."""
    signal = np.asarray(signal, np.float64)
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    n_shards = mesh.shape["data"]
    mf = cfg.mfcc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    L = len(signal)
    # chunk: multiple of fshift, shards cover ceil(L / n_shards)
    chunk = -(-L // (n_shards * fshift)) * fshift
    padded = np.zeros(chunk * n_shards, np.float64)
    padded[:L] = signal

    fn, fps, _, _ = _build(mesh, fs, cfg, chunk, dtype)
    feat, mask = fn(jnp.asarray(padded, jnp.dtype(dtype)),
                    jnp.asarray(L, jnp.int32))
    feat = np.asarray(feat)
    mask = np.asarray(mask)
    return feat[mask]
