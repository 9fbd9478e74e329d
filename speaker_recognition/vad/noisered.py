"""Profile-based spectral noise reduction.

JAX replacement for the reference's sox shell-out
(src/filters/noisered.py:21-38): there, ``init_noise`` writes the noise
clip to /tmp and runs ``sox ... noiseprof``, and ``filter`` round-trips
every utterance through /tmp wav files and ``sox ... noisered <prof>
0.21``. Here the same two-phase API (profile a noise clip, then attenuate
that noise in later signals) is a single on-device STFT program: no
temp files, no subprocess, and the whole batch of frames is one
windowed-DFT + elementwise gain + overlap-add.

Algorithm (short-time spectral subtraction, the same family sox's
noisered implements):

    profile[k]   = mean_l |STFT(noise)[l, k]|^2              (init_noise)
    Psm[l, k]    = 5-frame moving average of |STFT(x)|^2     (filter)
    gain[l, k]   = (1-a) + a * sqrt(max(1 - 2*profile[k]/Psm[l,k], 0))
    out          = ISTFT(gain * STFT(x))

with ``a`` the reduction amount in [0, 1] — 0 is passthrough, 1 is full
power spectral subtraction; the default 0.21 mirrors the reference's
THRES (noisered.py:17). Analysis/synthesis use a Hann window at 50%
overlap with window-square normalized overlap-add, so a = 0 reconstructs
the input exactly (up to float rounding).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NoiseReduction", "spectral_gate"]

DEFAULT_AMOUNT = 0.21  # sox noisered threshold, src/filters/noisered.py:17


def _window_size(fs: int) -> int:
    # 32 ms, even; matches the feature frontend's frame length at fs=8000.
    return max(int(0.032 * fs) // 2 * 2, 32)


def _frame_count(n: int, ws: int) -> int:
    # frames over [hop zeros | signal | tail zeros]: every real sample is
    # covered by two analysis windows, so the overlap-add window^2
    # normalization is well-conditioned everywhere we read back.
    hop = ws // 2
    return (hop + n + hop - 1) // hop + 1


@functools.lru_cache(maxsize=32)
def _profile_fn(ws: int):
    window = jnp.asarray(np.hanning(ws), jnp.float32)

    @jax.jit
    def fn(frames):  # [T, ws] -> [nb] mean power per bin
        spec = jnp.fft.rfft(frames * window, axis=-1)
        return jnp.mean(jnp.abs(spec) ** 2, axis=0)

    return fn


@functools.lru_cache(maxsize=64)
def _gate_fn(ws: int, n_frames: int, out_len: int):
    """jitted: ([T, ws] frames, [nb] profile, amount) -> [out_len] signal."""
    window = jnp.asarray(np.hanning(ws), jnp.float32)
    hop = ws // 2

    @jax.jit
    def fn(frames, profile, amount):
        spec = jnp.fft.rfft(frames * window, axis=-1)           # [T, nb]
        power = jnp.abs(spec) ** 2
        # Per-frame noise power fluctuates ~exponentially around the profile,
        # so raw subtraction leaves ~4-5 dB of musical residue; estimate the
        # local power by a 5-frame moving average (tiny conv) and
        # oversubtract 2x the profile — the standard Berouti-style gate.
        kernel = jnp.full((5, 1), 0.2, power.dtype)
        smooth = jax.scipy.signal.convolve(power, kernel, mode="same")
        sub = jnp.sqrt(jnp.maximum(
            1.0 - 2.0 * profile / jnp.maximum(smooth, 1e-30), 0.0))
        gain = (1.0 - amount) + amount * sub
        cleaned = jnp.fft.irfft(spec * gain, n=ws, axis=-1) * window  # [T, ws]
        # overlap-add + window^2 normalization (exact COLA for any window)
        idx = (jnp.arange(n_frames)[:, None] * hop
               + jnp.arange(ws)[None, :]).reshape(-1)
        total = n_frames * hop + ws
        acc = jnp.zeros(total, jnp.float32).at[idx].add(cleaned.reshape(-1))
        wsq = jnp.zeros(total, jnp.float32).at[idx].add(
            jnp.tile(window * window, n_frames))
        # skip the first hop (zero padding added by _frames): the returned
        # region has full two-frame coverage, so wsq >= ~0.5 throughout
        return (acc / jnp.maximum(wsq, 1e-8))[hop: hop + out_len]

    return fn


def _frames(signal: np.ndarray, ws: int, n_frames: int) -> np.ndarray:
    hop = ws // 2
    padded = np.zeros(n_frames * hop + ws, np.float32)
    padded[hop: hop + len(signal)] = signal  # see _frame_count
    idx = np.arange(n_frames)[:, None] * hop + np.arange(ws)[None, :]
    return padded[idx]


def spectral_gate(signal: np.ndarray, profile: np.ndarray, ws: int,
                  amount: float) -> np.ndarray:
    """Attenuate the profiled noise in `signal`; returns len(signal) floats."""
    signal = np.asarray(signal, np.float32)
    n_frames = _frame_count(len(signal), ws)
    frames = _frames(signal, ws, n_frames)
    out = _gate_fn(ws, n_frames, len(signal))(
        jnp.asarray(frames), jnp.asarray(profile, jnp.float32),
        jnp.float32(amount))
    return np.asarray(out)


class NoiseReduction:
    """Same surface as the reference's NoiseReduction (noisered.py:19-38)."""

    def __init__(self, amount: float = DEFAULT_AMOUNT):
        self.amount = float(amount)
        self.fs = 0
        self.window_size = 0
        self.profile = None

    @staticmethod
    def _mono(signal: np.ndarray) -> np.ndarray:
        signal = np.asarray(signal, np.float32)
        if signal.ndim > 1:
            signal = signal.mean(axis=1)  # utils.monophonic semantics
        return signal

    def init_noise(self, fs: int, signal):
        """Build the per-bin noise power profile (vs `sox noiseprof`)."""
        signal = self._mono(signal)
        self.fs = int(fs)
        self.window_size = _window_size(self.fs)
        n_frames = _frame_count(len(signal), self.window_size)
        frames = _frames(signal, self.window_size, n_frames)
        self.profile = np.asarray(
            _profile_fn(self.window_size)(jnp.asarray(frames)))

    def filter(self, fs: int, signal) -> np.ndarray:
        """Suppress the profiled noise (vs `sox noisered prof 0.21`)."""
        if self.profile is None:
            raise RuntimeError("NoiseReduction not initialized with noise")
        return spectral_gate(self._mono(signal), self.profile,
                             self.window_size, self.amount)
