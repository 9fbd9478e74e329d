"""Typed configuration for the JAX speaker-recognition framework.

Every constant here mirrors a behavioral constant of the reference system
(ppwwyyxx/speaker-recognition); the reference file:line is cited next to each
field so parity can be audited. The reference scatters these across three
ad-hoc layers (argparse CLI, tclap C++ flags, Python constants modules —
see src/testbench/config.py:7-17, src/feature/MFCC.py:116-118,
src/feature/LPC.py:60-61, src/gmm/python/pygmm.py:39-46); here they live in
frozen dataclasses so they are hashable and can key jit caches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MfccConfig:
    """MFCC extraction parameters.

    Defaults mirror src/feature/MFCC.py:116-118 (win 32 ms / shift 16 ms,
    2048-pt FFT, 50 mel filters, 13 cepstra, pre-emphasis 0.95).
    """

    win_length_ms: float = 32.0
    win_shift_ms: float = 16.0
    fft_size: int = 2048
    n_filters: int = 50
    n_ceps: int = 13
    pre_emph: float = 0.95
    # Power-spectrum floor, src/feature/MFCC.py:7
    power_floor: float = 1e-100
    # Per-utterance cepstral mean/variance normalization,
    # src/feature/MFCC.py:74-77 (applied only when n_frames > 1).
    cmvn: bool = True
    # Filterbank frequency bounds. f_max=None selects the melfb.m
    # exp-spaced bank spanning [0, fs/2] (the reference's own MFCC.py
    # fallback); setting f_max (optionally f_min) selects the bounded
    # triangular bank of the bob.ap.Ceps wrapper the reference prefers
    # (src/feature/BOB.py:13-18, defaults f in [0, 6000]).
    f_min: float = 0.0
    f_max: Optional[float] = None
    # mel warping for the bounded bank (bob's mel_scale flag); ignored by
    # the melfb.m bank.
    mel_scale: bool = True
    # Pre-emphasis/window order: False = the reference MFCC.py's
    # window-then-preemph (src/feature/MFCC.py:61-64); True = bob.ap's
    # preemph-then-window with the first sample scaled by (1-a).
    preemph_first: bool = False


def bob_mfcc_config(**overrides) -> "MfccConfig":
    """The bob.ap.Ceps defaults the reference uses when bob is importable:
    55 filters, 19 cepstra, f in [0, 6000] Hz, pre-emphasis before the
    window (src/feature/BOB.py:13-18)."""
    kw = dict(n_filters=55, n_ceps=19, f_min=0.0, f_max=6000.0,
              preemph_first=True)
    kw.update(overrides)
    return MfccConfig(**kw)


@dataclasses.dataclass(frozen=True)
class LpcConfig:
    """LPC extraction parameters. Defaults mirror src/feature/LPC.py:60-61."""

    win_length_ms: float = 32.0
    win_shift_ms: float = 16.0
    n_lpc: int = 15
    pre_emph: float = 0.95
    # LPC cepstra (the reference's dormant lpc_to_cc recursion,
    # src/feature/LPC.py:27-38): 0 = emit raw LPC coefficients (the
    # reference's active path); >0 = emit n_lpcc-1 cepstra instead.
    n_lpcc: int = 0


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """The combined per-frame feature = concat(MFCC, LPC),
    src/feature/__init__.py:25-30.

    n_deltas adds temporal derivatives to the mixed vector with the
    reference's diff_feature semantics (src/feature/utils.py:24-31, the
    `diff=True` extractor option / bob's delta_win surface,
    src/feature/BOB.py:13-18): nd=1 -> [x_{t+1}, x_{t+1}-x_t] (one leading
    frame consumed), nd=2 additionally appends the second difference (two
    frames consumed). 0 (the reference CLI's effective default) disables.
    """

    mfcc: MfccConfig = MfccConfig()
    lpc: LpcConfig = LpcConfig()
    use_lpc: bool = True
    n_deltas: int = 0

    @property
    def base_dim(self) -> int:
        if not self.use_lpc:
            return self.mfcc.n_ceps
        lpc_dim = (self.lpc.n_lpcc - 1 if self.lpc.n_lpcc > 0
                   else self.lpc.n_lpc)
        return self.mfcc.n_ceps + lpc_dim

    @property
    def dim(self) -> int:
        return self.base_dim * (1 + self.n_deltas)


@dataclasses.dataclass(frozen=True)
class GmmConfig:
    """GMM/EM training parameters.

    Defaults mirror the native trainer's defaults
    (src/gmm/python/pygmm.py:39-46 and src/gmm/src/gmm.hh): 32 mixtures is the
    production order (src/gui/skgmm.py:13, src/testbench/gmmset.py:17).
    """

    n_mixtures: int = 32
    n_iterations: int = 200
    min_covar: float = 1e-3
    # Relative log-likelihood convergence threshold, src/gmm/src/gmm.cc:643-650
    threshold: float = 0.01
    # k-means init off by default, matching pygmm.py:44
    init_with_kmeans: bool = False
    # Linear-space probability floor per frame, src/gmm/src/gmm.cc:481-492
    min_prob_sum: float = 1e-15
    # Soft-count floor, src/gmm/src/gmm.cc:502-513
    min_nk: float = 1e-6
    # MAP relevance factor for UBM adaptation, src/gmm/src/gmm.hh:110-112
    relevance_factor: float = 16.0
    # Convergence is only checked every second iteration (odd i),
    # src/gmm/src/gmm.cc:620-652
    check_every: int = 2
    seed: int = 0

    @property
    def min_sigma(self) -> float:
        # Variance floor is applied to sigma = sqrt(covar),
        # src/gmm/src/gmm.cc:415-437
        return float(self.min_covar) ** 0.5


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """LTSD VAD parameters, src/filters/ltsd.py."""

    # window_size = int(0.04644 * fs), src/filters/ltsd.py:17,66-69
    window_factor: float = 0.04644
    order: int = 5
    # lambda0 = 1.1 * max(noise LTSD); lambda1 = 2 * lambda0,
    # src/filters/ltsd.py:38-41
    lambda0_scale: float = 1.1
    lambda1_scale: float = 2.0
    # Keep the original signal when VAD would strip more than 2/3 of it,
    # src/gui/interface.py:43-53
    keep_fraction: float = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class SilenceConfig:
    """Energy-based silence removal, src/filters/silence.py:11-50."""

    frame_duration: float = 0.02
    frame_shift: float = 0.01
    perc: float = 0.15


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level session configuration (ModelInterface equivalent)."""

    features: FeatureConfig = FeatureConfig()
    gmm: GmmConfig = GmmConfig()
    vad: VadConfig = VadConfig()
    silence: SilenceConfig = SilenceConfig()
    # Open-set rejection threshold on (best LLR - UBM LLR) per frame,
    # src/testbench/gmmset.py:18-27,69-81
    reject_threshold: float = 10.0
    dtype: str = "float32"

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


DEFAULT = PipelineConfig()


def frame_geometry(fs: int, win_length_ms: float, win_shift_ms: float):
    """Frame length/shift in samples, src/feature/MFCC.py:28-29."""
    frame_len = int(float(win_length_ms) / 1000 * fs)
    frame_shift = int(float(win_shift_ms) / 1000 * fs)
    return frame_len, frame_shift


def n_frames(signal_len: int, frame_len: int, frame_shift: int) -> int:
    """Frame count for a signal, src/feature/MFCC.py:57."""
    if signal_len < frame_len:
        return 0
    return (signal_len - frame_len) // frame_shift + 1
