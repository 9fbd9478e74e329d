"""VAD tests: energy silence-removal parity oracle + LTSD behavior +
spectral noise reduction."""

import numpy as np
import pytest

from speaker_recognition.vad import VAD
from speaker_recognition.vad.energy import remove_silence
from speaker_recognition.vad.ltsd import (
    LtsdVad, ltsd_scores, noise_profile, segment_intervals)
from speaker_recognition.vad.noisered import NoiseReduction


def oracle_remove_silence(fs, signal, frame_duration=0.02, frame_shift=0.01,
                          perc=0.15):
    """Literal transcription of src/filters/silence.py:11-50 (python2
    semantics: integer floor division in the unsigned centering)."""
    orig_dtype = signal.dtype
    typeinfo = np.iinfo(orig_dtype)
    is_unsigned = typeinfo.min >= 0
    signal = signal.astype(np.int64)
    if is_unsigned:
        signal = signal - (typeinfo.max + 1) // 2
    siglen = len(signal)
    retsig = np.zeros(siglen, dtype=np.int64)
    frame_length = int(frame_duration * fs)
    frame_shift_length = int(frame_shift * fs)
    new_siglen = 0
    i = 0
    average_energy = np.sum(signal ** 2) / float(siglen)
    while i < siglen:
        subsig = signal[i:i + frame_length]
        ave_energy = np.sum(subsig ** 2) / float(len(subsig))
        if ave_energy < average_energy * perc:
            i += frame_length
        else:
            sigaddlen = min(frame_shift_length, len(subsig))
            retsig[new_siglen:new_siglen + sigaddlen] = subsig[:sigaddlen]
            new_siglen += sigaddlen
            i += frame_shift_length
    retsig = retsig[:new_siglen]
    if is_unsigned:
        retsig = retsig + typeinfo.max // 2
    return retsig.astype(orig_dtype)


def speech_with_silence(fs=8000, seed=0):
    """3 s: silence, tone burst, silence, tone burst."""
    rng = np.random.RandomState(seed)
    n = fs * 3
    t = np.arange(n) / fs
    sig = np.zeros(n)
    voiced = np.zeros(n, dtype=bool)
    for start, dur in [(0.5, 0.6), (1.8, 0.7)]:
        s, e = int(start * fs), int((start + dur) * fs)
        sig[s:e] = np.sin(2 * np.pi * 220 * t[s:e]) + 0.5 * np.sin(2 * np.pi * 440 * t[s:e])
        voiced[s:e] = True
    sig += 0.001 * rng.randn(n)
    return (sig * 8000).astype(np.int16), voiced


class TestEnergySilence:
    def test_matches_oracle_int16(self):
        sig, _ = speech_with_silence()
        ours = remove_silence(8000, sig)
        ref = oracle_remove_silence(8000, sig)
        np.testing.assert_array_equal(ours, ref)
        assert len(ours) < len(sig)

    def test_matches_oracle_uint8(self):
        rng = np.random.RandomState(1)
        sig = (rng.rand(16000) * 30 + 112).astype(np.uint8)
        sig[4000:8000] = (rng.rand(4000) * 200 + 27).astype(np.uint8)
        ours = remove_silence(8000, sig)
        ref = oracle_remove_silence(8000, sig)
        np.testing.assert_array_equal(ours, ref)


class TestLtsd:
    def test_detects_voice_segments(self):
        fs = 8000
        rng = np.random.RandomState(2)
        noise = (rng.randn(fs) * 20).astype(np.float64)
        sig, voiced = speech_with_silence(fs)
        sig = sig.astype(np.float64) + rng.randn(len(sig)) * 20

        vad = LtsdVad()
        vad.init_params_by_noise(fs, noise)
        filtered, intervals = vad.filter(sig)
        assert len(intervals) >= 1
        # detected intervals should cover most of the true voiced region
        covered = np.zeros(len(sig), dtype=bool)
        for s, e in intervals:
            covered[s:e] = True
        overlap = (covered & voiced).sum() / voiced.sum()
        assert overlap > 0.7, overlap
        # and not claim much silence. The +-order LTSE max inherently
        # extends each detected segment by up to `order` hops (~0.12 s) on
        # both sides, so some spill is expected by construction.
        false_rate = (covered & ~voiced).sum() / max((~voiced).sum(), 1)
        assert false_rate < 0.45, false_rate
        assert len(filtered) == covered.sum()

    def test_pure_noise_rejected(self):
        fs = 8000
        rng = np.random.RandomState(3)
        noise = (rng.randn(fs) * 20).astype(np.float64)
        vad = LtsdVad()
        vad.init_params_by_noise(fs, noise)
        more_noise = rng.randn(fs * 2) * 20
        filtered, intervals = vad.filter(more_noise)
        assert len(filtered) == 0 or len(filtered) < len(more_noise) / 3

    def test_segment_hysteresis(self):
        scores = np.array([0., 5., 5., 12., 5., 0., 5., 5., 5., 0.])
        # lambda0=4, lambda1=10: first run contains a >10 frame, second not
        assert segment_intervals(scores, 4.0, 10.0) == [(1, 4)]

    def test_interval_sample_conversion(self):
        fs = 8000
        vad = LtsdVad()
        rng = np.random.RandomState(4)
        vad.init_params_by_noise(fs, rng.randn(fs) * 10)
        ws = vad.window_size
        assert ws == int(0.04644 * fs)


class TestNoiseReduction:
    """On-device spectral gate replacing the sox noiseprof/noisered
    shell-out (src/filters/noisered.py:21-38)."""

    FS = 8000

    def _tone_plus_noise(self, seed=5):
        rng = np.random.RandomState(seed)
        n = self.FS * 2
        t = np.arange(n) / self.FS
        tone = 4000 * np.sin(2 * np.pi * 1000 * t)
        noise = 400 * rng.randn(n)
        return tone, noise

    def _band_power(self, sig, lo, hi):
        spec = np.abs(np.fft.rfft(sig)) ** 2
        freqs = np.fft.rfftfreq(len(sig), 1 / self.FS)
        return spec[(freqs >= lo) & (freqs < hi)].sum()

    def test_zero_amount_is_passthrough(self):
        tone, noise = self._tone_plus_noise()
        nr = NoiseReduction(amount=0.0)
        nr.init_noise(self.FS, noise)
        out = nr.filter(self.FS, tone + noise)
        np.testing.assert_allclose(out, (tone + noise).astype(np.float32),
                                   rtol=0, atol=2.0)

    def test_full_subtraction_improves_snr(self):
        tone, noise = self._tone_plus_noise()
        rng = np.random.RandomState(6)
        fresh_noise = 400 * rng.randn(len(tone))
        nr = NoiseReduction(amount=1.0)
        nr.init_noise(self.FS, noise)
        out = nr.filter(self.FS, tone + fresh_noise)
        assert len(out) == len(tone)
        # noise-band (2.5-3.5 kHz, far from the tone) power drops hard
        before = self._band_power(tone + fresh_noise, 2500, 3500)
        after = self._band_power(out, 2500, 3500)
        assert after < before * 0.05, (after, before)
        # tone band survives
        tone_before = self._band_power(tone + fresh_noise, 950, 1050)
        tone_after = self._band_power(out, 950, 1050)
        assert tone_after > tone_before * 0.6, (tone_after, tone_before)

    def test_default_amount_mirrors_reference_thres(self):
        assert NoiseReduction().amount == pytest.approx(0.21)

    def test_requires_init(self):
        with pytest.raises(RuntimeError):
            NoiseReduction().filter(self.FS, np.zeros(1000))


class TestComposedVad:
    """VAD.py:13-34 composition: NR profile + LTSD, NR path opt-in."""

    def test_uninitialized_raises(self):
        with pytest.raises(RuntimeError):
            VAD().filter(8000, np.zeros(8000))

    def test_filter_with_and_without_nr(self):
        fs = 8000
        rng = np.random.RandomState(7)
        noise = rng.randn(fs) * 20
        from tests.test_vad import speech_with_silence
        sig, voiced = speech_with_silence(fs)
        sig = sig.astype(np.float64) + rng.randn(len(sig)) * 20
        for use_nr in (False, True):
            vad = VAD(use_noise_reduction=use_nr)
            vad.init_noise(fs, noise)
            filtered, intervals = vad.filter(fs, sig)
            assert len(intervals) >= 1
            covered = np.zeros(len(sig), dtype=bool)
            for s, e in intervals:
                covered[s:e] = True
            assert (covered & voiced).sum() / voiced.sum() > 0.6
