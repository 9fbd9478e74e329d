"""Sequence-sharded extraction must reproduce the single-device features
exactly (halo exchange + psum CMVN)."""

import numpy as np
import jax
import pytest

from speaker_recognition.config import FeatureConfig
from speaker_recognition.features import extract
from speaker_recognition.parallel import mesh as pmesh
from speaker_recognition.parallel.seqshard import sharded_mix_feature

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")


def long_signal(seconds=20, fs=8000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(fs * seconds)) / fs
    sig = (np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 880 * t)
           + 0.05 * rng.randn(len(t)))
    return (sig * 8000).astype(np.int16)


class TestSeqShard:
    def test_matches_single_device(self):
        fs = 8000
        sig = long_signal(20)
        cfg = FeatureConfig()
        m = pmesh.make_mesh(data=8, bank=1)
        out = sharded_mix_feature(m, fs, sig, cfg, dtype="float32")
        ref = extract.mix_feature(fs, sig, cfg, dtype="float32")
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    def test_ragged_length(self):
        """Length not divisible by shards*shift: trailing frames masked."""
        fs = 8000
        sig = long_signal(13)[: 8000 * 13 - 777]
        cfg = FeatureConfig(use_lpc=False)
        m = pmesh.make_mesh(data=8, bank=1)
        out = sharded_mix_feature(m, fs, sig, cfg, dtype="float32")
        ref = extract.mix_feature(fs, sig, cfg, dtype="float32")
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
