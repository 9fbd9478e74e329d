"""Compiled on the GPU: the batched extractor against the float64 oracles,
the serving program with each scoring, and one end-to-end enroll/predict.

A layout or numerics bug that only shows in compiled code (TF32 matmuls,
the Triton kernel) would ship unseen without this tier.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oracles import oracle_lpc, oracle_mfcc

from speaker_recognition.api import fastpath
from speaker_recognition.config import FeatureConfig, frame_geometry, n_frames
from speaker_recognition.features import extract
from speaker_recognition.models import gmm

pytestmark = pytest.mark.gpu

FS = 8000


def _speech(seconds, seed, freqs=(200, 600, 1500)):
    rng = np.random.RandomState(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    sig = sum(np.sin(2 * np.pi * f * t + rng.rand() * 6) / (i + 1)
              for i, f in enumerate(freqs))
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t) ** 2
    return ((sig + 0.05 * rng.randn(n)) * 8000).astype(np.float32)


def _padded_batch(sigs):
    L = max(len(s) for s in sigs)
    L = -(-L // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
    batch = np.zeros((len(sigs), L), np.float32)
    lengths = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
        lengths[i] = len(s)
    return jnp.asarray(batch), jnp.asarray(lengths)


def test_extract_batch_compiled_vs_f64_oracle():
    """The production extractor vs the loop-literal f64 oracle. Its
    matmuls request float32 products, so on the card (whose DEFAULT float32
    matmul is TF32) the features agree to float32 rounding, and a
    process-wide TF32 default does not change them."""
    sigs = [_speech(1.1, 0), _speech(0.8, 1, freqs=(150, 900))]
    batch, lengths = _padded_batch(sigs)
    fcfg = FeatureConfig()
    flen, fshift = frame_geometry(FS, 32, 16)
    oracles = [np.concatenate([
        oracle_mfcc(FS, s.astype(np.float64)),
        oracle_lpc(FS, s.astype(np.float64)),
    ], axis=1) for s in sigs]

    feats, mask = extract.extract_batch(batch, lengths, FS, fcfg)
    feats, mask = np.asarray(feats), np.asarray(mask)
    for i, s in enumerate(sigs):
        T = n_frames(len(s), flen, fshift)
        assert mask[i, :T].all() and not mask[i, T:].any()
        got = feats[i, :T]
        assert got.shape == oracles[i].shape
        err = np.abs(got - oracles[i])
        assert np.median(err[:, :13]) < 1e-4, np.median(err[:, :13])
        assert np.median(err[:, 13:]) < 5e-3, np.median(err[:, 13:])
        assert np.corrcoef(got.ravel(), oracles[i].ravel())[0, 1] > 0.99999

    with jax.default_matmul_precision("tensorfloat32"):
        feats_tf32, _ = extract.extract_batch(batch, lengths, FS, fcfg)
    np.testing.assert_array_equal(np.asarray(feats_tf32), feats)


@pytest.mark.parametrize("S,K", [(4, 32), (80, 256)])
def test_serving_program_kernel_vs_xla(S, K):
    """The compiled serving program with the kernel scoring vs with the
    XLA scoring, same features: both float32-class, near-equal scores,
    identical argmax."""
    fcfg = FeatureConfig()
    rng = np.random.RandomState(2)
    sigs = [_speech(1.0 + 0.2 * i, 10 + i) for i in range(6)]
    batch, lengths = _padded_batch(sigs)
    d = fcfg.dim
    bank = gmm.GmmParams(
        weights=jnp.asarray(np.full((S, K), 1 / K, np.float32)),
        means=jnp.asarray(rng.randn(S, K, d).astype(np.float32)),
        sigmas=jnp.asarray((0.5 + rng.rand(S, K, d)).astype(np.float32)))
    L = int(batch.shape[-1])
    got, v1 = fastpath.scores_fn(FS, fcfg, L, "float32", "kernel")(
        batch, lengths, bank)
    want, v2 = fastpath.scores_fn(FS, fcfg, L, "float32", "xla")(
        batch, lengths, bank)
    got, want = np.asarray(got), np.asarray(want)
    assert (np.asarray(v1) == np.asarray(v2)).all()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_enroll_predict_end_to_end_on_gpu():
    """Decision-level: enroll 3 synthetic speakers, predict held-out clips;
    every decision correct on the card, batched and serial."""
    from speaker_recognition.api.interface import ModelInterface

    bands = {"a": (150, 450, 1300), "b": (110, 700, 2100),
             "c": (220, 900, 3000)}
    mi = ModelInterface()
    for label, freqs in bands.items():
        for j in range(2):
            mi.enroll(label, FS, _speech(3.0, j, freqs))
    mi.train(seed=0)
    tests = [(label, _speech(2.0, 99, freqs))
             for label, freqs in bands.items()]
    got = mi.predict_batch(FS, [s for _, s in tests])
    assert got == [label for label, _ in tests]
    for label, s in tests:
        assert mi.predict(FS, s) == label
