"""Serial (one-utterance) scoring path regression tests (VERDICT r3 weak 1).

Pre-r4 the conversation-tick path (GMMSet._scores -> bank_avg_loglik) ran
UNJITTED: ~50 eager op dispatches per call, and the first call at every
distinct frame count T paid ~25 s of sequential sub-second op compiles
that the persistent compilation cache never stores. The fix buckets the
frame axis (SCORE_FRAME_BUCKET) and serves one jitted program; these
tests pin the two properties that make that fix real:

  1. padding+mask changes nothing numerically (vs the direct unpadded
     scoring program);
  2. distinct clip lengths inside one bucket share ONE compiled program
     (the jit cache grows by at most one entry per bucket, not per T).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.models import gmm
from speaker_recognition.models.gmmset import (
    GMMSet, SCORE_FRAME_BUCKET, _serial_scores)


@pytest.fixture(scope="module")
def trained_set():
    rng = np.random.RandomState(0)
    gs = GMMSet(gmm_order=8)
    for i, name in enumerate(["a", "b", "c"]):
        X = rng.randn(400, 12) * (1 + 0.2 * i) + i
        gs.fit_new(X, name)
    gs.train()
    return gs


def test_padded_scores_match_unpadded(trained_set):
    rng = np.random.RandomState(1)
    for T in (37, SCORE_FRAME_BUCKET - 1, SCORE_FRAME_BUCKET,
              SCORE_FRAME_BUCKET + 5):
        X = rng.randn(T, 12).astype(np.float32)
        got = trained_set._scores(X)
        bank = trained_set._device_bank()
        want = np.asarray(gmm.bank_avg_loglik(
            bank, jnp.asarray(X), jnp.ones(T, bool)))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_one_program_per_bucket(trained_set):
    rng = np.random.RandomState(2)
    trained_set._scores(rng.randn(10, 12).astype(np.float32))  # warm bucket 1
    before = _serial_scores._cache_size()
    # 5 distinct lengths inside the already-warm first bucket: no compiles
    for T in (11, 50, 99, 180, SCORE_FRAME_BUCKET):
        trained_set._scores(rng.randn(T, 12).astype(np.float32))
    assert _serial_scores._cache_size() == before, \
        "distinct in-bucket lengths must reuse one compiled program"
    # a bucket no prior test touched: exactly one new program
    trained_set._scores(
        rng.randn(2 * SCORE_FRAME_BUCKET + 1, 12).astype(np.float32))
    assert _serial_scores._cache_size() == before + 1


def test_llr_scores_single_program(trained_set):
    """llr_scores returns (scores, ubm scalar) from ONE jitted call and
    matches the separately computed quantities."""
    rng = np.random.RandomState(3)
    X = rng.randn(73, 12).astype(np.float32)
    ubm_params, _ = gmm.fit(jnp.asarray(rng.randn(500, 12), jnp.float32),
                            jnp.ones(500, bool),
                            dataclasses.replace(trained_set.config,
                                                n_mixtures=4),
                            jax.random.PRNGKey(0))
    trained_set.ubm = jax.tree.map(np.asarray, ubm_params)
    scores, ubm_score = trained_set.llr_scores(X)
    np.testing.assert_allclose(scores, trained_set._scores(X),
                               rtol=2e-5, atol=2e-5)
    bank_u = trained_set._device_ubm()
    want_u = float(gmm.avg_loglik(bank_u, jnp.asarray(X),
                                  jnp.ones(73, bool)))
    assert ubm_score == pytest.approx(want_u, rel=2e-5, abs=2e-5)


def test_warmup_precompiles_buckets():
    """ModelInterface.warmup compiles the serving programs for the given
    durations so the first real predict at those lengths is a cache hit
    (cold-start cost moved to startup)."""
    import scipy.io.wavfile  # noqa: F401  (keep import surface identical)
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.config import PipelineConfig

    rng = np.random.RandomState(0)
    m = ModelInterface(PipelineConfig())
    fs = 8000
    for name, f0 in [("a", 150.0), ("b", 110.0)]:
        t = np.arange(fs * 8) / fs
        sig = (np.sin(2 * np.pi * f0 * t) * 9000).astype(np.int16)
        m.enroll(name, fs, sig)
    m.train()
    m.warmup(fs, durations=(1.5, 3.0), batch_sizes=(1,))
    # post-warmup predicts at those durations must not error and must
    # return a valid label
    for dur in (1.5, 3.0):
        t = np.arange(int(fs * dur)) / fs
        clip = (np.sin(2 * np.pi * 150.0 * t) * 9000).astype(np.int16)
        assert m.predict(fs, clip) in ("a", "b")
