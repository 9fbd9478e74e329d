"""api/fastpath serving-program tests (kernel in interpret mode on CPU).

Each scoring of the serving program must produce the same scores as the
reference composition extract_batch + models/gmm.bank_avg_loglik, with
identical argmax decisions; scores_batch serves the kernel only where
pallas_gmm.use_kernel allows it.
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.api import fastpath
from speaker_recognition.config import FeatureConfig
from speaker_recognition.features import extract
from speaker_recognition.models import gmm
from speaker_recognition.ops import pallas_gmm

FS = 8000


def _batch(B=6, lo=0.7, hi=1.0, seed=0, padded=8192):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(int(lo * FS), int(hi * FS), size=B)
    signals = np.zeros((B, padded), np.float32)
    for i, L in enumerate(lengths):
        signals[i, :L] = (rng.randn(L) * 3000).astype(np.float32)
    return jnp.asarray(signals), jnp.asarray(lengths.astype(np.int32))


def _bank(S, K, d, seed=1):
    rng = np.random.RandomState(seed)
    return gmm.GmmParams(
        weights=jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        means=jnp.asarray(rng.randn(S, K, d).astype(np.float32)),
        sigmas=jnp.asarray((0.5 + rng.rand(S, K, d)).astype(np.float32)))


def _want(signals, lengths, bank, fcfg):
    feats, mask = extract._feature_fn(
        FS, fcfg, int(signals.shape[-1]), "float32")(signals, lengths)
    return np.asarray(jax.vmap(
        lambda X, m: gmm.bank_avg_loglik(bank, X, m))(feats, mask))


@pytest.mark.parametrize("scoring,S,K", [
    ("xla", 4, 32),
    ("kernel", 4, 32),
    ("xla", 3, 8),
    ("kernel", 3, 8),
    ("kernel", 6, 64),
])
def test_variants_agree(scoring, S, K):
    fcfg = FeatureConfig()
    signals, lengths = _batch()
    bank = _bank(S, K, fcfg.dim)
    want = _want(signals, lengths, bank, fcfg)

    fn = fastpath.scores_fn(FS, fcfg, int(signals.shape[-1]), "float32",
                            scoring, interpret=True)
    got, valid = fn(signals, lengths, bank)
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.asarray(valid).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_fused_scores_dispatch_contract(monkeypatch):
    """use_kernel: XLA on a backend without the kernel, for float64 and
    under SRTPU_PALLAS=off; the kernel for any float32 bank where the
    backend has it; unknown scorings and SRTPU_PALLAS values raise."""
    monkeypatch.delenv("SRTPU_PALLAS", raising=False)
    assert not pallas_gmm.use_kernel()                   # CPU backend
    monkeypatch.setattr(pallas_gmm, "kernel_available", lambda: True)
    assert pallas_gmm.use_kernel()
    assert not pallas_gmm.use_kernel("float64")
    monkeypatch.setenv("SRTPU_PALLAS", "off")
    assert not pallas_gmm.use_kernel()
    monkeypatch.setenv("SRTPU_PALLAS", "on")
    with pytest.raises(ValueError, match="SRTPU_PALLAS"):
        pallas_gmm.use_kernel()
    with pytest.raises(ValueError, match="unknown scoring"):
        fastpath.scores_fn(FS, FeatureConfig(), 8192, "float32", "pallas")


def test_predict_batch_uses_fastpath(monkeypatch):
    """ModelInterface.predict_batch returns identical labels through the
    kernel scoring (interpret) and the XLA scoring."""
    sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
    from test_endtoend import SPEAKER_FREQS, synth_utterance
    from speaker_recognition.api.interface import ModelInterface

    mi = ModelInterface()
    for label in SPEAKER_FREQS:
        mi.enroll(label, FS, synth_utterance(label, 3.0, seed=0))
    mi.train(seed=0)
    tests = [synth_utterance(label, 1.5, seed=9) for label in SPEAKER_FREQS]

    want = mi.predict_batch(FS, tests)
    want_scores, _ = mi.scores_batch(FS, tests)
    chosen = []
    monkeypatch.setattr(pallas_gmm, "use_kernel",
                        lambda *a, **k: chosen.append(a) or True)
    monkeypatch.setattr(fastpath, "scores_fn", functools.partial(
        fastpath.scores_fn, interpret=True))
    got = mi.predict_batch(FS, tests)
    got_scores, _ = mi.scores_batch(FS, tests)
    assert chosen == [("float32",)] * 2
    assert got == want == list(SPEAKER_FREQS)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-4)


def test_srtpu_pallas_on_raises_in_scores_batch(monkeypatch):
    """SRTPU_PALLAS=on on a backend without the kernel is an error at the
    serving entry point, not a silent XLA answer."""
    from speaker_recognition.api.interface import ModelInterface
    from speaker_recognition.models.gmmset import GMMSet

    mi = ModelInterface()
    mi.gmmset = GMMSet(gmm_order=8)
    mi.gmmset.y = ["a", "b"]
    mi.gmmset.bank = jax.tree.map(np.asarray, _bank(2, 8, 28))
    signals, _ = _batch(B=1)
    monkeypatch.setenv("SRTPU_PALLAS", "on")
    with pytest.raises(ValueError, match="SRTPU_PALLAS"):
        mi.scores_batch(FS, [np.asarray(signals[0])])
