"""Differential tests against the reference's actual C++ GMM core.

These tests drive the ORIGINAL implementation (built out-of-tree from the
read-only reference checkout) through its extern "C" ABI (pygmm.hh) and
compare numerics and decisions with this framework — the strongest form of
parity evidence (SURVEY.md section 4.2 "differential testing of the native
core").

Build the reference core once (not part of this repo; skipped when absent):
    cp -r /root/reference/src/gmm /tmp/refgmm && make -C /tmp/refgmm

Covered:
  * per-frame log-likelihood of the same text model on the same frames
    (reference fast-exp scorer vs our logsumexp matmuls)
  * models trained by the reference score identically under our scorer
    (text-format interchange both ways)
  * closed-set decisions agree on a 3-speaker bank trained by the reference
  * MAP adaptation from a shared UBM — deterministic (no RNG on this path),
    so our EM must reproduce the reference means to fp tolerance
"""

import ctypes
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.config import GmmConfig
from speaker_recognition.models import gmm
from speaker_recognition.utils import serialization

import sys

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
import refbuild

REF_LIB = refbuild.ensure_refgmm() or refbuild.REFGMM_LIB

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_LIB),
    reason="reference pygmm.so not buildable (see module docstring)")


class _Parameter(ctypes.Structure):
    # mirrors struct Parameter, src/gmm/src/pygmm.hh:12-26
    _fields_ = [
        ("nr_instance", ctypes.c_int),
        ("nr_dim", ctypes.c_int),
        ("nr_mixture", ctypes.c_int),
        ("min_covar", ctypes.c_double),
        ("threshold", ctypes.c_double),
        ("nr_iteration", ctypes.c_int),
        ("init_with_kmeans", ctypes.c_int),
        ("concurrency", ctypes.c_int),
        ("verbosity", ctypes.c_int),
    ]


class RefGmm:
    """Minimal ctypes driver for the reference C ABI."""

    def __init__(self):
        lib = ctypes.CDLL(REF_LIB)
        lib.new_gmm.restype = ctypes.c_void_p
        lib.load.restype = ctypes.c_void_p
        lib.score_all.restype = ctypes.c_double
        lib.score_instance.restype = ctypes.c_double
        lib.get_nr_mixtures.restype = ctypes.c_int
        self.lib = lib

    @staticmethod
    def _rows(X):
        X = np.ascontiguousarray(X, np.float64)
        n = X.shape[0]
        ptrs = (ctypes.POINTER(ctypes.c_double) * n)()
        for i in range(n):
            ptrs[i] = X[i].ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        return ptrs, X  # keep X alive

    def train(self, X, K, iters, kmeans=0, min_covar=1e-3, threshold=0.01):
        p = _Parameter(nr_instance=X.shape[0], nr_dim=X.shape[1],
                       nr_mixture=K, min_covar=min_covar, threshold=threshold,
                       nr_iteration=iters, init_with_kmeans=kmeans,
                       concurrency=1, verbosity=0)
        g = self.lib.new_gmm(K, 1)  # COVTYPE_DIAGONAL
        ptrs, keep = self._rows(X)
        self.lib.train_model(ctypes.c_void_p(g), ptrs, ctypes.byref(p))
        return g

    def train_from_ubm(self, ubm_handle, X, K, iters, min_covar=1e-3,
                       threshold=0.01):
        p = _Parameter(nr_instance=X.shape[0], nr_dim=X.shape[1],
                       nr_mixture=K, min_covar=min_covar, threshold=threshold,
                       nr_iteration=iters, init_with_kmeans=0,
                       concurrency=1, verbosity=0)
        g = self.lib.new_gmm(K, 1)
        ptrs, keep = self._rows(X)
        self.lib.train_model_from_ubm(ctypes.c_void_p(g),
                                      ctypes.c_void_p(ubm_handle), ptrs,
                                      ctypes.byref(p))
        return g

    def dump(self, handle, path):
        self.lib.dump(ctypes.c_void_p(handle), path.encode())

    def load(self, path):
        return self.lib.load(path.encode())

    def score_all(self, handle, X):
        ptrs, keep = self._rows(X)
        return float(self.lib.score_all(ctypes.c_void_p(handle), ptrs,
                                        X.shape[0], X.shape[1], 1))

    def score_batch(self, handle, X):
        ptrs, keep = self._rows(X)
        out = np.zeros(X.shape[0], np.float64)
        self.lib.score_batch(ctypes.c_void_p(handle), ptrs,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             X.shape[0], X.shape[1], 1)
        return out


@pytest.fixture(scope="module")
def ref():
    return RefGmm()


def blobs(n=600, d=5, K=3, seed=0, spread=0.5):
    rng = np.random.RandomState(seed)
    mu = rng.randn(K, d) * 3
    comps = rng.randint(0, K, n)
    return mu[comps] + rng.randn(n, d) * spread


def to_jax(params):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


class TestScoringParity:
    def test_reference_model_scores_identically_under_our_scorer(self, ref, tmp_path):
        X = blobs(seed=1)
        h = ref.train(X, K=4, iters=20)
        model_path = str(tmp_path / "ref.model")
        ref.dump(h, model_path)

        with open(model_path) as f:
            ours = serialization.load_reference_gmm(f)
        ours = to_jax(ours)

        ref_frames = ref.score_batch(h, X)
        our_frames = np.asarray(gmm.per_frame_loglik(ours, jnp.asarray(X)))
        np.testing.assert_allclose(our_frames, ref_frames, rtol=1e-5, atol=1e-6)

        ref_total = ref.score_all(h, X)
        our_total = float(gmm.total_loglik(ours, jnp.asarray(X),
                                           jnp.ones(len(X), dtype=bool)))
        np.testing.assert_allclose(our_total, ref_total, rtol=1e-6)

    def test_our_model_scores_identically_under_reference_scorer(self, ref, tmp_path):
        X = blobs(seed=2)
        cfg = GmmConfig(n_mixtures=4, n_iterations=20)
        params, _ = gmm.fit(jnp.asarray(X), jnp.ones(len(X), dtype=bool), cfg,
                            jax.random.PRNGKey(0))
        model_path = str(tmp_path / "ours.model")
        with open(model_path, "w") as f:
            serialization.dump_reference_gmm(jax.tree.map(np.asarray, params), f)

        h = ref.load(model_path)
        ref_frames = ref.score_batch(h, X)
        our_frames = np.asarray(gmm.per_frame_loglik(to_jax(params),
                                                     jnp.asarray(X)))
        np.testing.assert_allclose(our_frames, ref_frames, rtol=1e-5, atol=1e-6)


class TestDecisionParity:
    def test_closed_set_decisions_agree(self, ref, tmp_path, monkeypatch):
        # the reference trainer writes gmm-training-intermediate-dump.model
        # into the CWD (gmm.cc:622-630) — keep it out of the repo
        monkeypatch.chdir(tmp_path)
        rng = np.random.RandomState(3)
        banks = []
        ours = []
        for s in range(3):
            Xs = blobs(n=500, seed=10 + s)
            h = ref.train(Xs, K=4, iters=30)
            banks.append(h)
            p = str(tmp_path / f"s{s}.model")
            ref.dump(h, p)
            with open(p) as f:
                ours.append(to_jax(serialization.load_reference_gmm(f)))

        agree = 0
        for t in range(12):
            test = blobs(n=80, seed=100 + t)
            ref_scores = [ref.score_all(h, test) / len(test) for h in banks]
            our_scores = [float(gmm.avg_loglik(p, jnp.asarray(test),
                                               jnp.ones(len(test), dtype=bool)))
                          for p in ours]
            # the reference scores through its Remez-5 fast-exp (~1e-7
            # relative error per term), so scores agree to ~1e-6 relative
            np.testing.assert_allclose(our_scores, ref_scores, rtol=1e-5)
            agree += int(np.argmax(ref_scores)) == int(np.argmax(our_scores))
        assert agree == 12

    def test_map_adaptation_matches_reference_exactly(self, ref, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        """The MAP path has no RNG (init = UBM copy), so given the same UBM
        and data our EM must reproduce the reference's adapted means."""
        Xbg = blobs(n=800, seed=4)
        ubm_h = ref.train(Xbg, K=4, iters=30)
        ubm_path = str(tmp_path / "ubm.model")
        ref.dump(ubm_h, ubm_path)
        with open(ubm_path) as f:
            ubm_ours = to_jax(serialization.load_reference_gmm(f))

        Xspk = blobs(n=300, seed=5) + 0.5
        iters = 7
        # adapt from the RE-LOADED ubm on both sides: the text dump carries
        # only 6 significant digits (default ostream precision, gmm.cc:655),
        # and EM amplifies a 1e-6 UBM perturbation past tolerance over
        # several iterations — both sides must start from identical bits
        ubm_h2 = ref.load(ubm_path)
        adapted_h = ref.train_from_ubm(ubm_h2, Xspk, K=4, iters=iters,
                                       threshold=1e-12)
        adapted_path = str(tmp_path / "adapted.model")
        ref.dump(adapted_h, adapted_path)
        with open(adapted_path) as f:
            ref_adapted = serialization.load_reference_gmm(f)

        cfg = GmmConfig(n_mixtures=4, n_iterations=iters, threshold=1e-12)
        ours_adapted, _ = gmm.fit_from_ubm(
            jnp.asarray(Xspk), jnp.ones(len(Xspk), dtype=bool), ubm_ours, cfg)

        np.testing.assert_allclose(np.asarray(ours_adapted.means),
                                   ref_adapted.means, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ours_adapted.weights),
                                   ref_adapted.weights, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ours_adapted.sigmas),
                                   ref_adapted.sigmas, rtol=1e-6)
