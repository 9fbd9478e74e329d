"""Differential tests against the reference's actual C++ nn core (CRBM/RBM).

Analogous to test_differential_reference.py for the GMM core: the ORIGINAL
implementation (src/nn/src/{crbm,rbm}.cc) is built out-of-tree with a thin
C shim (tests/ref_nn_shim.cc, via tests/refbuild.py) and driven through
ctypes. Training is stochastic on both sides, so parity is pinned on the
DETERMINISTIC surfaces the reference exposes:

  * CRBM::reconstruction_error — a noise-free up-down pass
    (crbm.cc:186-199) — must agree to f64 rounding on models exchanged in
    the reference text format, in BOTH directions;
  * the argmin-reconstruction-error speaker decision
    (src/nn/src/main.cc:453-465) on a bank of reference-trained models;
  * RBM hidden/visible activation probabilities (rbm.cc:138-157) on models
    exchanged via RBM::dump/load text format.
"""

import ctypes
import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest

from speaker_recognition.models import crbm as crbm_mod
from speaker_recognition.models import rbm as rbm_mod
from speaker_recognition.utils import serialization

import sys
sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
import refbuild

REF_LIB = refbuild.ensure_refnn()

pytestmark = pytest.mark.skipif(
    REF_LIB is None,
    reason="reference nn core not buildable (missing checkout or g++)")


def _lib():
    lib = ctypes.CDLL(REF_LIB)
    lib.crbm_new.restype = ctypes.c_void_p
    lib.crbm_load.restype = ctypes.c_void_p
    lib.crbm_reconstruction_error.restype = ctypes.c_double
    lib.crbm_visible_size.restype = ctypes.c_int
    lib.crbm_hidden_size.restype = ctypes.c_int
    lib.rbm_new.restype = ctypes.c_void_p
    lib.rbm_load.restype = ctypes.c_void_p
    return lib


def _flat(X):
    X = np.ascontiguousarray(X, np.float64)
    return X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), X


class RefCrbm:
    def __init__(self, handle=None, lib=None):
        self.lib = lib or _lib()
        self.h = handle

    @classmethod
    def train(cls, X, nh, epochs=40, lr=0.1, batch=None, cd_k=1,
              C=0.001, momentum=0.9, seed=7):
        self = cls(None)
        self.h = self.lib.crbm_new(nh)
        ptr, keep = _flat(X)
        self.lib.crbm_train(ctypes.c_void_p(self.h), ptr, X.shape[0],
                            X.shape[1], ctypes.c_double(lr), epochs,
                            batch or X.shape[0], cd_k, ctypes.c_double(C),
                            ctypes.c_double(momentum),
                            ctypes.c_ulonglong(seed))
        return self

    @classmethod
    def load(cls, path):
        self = cls(None)
        self.h = self.lib.crbm_load(path.encode())
        return self

    def dump(self, path):
        self.lib.crbm_dump(ctypes.c_void_p(self.h), path.encode())

    def reconstruction_error(self, X):
        ptr, keep = _flat(X)
        return self.lib.crbm_reconstruction_error(
            ctypes.c_void_p(self.h), ptr, X.shape[0], X.shape[1])

    def reconstruct_det(self, v):
        v = np.ascontiguousarray(v, np.float64)
        out = np.zeros_like(v)
        self.lib.crbm_reconstruct_det(
            ctypes.c_void_p(self.h),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v))
        return out


def _synth_features(n, d, seed):
    """Smooth bounded data resembling CMVN'd cepstra (the CRBM input)."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, d)
    return np.tanh(base + 0.6 * rng.randn(n, d))


def _ours_recon_error(params, X):
    Xj = jnp.asarray(X, jnp.float64)
    mask = jnp.ones(X.shape[0], bool)
    return float(crbm_mod.reconstruction_error(params, Xj, mask))


def test_reference_trained_crbm_scores_identically(tmp_path):
    """Reference-trained model -> our loader: deterministic reconstruction
    error and elementwise reconstruction agree to f64 rounding."""
    X = _synth_features(300, 13, seed=0)
    ref = RefCrbm.train(X, nh=8, epochs=30, seed=11)
    path = str(tmp_path / "ref.model")
    ref.dump(path)

    with open(path) as f:
        ours = serialization.load_reference_crbm(f)
    ours = type(ours)(*[jnp.asarray(v, jnp.float64) for v in ours])

    Xtest = _synth_features(120, 13, seed=1)
    ref_err = ref.reconstruction_error(Xtest)
    our_err = _ours_recon_error(ours, Xtest)
    # text format carries 10 decimals; error is a sum of ~1.5k squares
    np.testing.assert_allclose(our_err, ref_err, rtol=1e-7)

    v = Xtest[0]
    np.testing.assert_allclose(
        np.asarray(crbm_mod.sample_visible(
            ours, crbm_mod.sample_hidden(ours, jnp.asarray(v[None]))))[0],
        ref.reconstruct_det(v), rtol=1e-8, atol=1e-10)


def test_our_trained_crbm_loads_in_reference(tmp_path):
    """Our trainer -> reference loader: the reference computes the same
    deterministic reconstruction error on our model."""
    import jax

    X = _synth_features(256, 13, seed=2)
    cfg = crbm_mod.CrbmTrainConfig(n_epochs=25, batch_size=64)
    params = crbm_mod.fit(jnp.asarray(X, jnp.float64),
                          jnp.ones(X.shape[0], bool), 8, cfg,
                          jax.random.PRNGKey(0))
    path = str(tmp_path / "ours.model")
    with open(path, "w") as f:
        serialization.dump_reference_crbm(params, f)

    ref = RefCrbm.load(path)
    Xtest = _synth_features(90, 13, seed=3)
    np.testing.assert_allclose(_ours_recon_error(params, Xtest),
                               ref.reconstruction_error(Xtest), rtol=1e-7)


def test_argmin_decisions_match_reference_bank(tmp_path):
    """3 reference-trained speaker models; both sides classify the same test
    segments by argmin reconstruction error (main.cc:453-465) and must agree
    on every decision AND on the error values."""
    S, d = 3, 13
    refs, ours = [], []
    for s in range(S):
        X = _synth_features(250, d, seed=10 + s)
        r = RefCrbm.train(X, nh=6, epochs=25, seed=100 + s)
        path = str(tmp_path / f"spk{s}.model")
        r.dump(path)
        with open(path) as f:
            p = serialization.load_reference_crbm(f)
        ours.append(type(p)(*[jnp.asarray(v, jnp.float64) for v in p]))
        refs.append(r)

    bank = crbm_mod.CrbmParams(*[jnp.stack([getattr(p, f) for p in ours])
                                 for f in crbm_mod.CrbmParams._fields])
    n_agree = 0
    for t in range(6):
        Xt = _synth_features(80, d, seed=40 + t)
        ref_errs = np.array([r.reconstruction_error(Xt) for r in refs])
        our_errs = np.asarray(crbm_mod.bank_reconstruction_errors(
            bank, jnp.asarray(Xt, jnp.float64),
            jnp.ones(Xt.shape[0], bool)))
        np.testing.assert_allclose(our_errs, ref_errs, rtol=1e-7)
        assert int(our_errs.argmin()) == int(ref_errs.argmin())
        n_agree += 1
    assert n_agree == 6


def test_rbm_probabilities_match_reference(tmp_path):
    """Our RBM -> reference text format -> reference's deterministic
    hidden/visible activation probabilities (rbm.cc:138-157)."""
    import jax

    rng = np.random.RandomState(5)
    X = (rng.rand(200, 12) > 0.5).astype(np.float64)
    cfg = rbm_mod.RbmTrainConfig(n_epochs=10, batch_size=50)
    params = rbm_mod.fit(jnp.asarray(X, jnp.float64), 7, cfg,
                         jax.random.PRNGKey(1))

    # RBM::dump format (rbm.cc:254-267): nv nh / vb / hb / w rows
    vb = np.asarray(params.vb, np.float64)
    hb = np.asarray(params.hb, np.float64)
    w = np.asarray(params.w, np.float64)
    path = str(tmp_path / "rbm.model")
    with open(path, "w") as f:
        f.write(f"{w.shape[0]} {w.shape[1]}\n")
        f.write(" ".join(f"{v:.10f}" for v in vb) + " \n")
        f.write(" ".join(f"{v:.10f}" for v in hb) + " \n")
        for row in w:
            f.write(" ".join(f"{v:.10f}" for v in row) + " \n")

    lib = _lib()
    h = lib.rbm_load(path.encode())
    v = X[0]
    p_ref = np.zeros(w.shape[1])
    lib.rbm_hidden_prob(ctypes.c_void_p(h),
                        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        p_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    p_ours = 1.0 / (1.0 + np.exp(-(v @ w + hb)))
    np.testing.assert_allclose(p_ours, p_ref, rtol=1e-8, atol=1e-10)

    hid = p_ours
    pv_ref = np.zeros(w.shape[0])
    lib.rbm_visible_prob(ctypes.c_void_p(h),
                         hid.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         pv_ref.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    pv_ours = 1.0 / (1.0 + np.exp(-(hid @ w.T + vb)))
    np.testing.assert_allclose(pv_ours, pv_ref, rtol=1e-8, atol=1e-10)
    lib.rbm_free(ctypes.c_void_p(h))
