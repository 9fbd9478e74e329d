"""Fused bank-scoring kernel (Triton route, interpret mode on CPU) vs the
XLA reference, plus the wrapper's padding, block choice and serving rule."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.models import gmm
from speaker_recognition.ops import pallas_gmm


def make_bank(S=10, K=32, d=28, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.rand(S, K) + 0.1
    w /= w.sum(axis=1, keepdims=True)
    return gmm.GmmParams(jnp.asarray(w, jnp.float32),
                         jnp.asarray(rng.randn(S, K, d), jnp.float32),
                         jnp.asarray(0.5 + rng.rand(S, K, d), jnp.float32))


def vmapped(bank, feats, mask):
    return np.asarray(jax.vmap(
        lambda X, m: gmm.bank_avg_loglik(bank, X, m))(feats, mask))


def kernel(bank, feats, mask):
    return np.asarray(pallas_gmm.batch_bank_avg_loglik(
        bank, feats, mask, interpret=True))


class TestPallasBankScores:
    """One utterance (a batch of one) against the bank."""

    def test_matches_xla_reference(self):
        bank = make_bank()
        rng = np.random.RandomState(1)
        X = jnp.asarray(rng.randn(1, 700, 28), jnp.float32)
        mask = jnp.asarray(np.arange(700) < 650)[None]
        np.testing.assert_allclose(kernel(bank, X, mask),
                                   vmapped(bank, X, mask),
                                   rtol=2e-5, atol=2e-5)

    def test_speaker_padding(self):
        # S=3 pads to a speaker block of 4 and K=8 to 16 components, d=12
        # to 16: padded speakers and components must not leak
        bank = make_bank(S=3, K=8, d=12, seed=2)
        rng = np.random.RandomState(3)
        X = jnp.asarray(rng.randn(1, 100, 12), jnp.float32)
        mask = jnp.ones((1, 100), dtype=bool)
        out = kernel(bank, X, mask)
        assert out.shape == (1, 3)
        np.testing.assert_allclose(out, vmapped(bank, X, mask),
                                   rtol=2e-5, atol=2e-5)

    def test_all_masked_frames(self):
        bank = make_bank(S=2, K=8, d=4, seed=4)
        X = jnp.zeros((1, 64, 4), jnp.float32)
        mask = jnp.zeros((1, 64), dtype=bool)
        np.testing.assert_array_equal(kernel(bank, X, mask), 0.0)

    def test_argmax_decisions_match(self):
        bank = make_bank(S=16, K=16, d=20, seed=5)
        rng = np.random.RandomState(6)
        X = jnp.asarray(np.stack([
            rng.randn(300, 20) + np.asarray(bank.means[i, 0])
            for i in range(3)]), jnp.float32)
        mask = jnp.ones((3, 300), dtype=bool)
        assert (kernel(bank, X, mask).argmax(-1)
                == vmapped(bank, X, mask).argmax(-1)).all()


class TestWideBatchScoring:
    """The wide batch-level scoring programs: all utterances' frames in
    the matmul M dimension, all (speaker, component) pairs in N. Both the
    XLA program and the kernel must equal the per-utterance reference."""

    def _batch(self, B=5, T=200, d=28, seed=7):
        rng = np.random.RandomState(seed)
        feats = jnp.asarray(rng.randn(B, T, d), jnp.float32)
        lengths = rng.randint(2, T + 1, size=B)
        lengths[0] = T
        mask = jnp.asarray(np.arange(T)[None, :] < lengths[:, None])
        return feats, mask

    def test_xla_wide_matches_vmapped(self):
        bank = make_bank()
        feats, mask = self._batch()
        out = gmm.batch_bank_avg_loglik(bank, feats, mask)
        np.testing.assert_allclose(np.asarray(out), vmapped(bank, feats, mask),
                                   rtol=2e-5, atol=2e-5)

    def test_pallas_wide_matches_vmapped(self):
        bank = make_bank(S=6, K=16, d=12, seed=8)
        feats, mask = self._batch(B=4, T=150, d=12, seed=9)
        np.testing.assert_allclose(kernel(bank, feats, mask),
                                   vmapped(bank, feats, mask),
                                   rtol=2e-5, atol=2e-5)

    def test_pallas_wide_zero_length_utterance(self):
        # an all-masked utterance averages to 0.0 (n floored at 1), like
        # the XLA path; frame blocks span utterance boundaries here
        bank = make_bank(S=2, K=8, d=6, seed=10)
        rng = np.random.RandomState(11)
        feats = jnp.asarray(rng.randn(3, 70, 6), jnp.float32)
        mask = jnp.asarray(np.stack([np.ones(70, bool),
                                     np.zeros(70, bool),
                                     np.arange(70) < 7]))
        out = kernel(bank, feats, mask)
        assert np.all(out[1] == 0.0)
        np.testing.assert_allclose(out[[0, 2]],
                                   vmapped(bank, feats, mask)[[0, 2]],
                                   rtol=2e-5, atol=2e-5)

    def test_xla_wide_underflow_floor(self):
        # a frame far from every component underflows the linear sum ->
        # the reference's 1e-15 floor engages identically in both paths
        bank = make_bank(S=2, K=4, d=4, seed=12)
        feats = jnp.asarray(np.full((1, 8, 4), 80.0), jnp.float32)
        mask = jnp.ones((1, 8), bool)
        out = gmm.batch_bank_avg_loglik(bank, feats, mask)
        np.testing.assert_allclose(np.asarray(out), vmapped(bank, feats, mask),
                                   rtol=1e-6)


@pytest.mark.parametrize("S,K,d", [(4, 32, 28), (3, 8, 28), (80, 256, 28),
                                   (4, 32, 84)])
def test_kernel_matches_xla_batch_scoring(S, K, d):
    """Kernel vs gmm.batch_bank_avg_loglik at the served widths (headline
    bank, odd small bank, UBM-scale bank, deltas), ragged masks, frames not
    a multiple of the frame block."""
    rng = np.random.RandomState(S + K + d)
    bank = make_bank(S=S, K=K, d=d, seed=S * K)
    B, T = 3, 45                         # 135 frames: the 2nd block ragged
    feats = jnp.asarray(rng.randn(B, T, d), jnp.float32)
    mask = jnp.asarray(np.arange(T)[None, :] < np.array([[45], [30], [1]]))
    want = np.asarray(gmm.batch_bank_avg_loglik(bank, feats, mask))
    np.testing.assert_allclose(kernel(bank, feats, mask), want,
                               rtol=2e-5, atol=2e-4)


def test_kernel_underflow_floor():
    """Frames whose log-density is below the float64 underflow point score
    the reference's log(1e-15) floor, in the kernel as in XLA."""
    bank = make_bank(S=2, K=4, d=4, seed=12)
    feats = jnp.asarray(np.full((2, 8, 4), 80.0), jnp.float32)
    mask = jnp.ones((2, 8), bool)
    out = kernel(bank, feats, mask)
    np.testing.assert_allclose(out, np.log(1e-15), rtol=1e-6)
    np.testing.assert_allclose(out, vmapped(bank, feats, mask), rtol=1e-6)


def test_frame_speaker_lse_matches_logsumexp():
    bank = make_bank(S=5, K=16, d=10, seed=13)
    X = jnp.asarray(np.random.RandomState(14).randn(77, 10), jnp.float32)
    got = np.asarray(pallas_gmm.frame_speaker_lse(bank, X, 16,
                                                  interpret=True))
    want = np.stack([np.asarray(jax.scipy.special.logsumexp(
        gmm.log_joint(gmm.GmmParams(*(a[s] for a in bank)), X), axis=-1))
        for s in range(5)])
    assert got.shape == (5, 77)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,S,K,d,want", [
    (163328, 4, 32, 28, dict(dp=32, kp=32, kb=32, sb=4, bn=128,
                             s_pad=4, n_pad=163328)),
    (40832, 80, 256, 28, dict(dp=32, kp=256, kb=32, sb=4, bn=128,
                              s_pad=80, n_pad=40832)),
    (135, 3, 8, 84, dict(dp=128, kp=16, kb=16, sb=4, bn=128,
                         s_pad=4, n_pad=256)),
    (20, 1, 5, 3, dict(dp=16, kp=16, kb=16, sb=1, bn=32,
                       s_pad=1, n_pad=32)),
])
def test_block_config(n, S, K, d, want):
    """Padding and block choice: every block dim a power of two, frames
    and speakers padded to whole blocks, K and d to Triton's minimum 16."""
    assert pallas_gmm.block_config(n, S, K, d) == want


def test_use_kernel_rule(monkeypatch):
    """The kernel serves every f32 bank, only where the backend has it,
    unless SRTPU_PALLAS=off."""
    monkeypatch.delenv("SRTPU_PALLAS", raising=False)
    assert not pallas_gmm.kernel_available()        # CPU test backend
    assert not pallas_gmm.use_kernel()
    monkeypatch.setattr(pallas_gmm, "kernel_available", lambda: True)
    assert pallas_gmm.use_kernel()
    assert pallas_gmm.use_kernel(jnp.float32)
    assert not pallas_gmm.use_kernel(dtype="float64")
    monkeypatch.setenv("SRTPU_PALLAS", "off")
    assert not pallas_gmm.use_kernel()


@pytest.mark.parametrize("mode", ["on", "interpret", "1"])
def test_srtpu_pallas_rejects_other_modes(monkeypatch, mode):
    """SRTPU_PALLAS keeps only auto|off: asking for the kernel where it
    cannot run raises instead of serving another program."""
    monkeypatch.setenv("SRTPU_PALLAS", mode)
    with pytest.raises(ValueError, match="SRTPU_PALLAS"):
        pallas_gmm.use_kernel()


def test_split_tf32_is_exact():
    """hi keeps 10 mantissa bits (low 13 cleared), hi + lo == x exactly,
    and lo is small enough that TF32 rounding of it costs ~2^-21."""
    x = jnp.asarray(np.random.RandomState(15).randn(1000) * 1e3,
                    jnp.float32)
    hi, lo = pallas_gmm.split_tf32(x)
    bits = np.asarray(hi).view(np.uint32)
    assert (bits & 0x1FFF == 0).all()
    np.testing.assert_array_equal(np.asarray(hi + lo), np.asarray(x))
    assert (np.abs(np.asarray(lo)) <= np.abs(np.asarray(x)) * 2.0 ** -10).all()
