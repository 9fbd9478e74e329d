"""GMM/EM parity tests vs the float64 NumPy oracle (transcribed from
src/gmm/src/gmm.cc) plus recovery and masking invariance tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.config import GmmConfig
from speaker_recognition.models import gmm

import oracles


def make_data(n=500, d=5, K=3, seed=0):
    rng = np.random.RandomState(seed)
    true_means = rng.randn(K, d) * 3
    true_sigmas = 0.5 + rng.rand(K, d)
    comps = rng.randint(0, K, size=n)
    X = true_means[comps] + rng.randn(n, d) * true_sigmas[comps]
    return X, true_means, true_sigmas


def rand_params(K, d, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.rand(K) + 0.1
    w /= w.sum()
    return (w, rng.randn(K, d), 0.5 + rng.rand(K, d))


class TestDensity:
    def test_log_gaussians_matches_scalar_formula(self):
        X, _, _ = make_data(50, 4, 2, seed=2)
        w, mu, sg = rand_params(3, 4)
        ours = np.asarray(gmm.log_gaussians(jnp.asarray(X), jnp.asarray(mu), jnp.asarray(sg)))
        SQRT_2_PI = 2.5066282746310002
        for k in range(3):
            logp = np.zeros(50)
            for i in range(4):
                dd = X[:, i] - mu[k, i]
                logp += -np.log(SQRT_2_PI * sg[k, i]) - dd * dd / (2 * sg[k, i] ** 2)
            np.testing.assert_allclose(ours[:, k], logp, rtol=1e-9, atol=1e-9)

    def test_per_frame_loglik_matches_oracle(self):
        X, _, _ = make_data(200, 5, 3, seed=3)
        w, mu, sg = rand_params(4, 5, seed=4)
        params = gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg))
        ours = np.asarray(gmm.per_frame_loglik(params, jnp.asarray(X)))
        ref = oracles.oracle_gmm_log_likelihood(X, w, mu, sg)
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-9)


class TestEmIteration:
    def test_one_em_step_matches_oracle(self):
        X, _, _ = make_data(400, 6, 3, seed=5)
        w, mu, sg = rand_params(4, 6, seed=6)
        cfg = GmmConfig(n_mixtures=4)
        params = gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg))
        mask = jnp.ones(400, dtype=bool)
        stats = gmm.sufficient_stats(params, jnp.asarray(X), mask)
        new = gmm.m_step(stats, cfg)
        ref_w, ref_mu, ref_sg, ref_gamma, ref_Nk = oracles.oracle_gmm_em_iteration(X, w, mu, sg)
        np.testing.assert_allclose(np.asarray(stats.N_k), ref_Nk, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(new.weights), ref_w, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(new.means), ref_mu, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(new.sigmas), ref_sg, rtol=1e-6, atol=1e-9)

    def test_padding_does_not_change_stats(self):
        X, _, _ = make_data(300, 5, 3, seed=7)
        w, mu, sg = rand_params(3, 5, seed=8)
        params = gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg))
        Xp = np.zeros((450, 5))
        Xp[:300] = X
        mask = jnp.arange(450) < 300
        s1 = gmm.sufficient_stats(params, jnp.asarray(X), jnp.ones(300, dtype=bool))
        s2 = gmm.sufficient_stats(params, jnp.asarray(Xp), mask)
        for a, b in zip(s1, s2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


class TestFit:
    def test_recovers_synthetic_mixture(self):
        X, true_mu, true_sg = make_data(4000, 3, 3, seed=9)
        cfg = GmmConfig(n_mixtures=3, n_iterations=300, threshold=1e-9)
        params, ll = gmm.fit(jnp.asarray(X), jnp.ones(len(X), dtype=bool), cfg,
                             jax.random.PRNGKey(0))
        # fitted avg ll should be close to the generating model's
        true_params = gmm.GmmParams(
            jnp.full((3,), 1 / 3.0), jnp.asarray(true_mu), jnp.asarray(true_sg))
        mask = jnp.ones(len(X), dtype=bool)
        ll_fit = float(gmm.avg_loglik(params, jnp.asarray(X), mask))
        ll_true = float(gmm.avg_loglik(true_params, jnp.asarray(X), mask))
        assert ll_fit > ll_true - 0.05, (ll_fit, ll_true)
        # means recovered up to permutation
        fit_mu = np.asarray(params.means)
        for tm in true_mu:
            d = np.abs(fit_mu - tm).sum(axis=1).min()
            assert d < 0.5, (tm, fit_mu)

    def test_fit_padded_equals_unpadded(self):
        X, _, _ = make_data(600, 4, 3, seed=10)
        cfg = GmmConfig(n_mixtures=4, n_iterations=20)
        key = jax.random.PRNGKey(1)
        p1, _ = gmm.fit(jnp.asarray(X), jnp.ones(600, dtype=bool), cfg, key)
        Xp = np.zeros((800, 4))
        Xp[:600] = X
        p2, _ = gmm.fit(jnp.asarray(Xp), jnp.arange(800) < 600, cfg, key)
        np.testing.assert_allclose(np.asarray(p1.means), np.asarray(p2.means),
                                   rtol=1e-7, atol=1e-9)

    def test_vmapped_bank_training(self):
        cfg = GmmConfig(n_mixtures=2, n_iterations=30)
        Xs, masks = [], []
        for s in range(3):
            X, _, _ = make_data(500, 4, 2, seed=20 + s)
            Xs.append(X)
            masks.append(np.ones(500, dtype=bool))
        Xs = jnp.asarray(np.stack(Xs))
        masks = jnp.asarray(np.stack(masks))
        keys = jax.random.split(jax.random.PRNGKey(2), 3)
        bank, lls = jax.vmap(lambda x, m, k: gmm.fit(x, m, cfg, k))(Xs, masks, keys)
        assert bank.means.shape == (3, 2, 4)
        # each matches its own serial fit
        for s in range(3):
            ps, _ = gmm.fit(Xs[s], masks[s], cfg, keys[s])
            np.testing.assert_allclose(np.asarray(bank.means[s]), np.asarray(ps.means),
                                       rtol=1e-6, atol=1e-8)


class TestMapAdaptation:
    def test_one_map_step_matches_formula(self):
        X, _, _ = make_data(300, 4, 2, seed=11)
        w, mu, sg = rand_params(3, 4, seed=12)
        ubm = gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg))
        cfg = GmmConfig(n_mixtures=3)
        mask = jnp.ones(300, dtype=bool)
        stats = gmm.sufficient_stats(ubm, jnp.asarray(X), mask)
        adapted = gmm.map_m_step(stats, ubm, cfg)
        # numpy rendering of gmmubm.cc:53-74
        gamma = np.asarray(gmm.responsibilities(ubm, jnp.asarray(X)))
        Nk = gamma.sum(axis=0)
        alpha = Nk / (Nk + 16.0)
        ref_means = alpha[:, None] * (gamma.T @ X / Nk[:, None]) + (1 - alpha)[:, None] * mu
        np.testing.assert_allclose(np.asarray(adapted.means), ref_means, rtol=1e-7)
        np.testing.assert_allclose(np.asarray(adapted.weights), w)
        np.testing.assert_allclose(np.asarray(adapted.sigmas), sg)

    def test_huge_relevance_keeps_ubm(self):
        X, _, _ = make_data(200, 3, 2, seed=13)
        w, mu, sg = rand_params(2, 3, seed=14)
        ubm = gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg))
        cfg = GmmConfig(n_mixtures=2, relevance_factor=1e12, n_iterations=5)
        adapted, _ = gmm.fit_from_ubm(jnp.asarray(X), jnp.ones(200, dtype=bool), ubm, cfg)
        np.testing.assert_allclose(np.asarray(adapted.means), mu, atol=1e-6)


class TestBankScoring:
    def test_bank_matches_loop(self):
        X, _, _ = make_data(150, 4, 2, seed=15)
        mask = jnp.ones(150, dtype=bool)
        plist = []
        for s in range(4):
            w, mu, sg = rand_params(3, 4, seed=30 + s)
            plist.append(gmm.GmmParams(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sg)))
        bank = gmm.stack_params(plist)
        scores = np.asarray(gmm.bank_avg_loglik(bank, jnp.asarray(X), mask))
        for s, p in enumerate(plist):
            ref = float(gmm.avg_loglik(p, jnp.asarray(X), mask))
            np.testing.assert_allclose(scores[s], ref, rtol=1e-9)
