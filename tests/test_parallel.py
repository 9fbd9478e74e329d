"""Sharding-equivalence tests on the virtual 8-device CPU mesh: sharded EM
and bank scoring must reproduce single-device results exactly (SURVEY.md
section 4(d))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.config import GmmConfig
from speaker_recognition.models import gmm
from speaker_recognition.parallel import mesh as pmesh


pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")


def make_data(n=512, d=6, K=4, seed=0):
    rng = np.random.RandomState(seed)
    mu = rng.randn(K, d) * 2
    comps = rng.randint(0, K, n)
    X = (mu[comps] + rng.randn(n, d)).astype(np.float64)
    return X


def rand_params(K, d, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.rand(K) + 0.1
    w /= w.sum()
    return gmm.GmmParams(jnp.asarray(w), jnp.asarray(rng.randn(K, d)),
                         jnp.asarray(0.5 + rng.rand(K, d)))


class TestShardedEm:
    def test_em_step_matches_single_device(self):
        cfg = GmmConfig(n_mixtures=4)
        X = make_data(512, 6, 4)
        mask = np.ones(512, bool)
        params = rand_params(4, 6)

        ref = gmm.m_step(gmm.sufficient_stats(params, jnp.asarray(X),
                                              jnp.asarray(mask)), cfg)
        m = pmesh.make_mesh(data=8, bank=1)
        step = pmesh.sharded_em_step(m, cfg)
        out = step(params, jnp.asarray(X), jnp.asarray(mask))
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)

    def test_em_step_data_bank_mesh(self):
        cfg = GmmConfig(n_mixtures=3)
        X = make_data(256, 5, 3, seed=2)
        mask = np.arange(256) < 200
        params = rand_params(3, 5, seed=3)
        ref = gmm.m_step(gmm.sufficient_stats(params, jnp.asarray(X),
                                              jnp.asarray(mask)), cfg)
        m = pmesh.make_mesh(data=4, bank=2)
        step = pmesh.sharded_em_step(m, cfg)
        out = step(params, jnp.asarray(X), jnp.asarray(mask))
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)

    def test_gspmd_full_fit_matches(self):
        cfg = GmmConfig(n_mixtures=4, n_iterations=10)
        X = make_data(512, 5, 4, seed=4)
        mask = np.ones(512, bool)
        key = jax.random.PRNGKey(0)
        ref, ll_ref = gmm.fit(jnp.asarray(X), jnp.asarray(mask), cfg, key)
        m = pmesh.make_mesh(data=8, bank=1)
        fit = pmesh.sharded_fit(m, cfg)
        out, ll = fit(X, mask, key)
        np.testing.assert_allclose(np.asarray(ref.means), np.asarray(out.means),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(ll_ref), float(ll), rtol=1e-10)


class TestShardedBank:
    def test_bank_scores_match(self):
        X = make_data(128, 5, 3, seed=5)
        mask = np.ones(128, bool)
        plist = [rand_params(4, 5, seed=10 + s) for s in range(8)]
        bank = gmm.stack_params(plist)
        ref = gmm.bank_avg_loglik(bank, jnp.asarray(X), jnp.asarray(mask))
        m = pmesh.make_mesh(data=1, bank=8)
        score = pmesh.sharded_bank_scores(m)
        out = score(bank, jnp.asarray(X), jnp.asarray(mask))
        np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                                   rtol=1e-12, atol=1e-12)


class TestDryrun:
    def test_dryrun_multichip(self):
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import __graft_entry__
        __graft_entry__.dryrun_multichip(8)

    def test_entry_compiles(self):
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import __graft_entry__
        fn, args = __graft_entry__.entry()
        labels, scores = jax.jit(fn)(*args)
        assert labels.shape == (8,)
        assert scores.shape == (8, 16)


class TestScalingHarness:
    def test_scaling_report_runs_on_virtual_mesh(self):
        """multihost.scaling_report (the BASELINE.md scaling harness) must
        execute on the 8-device CPU mesh and report sane weak-scaling
        fields (VERDICT r1: the module was exercised by no test)."""
        from speaker_recognition.parallel import multihost

        row = multihost.scaling_report(frames_per_device=2048, mixtures=4,
                                       dim=6, iters=2, bank=8)
        assert row["devices"] == jax.device_count() == 8
        assert row["hosts"] == 1
        assert row["em_workload_frames"] == 2048 * 8
        assert row["em_audio_s_per_s"] > 0
        assert row["score_audio_s_per_s"] > 0
