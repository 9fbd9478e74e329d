"""k-means family tests: distance kernel, Lloyd's convergence/masking,
k-means++ and k-means|| quality."""

import numpy as np
import jax
import jax.numpy as jnp

from speaker_recognition.models import kmeans


def blobs(n_per=100, K=4, d=5, spread=0.2, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(K, d) * 3
    X = np.concatenate([centers[k] + rng.randn(n_per, d) * spread
                        for k in range(K)], axis=0)
    return X, centers


class TestDistance:
    def test_pairwise_matches_naive(self):
        rng = np.random.RandomState(1)
        X = rng.randn(30, 4)
        C = rng.randn(5, 4)
        ref = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
        out = kmeans.pairwise_dist2(jnp.asarray(X), jnp.asarray(C))
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-9, atol=1e-9)


class TestLloyd:
    def test_recovers_blobs(self):
        X, centers = blobs()
        mask = jnp.ones(len(X), dtype=bool)
        # seed with perturbed true centers
        C0 = jnp.asarray(centers + 0.5)
        C, cost = kmeans.lloyd(jnp.asarray(X), mask, C0)
        C = np.asarray(C)
        for c in centers:
            assert np.abs(C - c).sum(axis=1).min() < 0.2

    def test_mask_excludes_padding(self):
        X, centers = blobs(seed=2)
        Xp = np.concatenate([X, np.full((50, X.shape[1]), 100.0)], axis=0)
        mask = jnp.arange(len(Xp)) < len(X)
        C0 = jnp.asarray(centers + 0.3)
        C_pad, cost_pad = kmeans.lloyd(jnp.asarray(Xp), mask, C0)
        C_ref, cost_ref = kmeans.lloyd(jnp.asarray(X), jnp.ones(len(X), dtype=bool), C0)
        np.testing.assert_allclose(np.asarray(C_pad), np.asarray(C_ref),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(cost_pad), float(cost_ref), rtol=1e-9)

    def test_empty_cluster_keeps_centroid(self):
        X = np.array([[0.0, 0.0], [1.0, 1.0]])
        C0 = jnp.asarray([[0.0, 0.0], [1.0, 1.0], [50.0, 50.0]])
        C, _ = kmeans.lloyd(jnp.asarray(X), jnp.ones(2, dtype=bool), C0)
        assert np.isfinite(np.asarray(C)).all()


class TestSeeding:
    def test_kmeanspp_quality(self):
        X, centers = blobs(seed=3)
        C, cost = kmeans.kmeanspp(jnp.asarray(X), jnp.ones(len(X), dtype=bool),
                                  4, jax.random.PRNGKey(0))
        # cost should be near the optimal (spread^2 * d * n)
        opt = 0.2 ** 2 * X.shape[1] * len(X)
        assert float(cost) < 3 * opt, (float(cost), opt)

    def test_kmeansii_quality(self):
        X, centers = blobs(seed=4)
        C, cost = kmeans.kmeansii(jnp.asarray(X), jnp.ones(len(X), dtype=bool),
                                  4, jax.random.PRNGKey(1))
        opt = 0.2 ** 2 * X.shape[1] * len(X)
        assert float(cost) < 3 * opt, (float(cost), opt)
        assert np.asarray(C).shape == (4, X.shape[1])

    def test_kmeansii_masked(self):
        X, centers = blobs(seed=5)
        Xp = np.concatenate([X, np.full((30, X.shape[1]), 77.0)], axis=0)
        mask = jnp.arange(len(Xp)) < len(X)
        C, cost = kmeans.kmeansii(jnp.asarray(Xp), mask, 4, jax.random.PRNGKey(2))
        # no centroid may sit on the padding value
        assert np.abs(np.asarray(C) - 77.0).min() > 1.0


class TestKmeansIIDevice:
    """Device-side k-means|| (one jitted program, VERDICT r1 item 7)."""

    def _blobs(self, K=6, per=120, d=5, seed=0, spread=0.05):
        rng = np.random.RandomState(seed)
        centers = rng.randn(K, d) * 5
        X = np.concatenate([c + spread * rng.randn(per, d) for c in centers])
        return jnp.asarray(X, jnp.float64), centers

    def test_recovers_separated_blobs(self):
        X, centers = self._blobs()
        mask = jnp.ones(X.shape[0], bool)
        C, cost = kmeans.kmeansii_device(X, mask, 6, jax.random.PRNGKey(0))
        # each true center has a recovered centroid within the blob spread
        d2 = np.asarray(kmeans.pairwise_dist2(jnp.asarray(centers), C))
        assert (d2.min(axis=1) < 0.1).all(), d2.min(axis=1)

    def test_cost_parity_with_host_version(self):
        """Same algorithm, different RNG stream: clustering quality must
        match the host-orchestrated kmeansii (within 10% cost)."""
        rng = np.random.RandomState(3)
        X = jnp.asarray(rng.randn(800, 8) * (1 + rng.rand(8)), jnp.float64)
        mask = jnp.ones(800, bool)
        _, cost_dev = kmeans.kmeansii_device(X, mask, 16, jax.random.PRNGKey(1))
        _, cost_host = kmeans.kmeansii(X, mask, 16, jax.random.PRNGKey(1))
        assert float(cost_dev) < 1.10 * float(cost_host), \
            (float(cost_dev), float(cost_host))

    def test_deterministic_and_mask_respected(self):
        X, _ = self._blobs(K=4, per=60)
        n = X.shape[0]
        mask = jnp.arange(n) < (n - 37)  # padded tail
        Xz = X.at[n - 37:].set(1e6)      # poisoned padding must never be picked
        C1, c1 = kmeans.kmeansii_device(Xz, mask, 4, jax.random.PRNGKey(7))
        C2, c2 = kmeans.kmeansii_device(Xz, mask, 4, jax.random.PRNGKey(7))
        np.testing.assert_array_equal(np.asarray(C1), np.asarray(C2))
        assert float(jnp.max(jnp.abs(C1))) < 1e5

    def test_vmaps_over_speaker_bank(self):
        Xs, masks = [], []
        for s in range(3):
            X, _ = self._blobs(K=4, per=50, seed=s)
            Xs.append(X)
            masks.append(jnp.ones(X.shape[0], bool))
        Xs = jnp.stack(Xs)
        masks = jnp.stack(masks)
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        C, cost = jax.vmap(
            lambda x, m, k: kmeans.kmeansii_device(x, m, 4, k))(Xs, masks, keys)
        assert C.shape == (3, 4, Xs.shape[-1])
        # per-speaker result identical to the unvmapped call
        C0, _ = kmeans.kmeansii_device(Xs[0], masks[0], 4, keys[0])
        np.testing.assert_allclose(np.asarray(C[0]), np.asarray(C0),
                                   rtol=1e-12, atol=1e-12)

    def test_gmmset_kmeans_init_trains_vmapped(self):
        """GMMSet with init_with_kmeans trains a multi-speaker bank in one
        program and still classifies correctly."""
        from speaker_recognition.config import GmmConfig
        from speaker_recognition.models.gmmset import GMMSet

        rng = np.random.RandomState(0)
        cfg = GmmConfig(n_mixtures=4, n_iterations=20, init_with_kmeans=True)
        gs = GMMSet(gmm_order=4, config=cfg, dtype="float64")
        speakers = {}
        for s in range(3):
            mu = rng.randn(4, 6) * 4
            X = np.concatenate([m + 0.3 * rng.randn(150, 6) for m in mu])
            speakers[f"s{s}"] = X
            gs.fit_new(X, f"s{s}")
        gs.train(seed=0)
        for label, X in speakers.items():
            test = X[rng.permutation(len(X))[:80]]
            assert gs.predict_one(test) == label


def test_kmeansii_device_short_utterance_enrollment_geometry():
    """n < seed-buffer capacity (the 3 s enrollment geometry: 186 frames,
    K=32, cap=321): r1-r2 sliced a length-n array with [:cap] and crashed
    with a broadcast error, so device kmeans-init enrollment never worked
    for short utterances. Also covers n barely above K."""
    import jax
    rng = np.random.RandomState(0)
    for n, K in [(186, 32), (40, 32), (700, 32)]:
        X = jnp.asarray(rng.randn(n, 28), jnp.float32)
        mask = jnp.asarray(np.arange(n) < n - 3)
        C, inertia = kmeans.kmeansii_device(X, mask, K,
                                            jax.random.PRNGKey(1))
        C = np.asarray(C)
        assert C.shape == (K, 28) and np.isfinite(C).all()
        assert np.isfinite(float(inertia))


def test_kmeans_init_enrollment_end_to_end():
    """The full enroll path with init_with_kmeans: short utterances per
    speaker, vmapped bank training (the geometry the r3 verify drive
    caught crashing)."""
    import jax
    from speaker_recognition.models.gmmset import GMMSet
    from speaker_recognition.config import GmmConfig
    rng = np.random.RandomState(1)
    gs = GMMSet(gmm_order=32, config=GmmConfig(init_with_kmeans=True,
                                               n_mixtures=32,
                                               n_iterations=20))
    # moderate speaker offsets: O(1) separation like real CMVN'd features
    # (extreme offsets trip the reference's inherited 1e-15 score floor,
    # models/gmm.per_frame_loglik docstring)
    for label, off in [("a", 0.0), ("b", 1.5), ("c", -1.5)]:
        gs.fit_new(rng.randn(180 + rng.randint(20), 28) + off, label)
    gs.train(seed=0)
    assert gs.bank.means.shape[0] == 3
    got = gs.predict_one(rng.randn(150, 28) + 1.5)
    assert got == "b"
