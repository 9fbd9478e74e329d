"""Compiled on the GPU: the device-side k-means|| seeding, the scoring
kernel against the XLA program, and the GSPMD EM fit on a one-device mesh,
each against a backend-independent reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.models import gmm, kmeans
from speaker_recognition.ops import pallas_gmm

pytestmark = pytest.mark.gpu


def test_kmeansii_device_compiled():
    """kmeansii_device compiled on the card: finite centroids and inertia,
    deterministic per seed, and it clusters a well-separated mixture."""
    rng = np.random.RandomState(0)
    K, d, n_per = 8, 16, 200
    centers = rng.randn(K, d) * 6
    X = np.concatenate([c + 0.3 * rng.randn(n_per, d) for c in centers])
    Xj = jnp.asarray(X, jnp.float32)
    mask = jnp.ones(X.shape[0], bool)

    C1, inertia1 = kmeans.kmeansii_device(Xj, mask, K, jax.random.PRNGKey(7))
    C2, _ = kmeans.kmeansii_device(Xj, mask, K, jax.random.PRNGKey(7))
    C1, C2 = np.asarray(C1), np.asarray(C2)
    assert np.isfinite(C1).all() and np.isfinite(float(inertia1))
    np.testing.assert_array_equal(C1, C2)

    dists = np.linalg.norm(centers[:, None, :] - C1[None, :, :], axis=-1)
    assert (dists.min(axis=1) < 1.5).all(), dists.min(axis=1)


@pytest.mark.parametrize("S,K,d", [(6, 32, 28), (3, 8, 28), (80, 256, 28),
                                   (4, 32, 84)])
def test_scoring_kernel_compiled_vs_xla(S, K, d):
    """The kernel compiled by Triton (3xTF32 dots) vs the XLA scoring at
    float32: float32-class rounding of log-density terms up to ~1e3 bounds
    the gap."""
    rng = np.random.RandomState(1)
    B, T = 12, 160
    feats = jnp.asarray(rng.randn(B, T, d).astype(np.float32))
    lengths = rng.randint(2, T + 1, size=B)
    mask = jnp.asarray(np.arange(T)[None, :] < lengths[:, None])
    w = rng.rand(S, K) + 0.1
    bank = gmm.GmmParams(
        jnp.asarray((w / w.sum(1, keepdims=True)).astype(np.float32)),
        jnp.asarray(rng.randn(S, K, d).astype(np.float32)),
        jnp.asarray((0.5 + rng.rand(S, K, d)).astype(np.float32)))

    got = np.asarray(pallas_gmm.batch_bank_avg_loglik(bank, feats, mask))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.vmap(
            lambda X, m: gmm.bank_avg_loglik(bank, X, m))(feats, mask))
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_sharded_em_compiled_on_single_device_mesh():
    """sharded_fit through the GSPMD path on a one-card mesh: the program a
    multi-card host runs, compiled and executed on the card; equals the
    unsharded fit (single shard)."""
    from speaker_recognition.config import GmmConfig
    from speaker_recognition.parallel import mesh as pmesh

    rng = np.random.RandomState(2)
    X = rng.randn(4096, 12).astype(np.float32)
    mask = np.ones(4096, bool)
    cfg = GmmConfig(n_mixtures=8, n_iterations=5, threshold=0.0)
    key = jax.random.PRNGKey(0)

    mesh = pmesh.make_mesh(data=1, bank=1, devices=jax.devices()[:1])
    fit = pmesh.sharded_fit(mesh, cfg)
    p_sharded, ll_sharded = fit(X, mask, key)
    p_plain, ll_plain = gmm.fit(jnp.asarray(X), jnp.asarray(mask), cfg, key)
    np.testing.assert_allclose(np.asarray(p_sharded.means),
                               np.asarray(p_plain.means), rtol=1e-6)
    np.testing.assert_allclose(float(ll_sharded), float(ll_plain), rtol=1e-6)
