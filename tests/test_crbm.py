"""CRBM / RBM / DBN tests: reconstruction learning, bank classification."""

import numpy as np
import jax
import jax.numpy as jnp

from speaker_recognition.models import crbm, rbm


def speaker_frames(center, n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (center[None, :] + rng.randn(n, d) * 0.15).astype(np.float32)


class TestCrbm:
    def test_training_reduces_reconstruction_error(self):
        rng = np.random.RandomState(1)
        X = speaker_frames(rng.randn(6), n=400, seed=2)
        mask = jnp.ones(len(X), dtype=bool)
        cfg = crbm.CrbmTrainConfig(n_epochs=30, batch_size=100)
        key = jax.random.PRNGKey(0)
        params0 = crbm.init_params(jax.random.PRNGKey(9), 6, 8,
                                   jnp.asarray(X), mask)
        err0 = float(crbm.reconstruction_error(params0, jnp.asarray(X), mask))
        params = crbm.fit(jnp.asarray(X), mask, 8, cfg, key)
        err1 = float(crbm.reconstruction_error(params, jnp.asarray(X), mask))
        assert err1 < err0, (err0, err1)

    def test_bank_classification(self):
        rng = np.random.RandomState(3)
        centers = [rng.randn(6) * 2 for _ in range(3)]
        Xs = np.stack([speaker_frames(c, n=300, seed=10 + i)
                       for i, c in enumerate(centers)])
        masks = jnp.ones((3, 300), dtype=bool)
        cfg = crbm.CrbmTrainConfig(n_epochs=40, batch_size=100)
        bank = crbm.fit_bank(jnp.asarray(Xs), masks, 8, cfg, jax.random.PRNGKey(1))
        assert bank.w.shape == (3, 6, 8)
        labels = ["a", "b", "c"]
        correct = 0
        for i, c in enumerate(centers):
            test = speaker_frames(c, n=100, seed=20 + i)
            pred = crbm.predict_bank(bank, labels,
                                     jnp.asarray(test), jnp.ones(100, dtype=bool))
            correct += pred == labels[i]
        assert correct >= 2, correct

    def test_visible_range_tracked(self):
        X = np.array([[0.0, -2.0], [1.0, 3.0], [0.5, 0.0]], np.float32)
        p = crbm.init_params(jax.random.PRNGKey(0), 2, 4, jnp.asarray(X),
                             jnp.ones(3, dtype=bool))
        np.testing.assert_allclose(np.asarray(p.vlo), [0.0, -2.0])
        np.testing.assert_allclose(np.asarray(p.vhi), [1.0, 3.0])
        # padding rows must not affect the range
        Xp = np.concatenate([X, np.full((2, 2), 99.0, np.float32)])
        p2 = crbm.init_params(jax.random.PRNGKey(0), 2, 4, jnp.asarray(Xp),
                              jnp.arange(5) < 3)
        np.testing.assert_allclose(np.asarray(p2.vhi), [1.0, 3.0])


class TestCrbmCheckpointing:
    """Segmented (checkpoint/resume) training — the reference's
    nr_epoch_save periodic save (crbm.cc:370-376)."""

    def test_segmented_equals_monolithic(self):
        rng = np.random.RandomState(4)
        Xs = np.stack([speaker_frames(rng.randn(5), n=130, d=5, seed=i)
                       for i in range(3)])
        masks = np.ones(Xs.shape[:2], dtype=bool)
        masks[1, 100:] = False  # ragged speaker exercises the budget mask
        cfg = crbm.CrbmTrainConfig(n_epochs=12, batch_size=50)
        key = jax.random.PRNGKey(7)
        mono = crbm.fit_bank(jnp.asarray(Xs), jnp.asarray(masks), 6, cfg, key)
        state = None
        for seg in (5, 4, 3):  # 12 epochs in three uneven segments
            state = crbm.fit_bank_segment(jnp.asarray(Xs), jnp.asarray(masks),
                                          6, cfg, key, state, seg, 12)
        for a, b in zip(mono, state.params):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_reference_text_roundtrip(self):
        import io

        from speaker_recognition.utils import serialization

        rng = np.random.RandomState(5)
        X = speaker_frames(rng.randn(4), n=120, d=4, seed=6)
        mask = jnp.ones(len(X), dtype=bool)
        cfg = crbm.CrbmTrainConfig(n_epochs=5, batch_size=40)
        params = crbm.fit(jnp.asarray(X), mask, 5, cfg, jax.random.PRNGKey(1))
        buf = io.StringIO()
        serialization.dump_reference_crbm(params, buf)
        back = serialization.load_reference_crbm(io.StringIO(buf.getvalue()))
        for fld in crbm.CrbmParams._fields:
            np.testing.assert_allclose(np.asarray(getattr(back, fld)),
                                       np.asarray(getattr(params, fld)),
                                       atol=1e-9)
        # the %.10f text resolution preserves classification behavior
        e1 = float(crbm.reconstruction_error(params, jnp.asarray(X), mask))
        bj = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), back)
        e2 = float(crbm.reconstruction_error(bj, jnp.asarray(X), mask))
        assert abs(e1 - e2) < 1e-3 * max(1.0, abs(e1))


class TestRbm:
    def test_learns_binary_patterns(self):
        rng = np.random.RandomState(4)
        protos = np.array([[1, 1, 0, 0, 1, 0], [0, 0, 1, 1, 0, 1]], np.float32)
        X = protos[rng.randint(0, 2, 500)]
        flip = rng.rand(500, 6) < 0.02
        X = np.where(flip, 1 - X, X).astype(np.float32)
        cfg = rbm.RbmTrainConfig(n_epochs=60, batch_size=100)
        params = rbm.fit(jnp.asarray(X), 4, cfg, jax.random.PRNGKey(0))
        # deterministic reconstruction should denoise toward prototypes
        H = rbm.transform(params, jnp.asarray(protos))
        V = jax.nn.sigmoid(H @ params.w.T + params.vb[None, :])
        err = np.abs(np.asarray(V) - protos).mean()
        assert err < 0.35, err

    def test_dbn_stacks(self):
        rng = np.random.RandomState(5)
        X = (rng.rand(200, 8) > 0.5).astype(np.float32)
        d = rbm.Dbn()
        d.add_layer(6)
        d.add_layer(4)
        cfg = rbm.RbmTrainConfig(n_epochs=5, batch_size=50)
        d.fit(jnp.asarray(X), cfg, jax.random.PRNGKey(0))
        out = d.propagate(jnp.asarray(X))
        assert out.shape == (200, 4)
        d.fit_last_layer(jnp.asarray(X), cfg, jax.random.PRNGKey(1))
        assert len(d.layers) == 2
