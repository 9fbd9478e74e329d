"""Round-trip tests for the native npz session artifact and the reference
text GMM format."""

import io

import pytest

import numpy as np

from speaker_recognition.config import PipelineConfig, GmmConfig
from speaker_recognition.models.gmm import GmmParams
from speaker_recognition.models.gmmset import GMMSet
from speaker_recognition.utils import serialization


def rand_gmm(K=4, d=3, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.rand(K) + 0.1
    w /= w.sum()
    return GmmParams(w, rng.randn(K, d), 0.5 + rng.rand(K, d))


class TestReferenceTextFormat:
    def test_round_trip_exact(self):
        p = rand_gmm()
        text = serialization.dumps_reference_gmm(p)
        q = serialization.loads_reference_gmm(text)
        np.testing.assert_array_equal(np.asarray(p.weights), q.weights)
        np.testing.assert_array_equal(np.asarray(p.means), q.means)
        np.testing.assert_array_equal(np.asarray(p.sigmas), q.sigmas)

    def test_format_shape(self):
        p = rand_gmm(K=2, d=3)
        lines = serialization.dumps_reference_gmm(p).strip().split("\n")
        # header: K, weights, then per gaussian 3 lines
        assert lines[0] == "2"
        assert len(lines) == 2 + 2 * 3
        assert lines[2].split()[:2] == ["3", "1"]  # dim, COVTYPE_DIAGONAL

    def test_parses_reference_style_stream(self):
        # the C++ writer uses "val val val \n" with trailing spaces and
        # default ostream precision; the reader is token-based
        text = "1\n0.5 0.5 \n2 1\n1.0 2.0 \n0.1 0.2 \n"
        # (weights line actually has K entries; craft a consistent one)
        text = "2\n0.5 0.5 \n2 1\n1.0 2.0 \n0.1 0.2 \n2 1\n3.0 4.0 \n0.3 0.4 \n"
        q = serialization.loads_reference_gmm(text)
        assert q.weights.shape == (2,)
        np.testing.assert_allclose(q.means, [[1, 2], [3, 4]])


class TestSessionArtifact:
    def test_round_trip(self, tmp_path):
        p = rand_gmm(K=3, d=4, seed=1)
        ubm = rand_gmm(K=3, d=4, seed=2)
        gs = GMMSet(gmm_order=3, ubm=ubm)
        gs.y = ["alice", "bob"]
        gs.bank = GmmParams(
            np.stack([np.asarray(p.weights)] * 2),
            np.stack([np.asarray(p.means)] * 2),
            np.stack([np.asarray(p.sigmas)] * 2),
        )
        cfg = PipelineConfig(gmm=GmmConfig(n_mixtures=3))
        path = str(tmp_path / "model.npz")
        vad_state = {"noise_amp": np.arange(5.0), "lambda0": 1.5, "lambda1": 3.0,
                     "window_size": 371, "order": 5, "fs": 8000}
        serialization.save_session(path, gmmset_state=gs.state(), config=cfg,
                                   vad_state=vad_state)
        st, cfg2, vad2 = serialization.load_session(path)
        gs2 = GMMSet.from_state(st)
        assert gs2.y == ["alice", "bob"]
        np.testing.assert_array_equal(gs2.bank.means, gs.bank.means)
        np.testing.assert_array_equal(np.asarray(gs2.ubm.means), np.asarray(ubm.means))
        assert cfg2.gmm.n_mixtures == 3
        assert cfg2 == cfg
        np.testing.assert_array_equal(vad2["noise_amp"], np.arange(5.0))
        assert vad2["window_size"] == 371

    def test_no_ubm_no_vad(self, tmp_path):
        gs = GMMSet(gmm_order=2)
        gs.y = ["x"]
        p = rand_gmm(K=2, d=2, seed=3)
        gs.bank = GmmParams(np.asarray(p.weights)[None], np.asarray(p.means)[None],
                            np.asarray(p.sigmas)[None])
        path = str(tmp_path / "m.npz")
        serialization.save_session(path, gmmset_state=gs.state(),
                                   config=PipelineConfig())
        st, cfg, vad = serialization.load_session(path)
        assert vad is None
        assert "ubm_weights" not in st


class TestJfaSupervectors:
    def test_round_trip(self, tmp_path):
        p = rand_gmm(K=4, d=3, seed=5)
        serialization.dump_jfa_supervectors(p, str(tmp_path))
        q = serialization.load_jfa_supervectors(str(tmp_path))
        np.testing.assert_allclose(q.weights, np.asarray(p.weights))
        np.testing.assert_allclose(q.means, np.asarray(p.means))
        np.testing.assert_allclose(q.sigmas, np.asarray(p.sigmas), rtol=1e-12)
        # three text files with the reference's names
        for name in ("ubm_means", "ubm_variances", "ubm_weights"):
            assert (tmp_path / name).exists()


class TestLoadGmmIntoSet:
    def test_load_reference_model_as_speaker(self, tmp_path):
        from speaker_recognition.models.gmmset import GMMSet
        import io as _io

        p = rand_gmm(K=3, d=4, seed=7)
        path = str(tmp_path / "spk.model")
        with open(path, "w") as f:
            serialization.dump_reference_gmm(p, f)

        gs = GMMSet(gmm_order=3)
        gs.load_gmm("imported", path)
        assert gs.y == ["imported"]
        assert gs.bank.means.shape == (1, 3, 4)
        # scoring works through the imported model
        rng = np.random.RandomState(8)
        x = rng.randn(50, 4).astype(np.float32)
        assert gs.predict_one(x) == "imported"
        # appending a second one grows the bank
        gs.load_gmm("second", path)
        assert gs.bank.means.shape == (2, 3, 4)


class TestShippedReferenceModels:
    """The reference repo ships real pretrained UBM artifacts
    (src/gui/model/*.model, written by its C++ GMM::dump) — our reader must
    load them and score with them."""

    REF_MODELS = "/root/reference/src/gui/model"

    @pytest.mark.parametrize("name,K", [
        ("ubm.mixture-32.utt-300.model", 32),
        ("ubm.mixture-64.utt-300.model", 64),
        ("ubm.mixture-256.nperson-300.immature.model", 256),
    ])
    def test_loads_and_scores(self, name, K):
        import os
        path = os.path.join(self.REF_MODELS, name)
        if not os.path.exists(path):
            pytest.skip("reference checkout not mounted")
        with open(path) as f:
            params = serialization.load_reference_gmm(f)
        assert params.weights.shape == (K,)
        assert params.means.shape[0] == K
        np.testing.assert_allclose(params.weights.sum(), 1.0, rtol=1e-4)
        assert (params.sigmas > 0).all()

        import jax, jax.numpy as jnp
        from speaker_recognition.models import gmm as gmm_mod
        d = params.means.shape[1]
        pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        rng = np.random.RandomState(0)
        X = jnp.asarray(rng.randn(64, d))
        ll = gmm_mod.per_frame_loglik(pj, X)
        assert np.isfinite(np.asarray(ll)).all()
