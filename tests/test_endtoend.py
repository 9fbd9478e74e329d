"""End-to-end: enroll -> train -> predict -> dump/load -> predict, plus the
drop-in CLI (decision-consistency analogue of the reference's
integration-style verification, SURVEY.md section 4)."""

import os

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from speaker_recognition.api.interface import ModelInterface
from speaker_recognition.config import GmmConfig, PipelineConfig

FS = 8000

SPEAKER_FREQS = {
    "alice": [150, 450, 1300],
    "bob": [110, 700, 2100],
    "carol": [220, 900, 3000],
}


def synth_utterance(label, seconds, seed):
    """Speaker-distinctive signal: characteristic harmonics + AM + noise."""
    rng = np.random.RandomState(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    sig = sum(np.sin(2 * np.pi * f * (1 + 0.01 * np.sin(2 * np.pi * 1.7 * t)) * t
                     + rng.rand() * 6.28) / (i + 1)
              for i, f in enumerate(SPEAKER_FREQS[label]))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2)
    sig += 0.05 * rng.randn(n)
    return (sig * 6000).astype(np.int16)


def small_config():
    return PipelineConfig(gmm=GmmConfig(n_mixtures=4, n_iterations=50))


@pytest.fixture(scope="module")
def trained_model():
    m = ModelInterface(small_config())
    for i, label in enumerate(SPEAKER_FREQS):
        m.enroll(label, FS, synth_utterance(label, 6.0, seed=100 + i))
    m.train()
    return m


class TestEnrollPredict:
    def test_predicts_each_speaker(self, trained_model):
        for i, label in enumerate(SPEAKER_FREQS):
            test_sig = synth_utterance(label, 3.0, seed=200 + i)
            assert trained_model.predict(FS, test_sig) == label

    def test_predict_batch_matches_serial(self, trained_model):
        sigs = [synth_utterance(l, 3.0, seed=300 + i)
                for i, l in enumerate(SPEAKER_FREQS)]
        batch = trained_model.predict_batch(FS, sigs)
        serial = [trained_model.predict(FS, s) for s in sigs]
        assert batch == serial == list(SPEAKER_FREQS)

    def test_scores_batch_matches_predict(self, trained_model):
        sigs = [synth_utterance(l, 2.0, seed=320 + i)
                for i, l in enumerate(SPEAKER_FREQS)]
        scores, valid = trained_model.scores_batch(FS, sigs)
        assert scores.shape == (len(sigs), len(SPEAKER_FREQS))
        assert valid.all()
        labels = [trained_model.gmmset.y[i] for i in scores.argmax(-1)]
        assert labels == trained_model.predict_batch(FS, sigs)
        import pytest as _pytest
        from speaker_recognition.api.interface import ModelInterface
        with _pytest.raises(RuntimeError, match="train"):
            ModelInterface(small_config()).scores_batch(FS, sigs)

    def test_dump_load_same_decisions(self, trained_model, tmp_path):
        path = str(tmp_path / "model.npz")
        trained_model.dump(path)
        m2 = ModelInterface.load(path)
        assert m2.gmmset.y == trained_model.gmmset.y
        np.testing.assert_array_equal(m2.gmmset.bank.means,
                                      trained_model.gmmset.bank.means)
        for i, label in enumerate(SPEAKER_FREQS):
            sig = synth_utterance(label, 3.0, seed=400 + i)
            assert m2.predict(FS, sig) == trained_model.predict(FS, sig)


class TestUbmRejection:
    def test_imposter_rejected(self):
        from speaker_recognition.models import gmm as gmm_mod
        from speaker_recognition.features import extract
        import jax

        cfg = small_config()
        # UBM from pooled background of all speakers
        pool = np.concatenate([
            extract.mix_feature(FS, synth_utterance(l, 4.0, seed=500 + i))
            for i, l in enumerate(SPEAKER_FREQS)], axis=0)
        import jax.numpy as jnp
        ubm, _ = gmm_mod.fit(jnp.asarray(pool, jnp.float32),
                             jnp.ones(len(pool), dtype=bool),
                             cfg.gmm, jax.random.PRNGKey(0))
        ubm = jax.tree.map(np.asarray, ubm)

        from speaker_recognition.models.gmmset import GMMSet
        gs = GMMSet(ubm=ubm, reject_threshold=0.2, config=cfg.gmm)
        for i, label in enumerate(["alice", "bob"]):
            gs.fit_new(extract.mix_feature(
                FS, synth_utterance(label, 6.0, seed=600 + i)), label)
        gs.train()

        # genuine: accepted with the right label
        feat = extract.mix_feature(FS, synth_utterance("alice", 3.0, seed=700))
        assert gs.predict_one_with_rejection(feat) == "alice"
        # imposter (carol was never enrolled): rejected
        feat = extract.mix_feature(FS, synth_utterance("carol", 3.0, seed=701))
        assert gs.predict_one_with_rejection(feat) is None

    def test_calibrate_rejection(self, tmp_path):
        """calibrate_rejection (VERDICT r4 item 4): the threshold comes
        from dev-set margins, separates genuine from imposter trials, and
        round-trips through the session artifact."""
        from speaker_recognition.models import gmm as gmm_mod
        from speaker_recognition.features import extract
        import jax

        cfg = small_config()
        rng = np.random.RandomState(5)
        bg = np.concatenate([extract.mix_feature(
            FS, synth_utterance(l, 4.0, seed=800 + i))
            for i, l in enumerate(SPEAKER_FREQS)], axis=0)
        import jax.numpy as jnp
        ubm, _ = gmm_mod.fit(jnp.asarray(bg, jnp.float32),
                             jnp.ones(bg.shape[0], bool),
                             cfg.gmm, jax.random.PRNGKey(0))
        ubm = jax.tree.map(np.asarray, ubm)

        from speaker_recognition.models.gmmset import GMMSet
        gs = GMMSet(ubm=ubm, config=cfg.gmm)  # default threshold 10
        for i, label in enumerate(["alice", "bob"]):
            gs.fit_new(extract.mix_feature(
                FS, synth_utterance(label, 6.0, seed=900 + i)), label)
        gs.train()

        genuine = [extract.mix_feature(FS, synth_utterance(
            l, 2.0, seed=950 + j)) for j, l in enumerate(
                ["alice", "bob", "alice", "bob"])]
        imposter = [extract.mix_feature(FS, synth_utterance(
            "carol", 2.0, seed=960 + j)) for j in range(4)]
        op = gs.calibrate_rejection(genuine, imposter, target="eer")
        assert op["threshold"] != 10.0
        assert op["eer"] <= 0.5
        # the calibrated threshold actually separates held-out trials
        gfeat = extract.mix_feature(FS, synth_utterance("alice", 3.0,
                                                        seed=970))
        ifeat = extract.mix_feature(FS, synth_utterance("carol", 3.0,
                                                        seed=971))
        assert gs.predict_one_with_rejection(gfeat) == "alice"
        assert gs.predict_one_with_rejection(ifeat) is None

        # FAR-targeted calibration: dev FAR bound holds by construction
        op_far = gs.calibrate_rejection(genuine, imposter, target="far",
                                        max_far=0.25)
        assert op_far["far"] <= 0.25

        # persistence: the calibrated threshold survives state round-trip
        st = gs.state()
        gs2 = GMMSet.from_state(st, config=cfg.gmm)
        assert gs2.reject_threshold == gs.reject_threshold


class TestCli:
    def test_enroll_predict_cli(self, tmp_path, monkeypatch):
        from speaker_recognition import cli

        for i, label in enumerate(SPEAKER_FREQS):
            d = tmp_path / label
            d.mkdir()
            wavfile.write(str(d / "a.wav"), FS,
                          synth_utterance(label, 5.0, seed=800 + i))
        test_dir = tmp_path / "test"
        test_dir.mkdir()
        for i, label in enumerate(SPEAKER_FREQS):
            wavfile.write(str(test_dir / f"t_{label}.wav"), FS,
                          synth_utterance(label, 3.0, seed=900 + i))

        model = str(tmp_path / "model.out")
        # small config for test speed
        monkeypatch.setattr(
            "speaker_recognition.api.interface.PipelineConfig",
            small_config)
        cli.main(["-t", "enroll",
                  "-i", f"{tmp_path}/alice {tmp_path}/bob {tmp_path}/carol",
                  "-m", model])
        assert os.path.exists(model + ".npz") or os.path.exists(model)

        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["-t", "predict", "-i", f"{test_dir}/*.wav", "-m",
                      model + ".npz" if os.path.exists(model + ".npz") else model])
        out = buf.getvalue().strip().split("\n")
        assert len(out) == 3
        for line in out:
            f, _, label = line.partition(" -> ")
            expect = os.path.basename(f).replace("t_", "").replace(".wav", "")
            assert label == expect, line


class TestShortUtterances:
    def test_predict_batch_reports_none_for_too_short(self, trained_model):
        good = synth_utterance("alice", 3.0, seed=990)
        tiny = np.zeros(100, np.int16)  # shorter than one frame
        labels = trained_model.predict_batch(FS, [good, tiny])
        assert labels[0] == "alice"
        assert labels[1] is None
