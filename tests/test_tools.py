"""Tools layer: UBM workflow, gmm CLI (reference-format interchange),
corpus prep, svm IO, NeuralNet, conversation mode."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.io.wavfile as wavfile

from speaker_recognition.config import GmmConfig
from speaker_recognition.models import gmm
from speaker_recognition.tools import corpus, gmm_cli, ubm
from speaker_recognition.utils import datamanip, serialization


def blobs(n=400, d=4, K=2, seed=0):
    rng = np.random.RandomState(seed)
    mu = rng.randn(K, d) * 3
    comps = rng.randint(0, K, n)
    return mu[comps] + rng.randn(n, d) * 0.5


class TestUbmTools:
    def test_train_and_adapt(self):
        feats = [blobs(seed=i) for i in range(3)]
        u = ubm.train_ubm(feats, n_mixtures=4, n_iterations=30)
        assert u.means.shape == (4, 4)
        labels, bank = ubm.adapt_speakers(
            u, {"a": blobs(seed=10), "b": blobs(seed=11)},
            GmmConfig(n_mixtures=4, n_iterations=10))
        assert labels == ["a", "b"]
        assert bank.means.shape == (2, 4, 4)
        # weights pinned to UBM under MAP
        np.testing.assert_allclose(bank.weights[0], u.weights, rtol=1e-6)


class TestGmmCli:
    def test_train_then_score_roundtrip(self, tmp_path):
        X = blobs(n=500, seed=3)
        data = tmp_path / "data.txt"
        np.savetxt(data, X)
        model = str(tmp_path / "gmm.model")
        buf = io.StringIO()
        with redirect_stdout(buf):
            gmm_cli.main(["train", "-k", "4", "-i", str(data), "-m", model,
                          "-r", "30"])
        assert "trained K=4" in buf.getvalue()
        # model is reference text format
        with open(model) as f:
            params = serialization.load_reference_gmm(f)
        assert params.means.shape == (4, 4)

        buf = io.StringIO()
        with redirect_stdout(buf):
            gmm_cli.main(["score", "-k", "4", "-i", str(data), "-m", model])
        score = float(buf.getvalue().strip())
        # should be close to the model's own avg ll
        ref = float(gmm.avg_loglik(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params),
            jnp.asarray(X, jnp.float32), jnp.ones(len(X), dtype=bool)))
        assert abs(score - ref) < 1e-4

    def test_kmeans_init_flag(self, tmp_path):
        X = blobs(n=300, seed=4)
        data = tmp_path / "d.txt"
        np.savetxt(data, X)
        model = str(tmp_path / "m.model")
        with redirect_stdout(io.StringIO()):
            gmm_cli.main(["train", "-k", "2", "-i", str(data), "-m", model,
                          "-r", "20", "-f", "1"])
        with open(model) as f:
            params = serialization.load_reference_gmm(f)
        assert np.isfinite(params.means).all()


class TestCorpusTools:
    def test_split_wav(self, tmp_path):
        fs = 8000
        sig = (np.random.RandomState(0).randn(fs * 50) * 1000).astype(np.int16)
        src = str(tmp_path / "spk.wav")
        wavfile.write(src, fs, sig)
        out = str(tmp_path / "out")
        corpus.split_wav(src, out, train_time=10.0, test_time=2.0, nr_test=5)
        fs2, train = wavfile.read(os.path.join(out, "train.wav"))
        assert len(train) == fs * 10
        for i in range(5):
            fs2, t = wavfile.read(os.path.join(out, f"test-{i}.wav"))
            assert len(t) == fs * 2

    def test_remove_silence_corpus(self, tmp_path):
        fs = 8000
        sig = np.zeros(fs * 2, np.int16)
        sig[2000:6000] = 5000
        src = tmp_path / "in"
        src.mkdir()
        wavfile.write(str(src / "x.wav"), fs, sig)
        out = corpus.remove_silence_corpus(str(src / "*.wav"),
                                           str(tmp_path / "out"))
        assert len(out) == 1
        fs2, cleaned = wavfile.read(out[0])
        assert 0 < len(cleaned) < len(sig)


class TestSvmIo:
    def test_roundtrip(self, tmp_path):
        X = np.array([[1.0, 0.0, 2.5], [0.0, 3.0, 0.0]])
        y = np.array([1, 0])
        p = str(tmp_path / "d.svm")
        datamanip.write_svm_data(p, X, y)
        X2, y2 = datamanip.read_svm_data(p)
        np.testing.assert_allclose(X2, X)
        np.testing.assert_array_equal(y2, y)

    def test_fixed_dim(self, tmp_path):
        p = str(tmp_path / "d.svm")
        with open(p, "w") as f:
            f.write("1 1:0.5\n0 2:1.5\n")
        X, y = datamanip.read_svm_data(p, dim=4)
        assert X.shape == (2, 4)


class TestCrbmCli:
    def test_train_checkpointed_then_test_from_npz_and_text(self, tmp_path,
                                                            capsys):
        from speaker_recognition.tools import crbm_cli

        rng = np.random.RandomState(0)
        centers = [rng.randn(5) * 2 for _ in range(2)]
        Xtr = np.vstack([c + 0.1 * rng.randn(60, 5) for c in centers])
        ytr = np.repeat([0, 1], 60)
        Xte = np.vstack([c + 0.1 * rng.randn(10, 5) for c in centers])
        yte = np.repeat([0, 1], 10)
        tr, te = str(tmp_path / "tr.svm"), str(tmp_path / "te.svm")
        datamanip.write_svm_data(tr, Xtr, ytr)
        datamanip.write_svm_data(te, Xte, yte)
        model = str(tmp_path / "bank.npz")
        text_dir = str(tmp_path / "text_models")
        crbm_cli.main(["train", "-i", tr, "-m", model, "--hidden", "6",
                       "--epochs", "20", "--batch-size", "30",
                       "--save-every", "8", "--text-dir", text_dir])
        out = capsys.readouterr().out
        assert "checkpoint at epoch 8/20" in out
        assert "checkpoint at epoch 20/20" in out

        crbm_cli.main(["test", "-i", te, "-m", model])
        acc_npz = float(capsys.readouterr().out.split("=")[-1])
        assert acc_npz >= 0.9

        # reference-format text models load as a bank and agree
        crbm_cli.main(["test", "-i", te, "-m", text_dir])
        acc_text = float(capsys.readouterr().out.split("=")[-1])
        assert acc_text == acc_npz


class TestNeuralNet:
    def test_learns_xor_ish(self):
        from speaker_recognition.models.neural_net import NeuralNet
        rng = np.random.RandomState(0)
        X = rng.rand(400, 2)
        y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5)).astype(int)
        nn = NeuralNet(n_iter=500, learning_rate=2.0, batch_size=32)
        nn.add_layer(8)
        nn.fit(X, y)
        acc = (nn.predict(X) == y).mean()
        assert acc > 0.9, acc

    def test_dbn_pretraining_runs(self):
        from speaker_recognition.models.neural_net import NeuralNet
        rng = np.random.RandomState(1)
        X = (rng.rand(200, 6) > 0.5).astype(np.float32)
        y = (X.sum(axis=1) > 3).astype(int)
        nn = NeuralNet(n_iter=50, learning_rate=0.5)
        nn.add_layer(5)
        nn.fit_dbn(X, y)
        assert nn.predict(X).shape == (200,)


class TestConversation:
    def test_streaming_with_smoothing(self):
        from speaker_recognition.api.conversation import ConversationSession

        class FakeModel:
            def __init__(self):
                self.labels = iter(["alice"] * 5 + ["bob"] * 5)

            def filter(self, fs, sig):
                return sig

            def predict(self, fs, sig):
                return next(self.labels, "bob")

        sess = ConversationSession(FakeModel(), fs=8000)
        events = sess.feed(np.zeros(8000 * 4))
        # 10 ticks: alice shown, then the a->b flip suppressed one tick
        labels = [l for _, l in sess.timeline]
        assert labels[0] == "alice"
        assert "bob" in labels
        # one-step smoothing: the transition tick still shows alice
        assert sess.result_list[:5] == ["alice"] * 5

    def test_long_stream_buffer_bounded(self):
        from speaker_recognition.api.conversation import ConversationSession

        class FakeModel:
            def filter(self, fs, sig):
                return sig

            def predict(self, fs, sig):
                return "alice"

        sess = ConversationSession(FakeModel(), fs=8000)
        for _ in range(100):
            sess.feed(np.zeros(8000))  # 100 s of audio
        # buffer keeps only ~ the trailing analysis window, not the history
        assert len(sess.buffer) <= int(8000 * 2.5)
        assert len(sess.result_list) == 250  # 100 s / 0.4 s ticks


class TestCheckpointedUbm:
    def test_checkpoint_written_and_resumed(self, tmp_path):
        ckpt = str(tmp_path / "ubm.ckpt")
        feats = [blobs(seed=i) for i in range(2)]
        u1 = ubm.train_ubm(feats, n_mixtures=3, n_iterations=20,
                           threshold=0.0, checkpoint_path=ckpt,
                           checkpoint_every=10)
        assert os.path.exists(ckpt)
        with open(ckpt) as f:
            on_disk = serialization.load_reference_gmm(f)
        np.testing.assert_allclose(on_disk.means, u1.means, rtol=1e-6)
        # resume: starts from the checkpoint, not from scratch
        u2 = ubm.train_ubm(feats, n_mixtures=3, n_iterations=10,
                           threshold=0.0, checkpoint_path=ckpt,
                           checkpoint_every=10)
        assert np.isfinite(u2.means).all()


class TestProfiling:
    """utils/profiling: the phase timer, metric dump and the roofline
    against the device_kind peak table; pin their contracts."""

    def test_phase_timer_records_and_syncs(self):
        import jax.numpy as jnp
        from speaker_recognition.utils import profiling

        n0 = len(profiling.metrics)
        with profiling.phase_timer("test-phase", foo=1) as holder:
            holder["sync"] = jnp.ones((8, 8)) @ jnp.ones((8, 8))
        rec = profiling.metrics[-1]
        assert len(profiling.metrics) == n0 + 1
        assert rec["phase"] == "test-phase" and rec["foo"] == 1
        assert rec["seconds"] > 0

    def test_dump_metrics_jsonl(self, tmp_path):
        import json
        from speaker_recognition.utils import profiling

        with profiling.phase_timer("dump-check"):
            pass
        path = str(tmp_path / "m.jsonl")
        profiling.dump_metrics(path)
        rows = [json.loads(l) for l in open(path)]
        assert any(r["phase"] == "dump-check" for r in rows)

    def test_roofline_bounds(self):
        from speaker_recognition.utils import profiling

        h100 = "NVIDIA H100 80GB HBM3"
        # compute-bound case: high intensity, TF32 peak at default precision
        r = profiling.roofline(flops=1e12, bytes_moved=1e6, seconds=0.1,
                               device_kind=h100)
        assert r["bound"] == "compute"
        assert r["peak_tflops"] == 495.0
        assert 0 < r["fraction_of_roofline"] <= 1.0
        # memory-bound case
        r = profiling.roofline(flops=1e6, bytes_moved=1e9, seconds=0.01,
                               device_kind=h100)
        assert r["bound"] == "memory"
        assert r["intensity_flops_per_byte"] < 1
        # HIGHEST runs full float32 products off the tensor cores
        assert profiling.matmul_peak_tflops(h100, "f32", "highest") == 67.0
        assert profiling.matmul_peak_tflops(h100, "bf16") == 989.0
        with pytest.raises(ValueError, match="impossible"):
            profiling.roofline(flops=1e15, bytes_moved=1e6, seconds=1e-3,
                               device_kind=h100)

    def test_unknown_device_kind_raises(self):
        from speaker_recognition.utils import profiling

        for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
            with pytest.raises(ValueError, match="no published peaks"):
                profiling.device_peaks(kind)
            with pytest.raises(ValueError):
                profiling.roofline(1e9, 1e6, 1.0, device_kind=kind)
