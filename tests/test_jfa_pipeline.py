"""End-to-end JFA workflow: stats -> train v/u -> enroll -> linear scoring
separates speakers under channel variation."""

import numpy as np
import jax
import jax.numpy as jnp

from speaker_recognition.config import GmmConfig
from speaker_recognition.models import gmm
from speaker_recognition.tools import jfa_pipeline


def make_world(K=4, d=6, n_spk=4, seed=0):
    rng = np.random.RandomState(seed)
    ubm_means = rng.randn(K, d) * 2
    ubm_sigmas = 0.6 + 0.2 * rng.rand(K, d)
    ubm = gmm.GmmParams(jnp.asarray(np.full(K, 1.0 / K), jnp.float32),
                        jnp.asarray(ubm_means, jnp.float32),
                        jnp.asarray(ubm_sigmas, jnp.float32))
    spk_offsets = rng.randn(n_spk, d) * 1.2
    chan_dir = rng.randn(d)
    chan_dir /= np.linalg.norm(chan_dir)

    def utterance(spk, chan_strength, n=300, seed=0):
        r = np.random.RandomState(seed)
        comps = r.randint(0, K, n)
        return (ubm_means[comps] + spk_offsets[spk]
                + chan_strength * chan_dir
                + r.randn(n, d) * ubm_sigmas[comps]).astype(np.float32)

    return ubm, utterance


class TestJfaPipeline:
    def test_train_enroll_score(self):
        ubm, utt = make_world()
        n_spk = 4

        # training sessions: every speaker, two channel conditions
        feats, ids = [], []
        s = 0
        for spk in range(n_spk):
            for chan in (-1.0, 1.0):
                for j in range(2):
                    feats.append(utt(spk, chan, seed=100 + s))
                    ids.append(spk)
                    s += 1
        N, F = jfa_pipeline.collect_session_stats(ubm, feats)
        model = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=3, nu=1, n_iter=8)

        # enroll each speaker from fresh sessions
        efeats, eids = [], []
        for spk in range(n_spk):
            efeats.append(utt(spk, 0.5, seed=200 + spk))
            eids.append(spk)
        Ne, Fe = jfa_pipeline.collect_session_stats(ubm, efeats)
        y, z = jfa_pipeline.enroll(model, Ne, Fe, eids, n_spk)

        # test sessions under a different channel
        tfeats, truth = [], []
        for spk in range(n_spk):
            tfeats.append(utt(spk, -0.8, seed=300 + spk))
            truth.append(spk)
        Nt, Ft = jfa_pipeline.collect_session_stats(ubm, tfeats)
        scores = jfa_pipeline.score(model, y, z, Nt, Ft)

        assert scores.shape == (n_spk, n_spk)
        pred = scores.argmax(axis=0)
        acc = (pred == np.asarray(truth)).mean()
        assert acc >= 0.75, (acc, scores)


class TestJfaTextInterchangeCli:
    """The reference's JFA text interchange: per-utterance feature text
    files + logical=physical .lst manifests (gen-features-file.py:95-116,
    parse_list.m), driven end-to-end through the jfa_pipeline CLI."""

    FS = 8000

    def _write_wav(self, path, freqs, seconds, seed):
        import wave

        rng = np.random.RandomState(seed)
        t = np.arange(int(self.FS * seconds)) / self.FS
        sig = sum(np.sin(2 * np.pi * f * t + rng.rand() * 6.28) / (i + 1)
                  for i, f in enumerate(freqs))
        sig += 0.05 * rng.randn(len(t))
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self.FS)
            w.writeframes((sig * 6000).astype(np.int16).tobytes())

    def test_feature_text_and_lst_roundtrip(self, tmp_path):
        from speaker_recognition.utils import serialization

        feat = np.random.RandomState(0).randn(17, 5)
        p = str(tmp_path / "f0")
        serialization.write_feature_text(p, feat)
        np.testing.assert_allclose(serialization.read_feature_text(p), feat)
        lst = str(tmp_path / "x.lst")
        serialization.write_lst(lst, [("spk a", p), ("b", p)])
        assert serialization.read_lst(lst) == [("spk a", p), ("b", p)]

    def test_gen_features_matches_direct_extraction(self, tmp_path, capsys):
        from speaker_recognition.features.extract import mix_feature
        from speaker_recognition.tools import jfa_pipeline
        from speaker_recognition.utils import serialization
        from speaker_recognition.utils.native_io import read_wav

        (tmp_path / "spkA").mkdir()
        for j in range(2):
            self._write_wav(tmp_path / "spkA" / f"u{j}.wav",
                            [230, 690, 1150], 2.0, seed=j)
        fdir = str(tmp_path / "features")
        jfa_pipeline.main(["gen-features", "-i", str(tmp_path / "spkA"),
                           "-o", fdir, "--task", "enroll"])
        assert "2 feature files + enroll.lst" in capsys.readouterr().out
        pairs = serialization.read_lst(f"{fdir}/enroll.lst")
        assert [p[0] for p in pairs] == ["spkA", "spkA"]
        fs, sig = read_wav(str(tmp_path / "spkA" / "u0.wav"))
        direct = mix_feature(fs, sig)
        loaded = serialization.read_feature_text(pairs[0][1])
        np.testing.assert_allclose(loaded, direct, rtol=1e-6, atol=1e-7)

    def test_cli_chain_stats_train_score(self, tmp_path, capsys):
        """stats -> train -> score through the CLI over the text formats,
        on the same well-conditioned world as TestJfaPipeline."""
        from speaker_recognition.tools import jfa_pipeline
        from speaker_recognition.utils import serialization

        ubm, utt = make_world()
        ubm_np = jax.tree.map(np.asarray, ubm)
        ubm_dir = str(tmp_path / "ubm")
        serialization.dump_jfa_supervectors(ubm_np, ubm_dir)

        fdir = tmp_path / "features"
        fdir.mkdir()

        def write_task(task, sessions):
            pairs = []
            for i, (label, feat) in enumerate(sessions):
                p = str(fdir / f"{task}-{label}-{i}")
                serialization.write_feature_text(p, feat)
                pairs.append((label, p))
            serialization.write_lst(str(fdir / f"{task}.lst"), pairs)

        n_spk = 4
        train_sessions = []
        s = 0
        for spk in range(n_spk):
            for chan in (-1.0, 1.0):
                for j in range(2):
                    train_sessions.append(
                        (f"spk{spk}", utt(spk, chan, seed=100 + s)))
                    s += 1
        write_task("enroll", train_sessions)
        write_task("test", [(f"t{spk}", utt(spk, -0.8, seed=300 + spk))
                            for spk in range(n_spk)])

        jfa_pipeline.main(["stats", "--ubm-dir", ubm_dir,
                           "--lst", str(fdir / "enroll.lst"),
                           "-o", str(tmp_path / "enroll_stats.npz")])
        jfa_pipeline.main(["stats", "--ubm-dir", ubm_dir,
                           "--lst", str(fdir / "test.lst"),
                           "-o", str(tmp_path / "test_stats.npz")])
        jfa_pipeline.main(["train", "--ubm-dir", ubm_dir,
                           "--stats", str(tmp_path / "enroll_stats.npz"),
                           "-o", str(tmp_path / "jfa.npz"),
                           "--nv", "3", "--nu", "1", "--iters", "8"])
        capsys.readouterr()
        jfa_pipeline.main(["score", "--ubm-dir", ubm_dir,
                           "--model", str(tmp_path / "jfa.npz"),
                           "--enroll-stats", str(tmp_path / "enroll_stats.npz"),
                           "--test-stats", str(tmp_path / "test_stats.npz")])
        lines = [l for l in capsys.readouterr().out.splitlines() if "->" in l]
        assert len(lines) == n_spk
        preds = [l.split("->")[1].split("(")[0].strip() for l in lines]
        correct = sum(p == f"spk{i}" for i, p in enumerate(preds))
        assert correct >= 3, lines


class TestDivergenceGuard:
    """train_jfa's self-consistency gate (beyond the reference): the
    unregularized ML chain can diverge for an unlucky randn init
    (observed: r5_identity_structure.jsonl seed 1 / nv 8 collapsed to
    chance with EER 1.0); the guard self-scores the training sessions
    and retries with the next derived key."""

    def _world_stats(self):
        ubm, utt = make_world()
        feats, ids = [], []
        s = 0
        for spk in range(4):
            for chan in (-1.0, 1.0):
                for j in range(2):
                    feats.append(utt(spk, chan, seed=100 + s))
                    ids.append(spk)
                    s += 1
        N, F = jfa_pipeline.collect_session_stats(ubm, feats)
        return ubm, N, F, ids

    def test_healthy_training_unchanged_by_guard(self):
        """Attempt 0 uses the exact pre-guard init key, so a healthy run
        returns the identical model whether or not retries are allowed."""
        ubm, N, F, ids = self._world_stats()
        m1 = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=3, nu=1, n_iter=8,
                                    retries=1)
        m3 = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=3, nu=1, n_iter=8,
                                    retries=3)
        for a, b in zip(m1.hyper, m3.hyper):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_self_consistency_separates_healthy_from_corrupt(self):
        ubm, N, F, ids = self._world_stats()
        model = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=3, nu=1, n_iter=8)
        healthy = jfa_pipeline._self_consistency(model, N, F, ids)
        assert healthy >= 0.75, healthy
        # corrupt the eigenvoices the way a diverged run looks: garbage v
        rng = np.random.RandomState(0)
        bad_v = jnp.asarray(
            rng.randn(*np.asarray(model.hyper.v).shape).astype(np.float32)
            * 1e3)
        bad = jfa_pipeline.JfaModel(
            hyper=model.hyper._replace(v=bad_v),
            n_components=model.n_components)
        corrupt = jfa_pipeline._self_consistency(bad, N, F, ids)
        assert corrupt < healthy, (corrupt, healthy)

    def test_gate_satisfiable_for_tiny_banks(self):
        """max(0.5, 3/n) was >= 1.0 for n <= 3 speakers: unreachable, so
        every tiny-bank training burned all retries. The capped gate must
        accept a perfect 2-speaker model on the first attempt (retries=1
        == retries=3 when healthy)."""
        ubm, utt = make_world(n_spk=2)
        feats, ids = [], []
        s = 0
        for spk in range(2):
            for chan in (-1.0, 1.0):
                for j in range(2):
                    feats.append(utt(spk, chan, seed=100 + s))
                    ids.append(spk)
                    s += 1
        N, F = jfa_pipeline.collect_session_stats(ubm, feats)
        m1 = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=2, nu=1, n_iter=8,
                                    retries=1)
        m3 = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=2, nu=1, n_iter=8,
                                    retries=3)
        for a, b in zip(m1.hyper, m3.hyper):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_self_consistency_handles_noncontiguous_ids(self):
        """Non-zero-based / gappy speaker labels must not enroll phantom
        zero-stat speakers inside the gate check."""
        ubm, N, F, ids = self._world_stats()
        model = jfa_pipeline.train_jfa(ubm, N, F, ids, nv=3, nu=1, n_iter=8)
        shifted = [i * 3 + 5 for i in ids]   # e.g. 5, 8, 11, 14
        a = jfa_pipeline._self_consistency(model, N, F, ids)
        b = jfa_pipeline._self_consistency(model, N, F, shifted)
        assert a == b, (a, b)
