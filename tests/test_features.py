"""Golden-value tests: the JAX feature pipeline vs NumPy float64 oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speaker_recognition.config import FeatureConfig, LpcConfig, MfccConfig
from speaker_recognition.features import extract
from speaker_recognition.ops import frontend, levinson

import oracles


def synth_speech(n, fs=8000, seed=0):
    """Speech-ish test signal: sum of harmonics with noise, int16 scale."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.3 * t)
    sig = sum(np.sin(2 * np.pi * f0 * (h + 1) * t + rng.rand()) / (h + 1)
              for h in range(5))
    sig = sig * (0.5 + 0.5 * np.sin(2 * np.pi * 2.1 * t) ** 2)
    sig += 0.01 * rng.randn(n)
    return (sig * 8000).astype(np.int16)


class TestFrontendConstants:
    def test_hamming_matches_oracle(self):
        np.testing.assert_allclose(frontend.hamming(256), oracles.oracle_hamming(256))

    @pytest.mark.parametrize("fs,nfft,nb", [(8000, 2048, 50), (8000, 2048, 55),
                                            (16000, 2048, 50), (44100, 4096, 40)])
    def test_mel_filterbank_matches_loop_transcription(self, fs, nfft, nb):
        ours = frontend.mel_filterbank(fs, nfft, nb)
        ref = oracles.oracle_mel_filterbank(fs, nfft, nb)
        np.testing.assert_allclose(ours, ref, atol=1e-12)
        assert ours.shape == (nb, nfft // 2 + 1)
        # every filter should have positive mass
        assert (ours.sum(axis=1) > 0).all()

    def test_dct_matrix(self):
        np.testing.assert_allclose(frontend.dct_matrix(50), oracles.oracle_dctmtx(50))
        # orthonormal
        D = frontend.dct_matrix(32)
        np.testing.assert_allclose(D @ D.T, np.eye(32), atol=1e-12)

    def test_dft_power_projection_matches_fft(self):
        rng = np.random.RandomState(1)
        x = rng.randn(256)
        C, S = frontend.dft_power_projection(256, 2048)
        power = (x @ C) ** 2 + (x @ S) ** 2
        ref = np.abs(np.fft.fft(x, 2048)[:1025]) ** 2
        np.testing.assert_allclose(power, ref, rtol=1e-9, atol=1e-9)

    def test_windowed_preemph_operator(self):
        rng = np.random.RandomState(2)
        x = rng.randn(256)
        B = frontend.windowed_preemph_operator(256, 0.95)
        y = x * oracles.oracle_hamming(256)
        y[1:] -= y[:-1] * 0.95
        np.testing.assert_allclose(B @ x, y, atol=1e-12)


class TestMfcc:
    def test_mfcc_matches_oracle_f64(self):
        sig = synth_speech(8000 * 3)
        ours = extract.mfcc_extract(8000, sig, dtype="float64")
        ref = oracles.oracle_mfcc(8000, sig)
        assert ours.shape == ref.shape == ((8000 * 3 - 256) // 128 + 1, 13)
        np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-8)

    def test_mfcc_f32_close(self):
        sig = synth_speech(8000 * 2, seed=3)
        ours = extract.mfcc_extract(8000, sig, dtype="float32")
        ref = oracles.oracle_mfcc(8000, sig)
        # CMVN'd features are O(1); float32 DFT of a 256-pt frame stays tight.
        np.testing.assert_allclose(ours, ref, atol=5e-3)

    def test_too_short_raises(self):
        with pytest.raises(ValueError):
            extract.mfcc_extract(8000, np.zeros(256 * 5, dtype=np.int16))


class TestBobStyleMfcc:
    """The bob.ap.Ceps-flavored extractor (src/feature/BOB.py:13-18):
    bounded triangular mel bank, 55 filters / 19 ceps / f in [0,6000],
    pre-emphasis before the window."""

    def test_bounded_filterbank_matches_loop_oracle(self):
        M = frontend.mel_filterbank_bounded(8000, 2048, 55, 0.0, 6000.0)
        # f_max clamps to Nyquist (bob's default 6000 vs fs=8000 corpora)
        ref = oracles.oracle_mel_filterbank_bounded(8000, 2048, 55, 0.0, 4000.0)
        assert M.shape == (55, 1025)
        np.testing.assert_allclose(M, ref, rtol=1e-12, atol=1e-12)
        # every filter has support and peaks at <= 1
        assert (M.max(axis=1) > 0).all() and M.max() <= 1.0 + 1e-12

    def test_linear_scale_bank(self):
        M = frontend.mel_filterbank_bounded(8000, 512, 20, 100.0, 3500.0,
                                            mel_scale=False)
        ref = oracles.oracle_mel_filterbank_bounded(8000, 512, 20, 100.0,
                                                    3500.0, mel_scale=False)
        np.testing.assert_allclose(M, ref, rtol=1e-12, atol=1e-12)

    def test_bob_mfcc_matches_oracle_f64(self):
        from speaker_recognition.config import bob_mfcc_config
        sig = synth_speech(8000 * 2, seed=5)
        cfg = bob_mfcc_config()
        ours = extract.mfcc_extract(8000, sig, cfg, dtype="float64")
        ref = oracles.oracle_mfcc_bob(8000, sig)
        assert ours.shape == ref.shape == ((8000 * 2 - 256) // 128 + 1, 19)
        np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-8)

    def test_bob_mfcc_packed_matches_full(self):
        from speaker_recognition.config import bob_mfcc_config
        sig = synth_speech(8000 * 2, seed=7)
        cfg = bob_mfcc_config()
        full = extract._feature_fn(
            8000, FeatureConfig(mfcc=cfg, use_lpc=False), 16384, "float64",
            "full")
        packed = extract._feature_fn(
            8000, FeatureConfig(mfcc=cfg, use_lpc=False), 16384, "float64",
            "packed")
        x = np.zeros(16384)
        x[: len(sig)] = sig
        xb = jnp.asarray(x)[None, :]
        lb = jnp.asarray([len(sig)])
        a, _ = full(xb, lb)
        b, _ = packed(xb, lb)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-10)

    def test_mix_feature_with_bob_mfcc(self):
        from speaker_recognition.config import bob_mfcc_config
        sig = synth_speech(8000 * 2, seed=9)
        cfg = FeatureConfig(mfcc=bob_mfcc_config(), use_lpc=True)
        feat = extract.mix_feature(8000, sig, cfg)
        assert feat.shape[1] == 19 + 15
        assert np.isfinite(feat).all()


class TestLpc:
    def test_levinson_matches_oracle(self):
        rng = np.random.RandomState(4)
        x = rng.randn(256)
        r = np.array([np.dot(x[: 256 - j], x[j:]) for j in range(16)]) / 256
        a_ref, e_ref = oracles.oracle_levinson(r, 15)
        a, e = levinson.levinson(jnp.asarray(r))
        np.testing.assert_allclose(np.asarray(a), a_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(e), e_ref, rtol=1e-8)

    def test_lpc_matches_oracle_f64(self):
        sig = synth_speech(8000 * 2, seed=5)
        ours = extract.lpc_extract(8000, sig, dtype="float64")
        ref = oracles.oracle_lpc(8000, sig)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-8)

    def test_zero_frames_give_zero_lpc(self):
        frames = jnp.zeros((4, 256))
        out = levinson.lpc_from_frames(frames, 15)
        np.testing.assert_array_equal(np.asarray(out), 0.0)


class TestMixAndBatch:
    def test_mix_feature_dim(self):
        sig = synth_speech(8000 * 2, seed=6)
        feat = extract.mix_feature(8000, sig, dtype="float64")
        assert feat.shape[1] == 28  # 13 MFCC + 15 LPC
        np.testing.assert_allclose(feat[:, :13], oracles.oracle_mfcc(8000, sig),
                                   rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(feat[:, 13:], oracles.oracle_lpc(8000, sig),
                                   rtol=1e-6, atol=1e-8)

    def test_batched_ragged_matches_single(self):
        cfg = FeatureConfig()
        lens = [8000 * 2, 8000 * 3, 8000 * 2 + 977]
        sigs = [synth_speech(l, seed=10 + i) for i, l in enumerate(lens)]
        L = max(lens)
        batch = np.zeros((3, L), dtype=np.float32)
        for i, s in enumerate(sigs):
            batch[i, : len(s)] = s
        feats, mask = extract.extract_batch(
            jnp.asarray(batch), jnp.asarray(lens), 8000, cfg, dtype="float64")
        for i, s in enumerate(sigs):
            single = extract.mix_feature(8000, s, cfg, dtype="float64")
            T = single.shape[0]
            assert int(mask[i].sum()) == T
            np.testing.assert_allclose(np.asarray(feats[i, :T]), single,
                                       rtol=1e-7, atol=1e-8)
            np.testing.assert_array_equal(np.asarray(feats[i, T:]), 0.0)

    def test_packed_matches_full_frontend(self):
        """The packed half-spectrum frontend (512-pt DFT + exact linear maps,
        ops/frontend.packed_frontend_operators) must reproduce the full
        2048-bin path to rounding, in f64 and f32."""
        cfg = FeatureConfig()
        sig = synth_speech(8000 * 2, seed=21)
        pad = np.zeros((1, 16384), np.float32)
        pad[0, : len(sig)] = sig
        lens = jnp.asarray([len(sig)])
        for dtype, rtol, atol in (("float64", 1e-9, 1e-10),
                                  ("float32", 2e-3, 2e-3)):
            full = extract._feature_fn(8000, cfg, 16384, dtype,
                                       "full")(jnp.asarray(pad), lens)[0]
            packed = extract._feature_fn(8000, cfg, 16384, dtype,
                                         "packed")(jnp.asarray(pad), lens)[0]
            np.testing.assert_allclose(np.asarray(packed), np.asarray(full),
                                       rtol=rtol, atol=atol)

    def test_diff_feature(self):
        f = np.arange(20.0).reshape(10, 2)
        d1 = extract.diff_feature(f, nd=1)
        assert d1.shape == (9, 4)
        d2 = extract.diff_feature(f, nd=2)
        assert d2.shape == (8, 6)

    def test_multichannel_averaged(self):
        sig = synth_speech(8000 * 2, seed=7).astype(np.float64)
        stereo = np.stack([sig, sig], axis=1)
        a = extract.mix_feature(8000, sig, dtype="float64")
        b = extract.mix_feature(8000, stereo, dtype="float64")
        np.testing.assert_allclose(a, b)


class TestLpcc:
    def oracle_lpc_to_cc(self, a_full, n_lpc, n_lpcc):
        """Literal transcription of src/feature/LPC.py:27-38."""
        lpcc = np.zeros(n_lpcc)
        lpcc[0] = a_full[0]
        for n in range(1, n_lpc):
            lpcc[n] = a_full[n]
            for l in range(0, n):
                lpcc[n] += a_full[l] * lpcc[n - l - 1] * (n - l) / (n + 1)
        for n in range(n_lpc, n_lpcc):
            lpcc[n] = 0
            for l in range(0, n_lpc):
                lpcc[n] += a_full[l] * lpcc[n - l - 1] * (n - l) / (n + 1)
        return -lpcc[1:]

    def test_lpcc_matches_oracle(self):
        from speaker_recognition.ops.levinson import lpcc_from_lpc
        rng = np.random.RandomState(8)
        p = 15
        a = np.concatenate([[1.0], rng.randn(p) * 0.3])
        ref = self.oracle_lpc_to_cc(a, p, 20)
        out = np.asarray(lpcc_from_lpc(jnp.asarray(a), 20))
        np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-10)
        # batched agrees with single
        batch = np.stack([a, a * 0.5])
        outb = np.asarray(lpcc_from_lpc(jnp.asarray(batch), 20))
        np.testing.assert_allclose(outb[0], ref, rtol=1e-8, atol=1e-10)

    def test_extractor_lpcc_mode(self):
        from speaker_recognition.config import FeatureConfig, LpcConfig
        sig = synth_speech(8000 * 2, seed=9)
        cfg = FeatureConfig(lpc=LpcConfig(n_lpcc=13))
        feat = extract.mix_feature(8000, sig, cfg, dtype="float64")
        assert feat.shape[1] == cfg.dim == 13 + 12
        assert np.isfinite(feat).all()


FS = 8000


class TestDeltaFeatures:
    """Device-path delta features (FeatureConfig.n_deltas) vs the host
    diff_feature helper / reference utils.py:24-31 semantics."""

    def _sig(self, seconds=1.2, seed=0):
        rng = np.random.RandomState(seed)
        n = int(FS * seconds)
        t = np.arange(n) / FS
        return ((np.sin(2 * np.pi * 260 * t) + 0.1 * rng.randn(n))
                * 8000).astype(np.float64)

    @pytest.mark.parametrize("nd", [1, 2])
    def test_matches_host_diff_feature(self, nd):
        sig = self._sig()
        base_cfg = FeatureConfig()
        base = extract.mix_feature(FS, sig, base_cfg, dtype="float64")
        want = extract.diff_feature(base, nd=nd)
        cfg = FeatureConfig(n_deltas=nd)
        got = extract.mix_feature(FS, sig, cfg, dtype="float64")
        assert got.shape == want.shape == (base.shape[0] - nd, cfg.dim)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_batched_mask_shrinks_by_nd(self):
        from speaker_recognition.config import frame_geometry, n_frames
        sig = self._sig(1.0)
        padded = np.zeros(8192, np.float32)
        padded[: len(sig)] = sig
        batch = jnp.asarray(padded)[None, :]
        lengths = jnp.asarray([len(sig)])
        cfg = FeatureConfig(n_deltas=1)
        feats, mask = extract.extract_batch(batch, lengths, FS, cfg)
        flen, fshift = frame_geometry(FS, 32, 16)
        T = n_frames(len(sig), flen, fshift)
        m = np.asarray(mask[0])
        assert m[: T - 1].all() and not m[T - 1:].any()
        assert feats.shape[-1] == cfg.dim
        # padding rows zeroed
        assert (np.asarray(feats[0])[T - 1:] == 0).all()


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr, nested jaxprs too."""
    import jax
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(getattr(sub.jaxpr, "jaxpr", sub.jaxpr))
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


class TestMatmulPrecisionPinned:
    """The frontend and the GMM math request float32 products explicitly,
    so a backend whose DEFAULT float32 matmul is TF32 (the GPU) computes
    the same features and scores as the CPU (tests_gpu and chip_smoke.py
    check the on-card numbers)."""

    HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)

    def test_frontend_dots_are_highest(self):
        sig = jnp.zeros((2, 8192), jnp.float32)
        lens = jnp.asarray([8192, 4000])
        for mode in ("packed", "full"):
            fn = extract._feature_fn(8000, FeatureConfig(), 8192, "float32",
                                     mode)
            precs = _dot_precisions(fn, sig, lens)
            assert precs and all(p == self.HIGHEST for p in precs), precs

    def test_scoring_and_em_dots_are_highest(self):
        from speaker_recognition.api import fastpath
        from speaker_recognition.config import GmmConfig
        from speaker_recognition.models import gmm
        bank = gmm.GmmParams(jnp.full((2, 4), 0.25), jnp.zeros((2, 4, 28)),
                             jnp.ones((2, 4, 28)))
        fn = fastpath.scores_fn(8000, FeatureConfig(), 8192, "float32", "xla")
        precs = _dot_precisions(fn, jnp.zeros((2, 8192), jnp.float32),
                                jnp.asarray([8192, 4000]), bank)
        X, m = jnp.zeros((64, 28)), jnp.ones(64, bool)
        cfg = GmmConfig(n_mixtures=4, n_iterations=2)
        precs += _dot_precisions(
            lambda x, mm: gmm.fit(x, mm, cfg, jax.random.PRNGKey(0)), X, m)
        precs += _dot_precisions(
            lambda x, mm: gmm.bank_avg_loglik(bank, x, mm), X, m)
        assert precs and all(p == self.HIGHEST for p in precs), precs


def test_global_precision_context_cannot_lower_features():
    """Under a process-wide bfloat16 matmul default the extractor still
    computes the float32 features."""
    sig = jnp.asarray(np.random.RandomState(0).randn(2, 8192)
                      .astype(np.float32) * 1000)
    lens = jnp.asarray(np.array([8000, 6000], np.int32))
    base = np.asarray(extract.extract_batch(sig, lens, FS)[0])
    with jax.default_matmul_precision("bfloat16"):
        low = np.asarray(extract.extract_batch(sig, lens, FS)[0])
    np.testing.assert_array_equal(low, base)


def _ragged(lengths, L, seed, scale=500.0):
    rng = np.random.RandomState(seed)
    sig = np.zeros((len(lengths), L), np.float64)
    for i, n in enumerate(lengths):
        sig[i, :n] = rng.randn(n) * scale
    return sig


class TestPackedFrontendSemantics:
    """The packed XLA frontend on the batch shapes and configs the removed
    signal-level kernel was tested on: an odd batch, MFCC only, and LPC
    with per-utterance CMVN over ragged lengths, against the float64
    oracles and the full-spectrum frontend."""

    @pytest.mark.parametrize("B", [1, 3])
    def test_odd_batch(self, B):
        L = 8192
        sig = _ragged([L - 37 * i for i in range(B)], L, seed=3)
        lens = jnp.asarray([L - 37 * i for i in range(B)])
        cfg = FeatureConfig()
        packed, m1 = extract._feature_fn(8000, cfg, L, "float64", "packed")(
            jnp.asarray(sig), lens)
        full, m2 = extract._feature_fn(8000, cfg, L, "float64", "full")(
            jnp.asarray(sig), lens)
        T = (L - 256) // 128 + 1
        assert packed.shape == (B, T, 28)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
        np.testing.assert_allclose(np.asarray(packed), np.asarray(full),
                                   rtol=1e-9, atol=1e-10)

    def test_mfcc_only(self):
        L = 8192
        sig = _ragged([L, 6000], L, seed=4)
        cfg = FeatureConfig(use_lpc=False)
        feats, mask = extract._feature_fn(8000, cfg, L, "float64",
                                          "packed")(jnp.asarray(sig),
                                                    jnp.asarray([L, 6000]))
        assert feats.shape[-1] == 13
        for i, n in enumerate([L, 6000]):
            want = oracles.oracle_mfcc(8000, sig[i, :n])
            T = want.shape[0]
            assert int(np.asarray(mask[i]).sum()) == T
            np.testing.assert_allclose(np.asarray(feats[i, :T]), want,
                                       rtol=1e-7, atol=1e-8)

    def test_lpc_and_cmvn_ragged(self):
        L = 8192
        lengths = [7000, 8192, 2000]
        sig = _ragged(lengths, L, seed=11)
        feats, mask = extract.extract_batch(
            jnp.asarray(sig), jnp.asarray(lengths), 8000, FeatureConfig(),
            dtype="float64")
        for i, n in enumerate(lengths):
            want = np.concatenate([oracles.oracle_mfcc(8000, sig[i, :n]),
                                   oracles.oracle_lpc(8000, sig[i, :n])], 1)
            T = want.shape[0]
            m = np.asarray(mask[i])
            assert m[:T].all() and not m[T:].any()
            # CMVN'd MFCC: zero mean, unit variance over the valid frames
            got = np.asarray(feats[i, :T])
            np.testing.assert_allclose(got[:, :13].mean(0), 0.0, atol=1e-9)
            np.testing.assert_allclose(got[:, :13].std(0), 1.0, rtol=1e-9)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
            np.testing.assert_array_equal(np.asarray(feats[i, T:]), 0.0)
