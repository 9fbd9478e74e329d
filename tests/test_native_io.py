"""Native IO runtime tests: C++ wav decode + batch loader vs scipy, and the
C++ silence gate vs the reference-semantics Python implementation."""

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from speaker_recognition.utils import native_io
from speaker_recognition.vad.energy import remove_silence


@pytest.fixture(scope="module")
def lib():
    lib = native_io.load_library()
    if lib is None:
        pytest.skip("native library not built and no toolchain")
    return lib


def make_wav(tmp_path, name, fs=8000, seconds=1.0, seed=0, stereo=False,
             dtype=np.int16):
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    sig = (np.sin(2 * np.pi * 440 * np.arange(n) / fs) * 8000
           + rng.randn(n) * 10).astype(dtype)
    if stereo:
        sig = np.stack([sig, (sig * 0.5).astype(dtype)], axis=1)
    path = str(tmp_path / name)
    wavfile.write(path, fs, sig)
    return path, sig


class TestRead:
    def test_matches_scipy_int16(self, lib, tmp_path):
        path, sig = make_wav(tmp_path, "a.wav")
        fs, out = native_io.read_wav(path)
        assert fs == 8000
        np.testing.assert_array_equal(out.astype(np.int16), sig)

    def test_stereo_takes_channel0(self, lib, tmp_path):
        path, sig = make_wav(tmp_path, "s.wav", stereo=True, seed=1)
        fs, out = native_io.read_wav(path)
        np.testing.assert_array_equal(out.astype(np.int16), sig[:, 0])

    def test_missing_file_falls_back_or_raises(self, lib, tmp_path):
        with pytest.raises(Exception):
            native_io.read_wav(str(tmp_path / "nope.wav"))


class TestBatch:
    def test_batch_matches_individual(self, lib, tmp_path):
        paths = []
        sigs = []
        for i, sec in enumerate([0.5, 1.0, 0.75]):
            p, s = make_wav(tmp_path, f"b{i}.wav", seconds=sec, seed=10 + i)
            paths.append(p)
            sigs.append(s)
        batch, lengths, fss = native_io.load_batch(paths)
        assert batch.shape[0] == 3
        assert batch.shape[1] % 4096 == 0
        for i, s in enumerate(sigs):
            assert lengths[i] == len(s)
            assert fss[i] == 8000
            np.testing.assert_array_equal(batch[i, : len(s)].astype(np.int16), s)
            np.testing.assert_array_equal(batch[i, len(s):], 0.0)

    def test_batch_with_bad_file(self, lib, tmp_path):
        good, sig = make_wav(tmp_path, "g.wav", seed=3)
        bad = str(tmp_path / "bad.wav")
        with open(bad, "wb") as f:
            f.write(b"not a wav at all")
        batch, lengths, fss = native_io.load_batch([good, bad])
        assert lengths[0] == len(sig)
        assert lengths[1] == 0

    def test_batch_silence_removal_matches_python(self, lib, tmp_path):
        fs = 8000
        rng = np.random.RandomState(4)
        sig = np.zeros(fs * 2, np.int16)
        sig[4000:9000] = (np.sin(2 * np.pi * 300 * np.arange(5000) / fs)
                          * 8000).astype(np.int16)
        sig += (rng.randn(len(sig)) * 3).astype(np.int16)
        path = str(tmp_path / "sil.wav")
        wavfile.write(path, fs, sig)

        batch, lengths, fss = native_io.load_batch([path], remove_silence=True)
        ref = remove_silence(fs, sig)
        assert lengths[0] == len(ref)
        np.testing.assert_allclose(batch[0, : lengths[0]].astype(np.int64),
                                   ref.astype(np.int64), atol=1)
