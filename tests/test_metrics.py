"""EER/DET metric tests."""

import numpy as np

from speaker_recognition.utils.metrics import accuracy, det_points, eer


class TestEer:
    def test_perfect_separation(self):
        e, thr = eer([10, 11, 12], [1, 2, 3])
        assert e == 0.0
        assert 3 < thr <= 10

    def test_complete_overlap(self):
        rng = np.random.RandomState(0)
        s = rng.randn(2000)
        e, _ = eer(s, rng.randn(2000))
        assert abs(e - 0.5) < 0.05

    def test_known_gaussians(self):
        # genuine ~ N(2,1), imposter ~ N(0,1): EER = Phi(-1) ~ 0.1587
        rng = np.random.RandomState(1)
        e, thr = eer(rng.randn(20000) + 2.0, rng.randn(20000))
        assert abs(e - 0.1587) < 0.01, e
        assert abs(thr - 1.0) < 0.1, thr

    def test_det_monotonic(self):
        rng = np.random.RandomState(2)
        thr, far, frr = det_points(rng.randn(500) + 1, rng.randn(500))
        assert (np.diff(far) <= 1e-12).all()   # far non-increasing
        assert (np.diff(frr) >= -1e-12).all()  # frr non-decreasing

    def test_accuracy(self):
        assert accuracy(["a", "b", "c"], ["a", "x", "c"]) == 2 / 3
