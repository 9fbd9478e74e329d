"""chip_smoke.py on the CPU: its phase functions at a tiny size (kernel in
interpret mode), the multi-device phase on virtual CPU devices, and its
refusal to run without a GPU or without the rest of the repo."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

chip_smoke._import_repo()

PHASES = ["features", "cli", "headline_batch", "serial", "large_bank",
          "kernel_headline", "kernel_large_bank", "kernel_mid_24x32",
          "kernel_mid_80x32", "kernel_serial_24x32", "kernel_serial_80x256"]


@pytest.fixture(scope="module")
def tiny_run():
    phases = {}
    chip_smoke.one_card(phases, seed=0, speakers=3, seconds=2.0,
                        headline_batch=8, large_speakers=4,
                        large_mixtures=16, large_batch=8, interpret=True,
                        gpu_tests=False)
    return phases


@pytest.mark.parametrize("phase", PHASES)
def test_one_card_phase_tiny(tiny_run, phase):
    stats = tiny_run[phase]
    assert stats
    if "max_abs_err" in stats:
        assert stats["argmax_flips"] == 0
    if "accuracy" in stats:
        assert stats["accuracy"] >= chip_smoke.MIN_ACCURACY
    if "features_mfcc_median" in stats:
        assert (stats["features_lpc_median"]
                < chip_smoke.FEAT_MEDIAN_TOL["lpc"])


def test_phase_four_on_virtual_devices():
    stats = chip_smoke.phase_four(jax.devices()[:4], seed=0, n_mixtures=8,
                                  ubm_iters=3, n_speakers=4, seconds=2.0,
                                  bank_speakers=8)
    assert stats["devices"] == 4
    assert stats["train_ubm_rel_err"] < chip_smoke.SHARDED_RTOL
    assert stats["bank_scores_rel_err"] < chip_smoke.SHARDED_RTOL


def test_check_scores_decision_rule():
    import numpy as np
    tol = chip_smoke.SCORE_RTOL * 50.0 + chip_smoke.SCORE_ATOL
    want = np.array([[-50.0, -50.0 - tol / 4, -60.0], [-40.0, -45.0, -50.0]])
    # a flip between speakers closer than the tolerance passes
    got = want + np.array([[-tol / 2, 0.0, 0.0], [0.0, 0.0, 0.0]])
    assert chip_smoke.check_scores("ok", got, want)["argmax_flips"] == 1
    with pytest.raises(AssertionError, match="tolerance"):
        chip_smoke.check_scores("far", want + 5.0 * np.eye(2, 3), want)


def test_floor_slack_covers_a_frame_at_the_underflow_step():
    import jax.numpy as jnp
    import numpy as np
    from speaker_recognition.models import gmm
    # two speakers, each one 1-d standard Gaussian; frame 3 sits 0.1 nats
    # above the step
    bank = gmm.GmmParams(jnp.ones((2, 1)), jnp.zeros((2, 1, 1)),
                         jnp.ones((2, 1, 1)))
    x = np.sqrt(2 * (-gmm._UNDERFLOW_LOG - 0.1 - gmm.LOG_SQRT_2_PI))
    feats = jnp.asarray([[[0.0], [0.0], [0.0], [x]]])
    mask = jnp.ones((1, 4), bool)
    jump = np.log(1e-15) - gmm._UNDERFLOW_LOG
    slack = chip_smoke.floor_slack(bank, feats, mask)
    bound = (jump + chip_smoke.FLOOR_BAND) / 4
    np.testing.assert_allclose(slack, [[bound, bound]])
    want = np.asarray(gmm.batch_bank_avg_loglik(bank, feats, mask))
    flipped = want + jump / 4          # frame 3 floored in the other program
    stats = chip_smoke.check_scores("step", flipped, want, slack)
    assert stats["floor_step_scores"] == 2
    with pytest.raises(AssertionError, match="tolerance"):
        chip_smoke.check_scores("step", flipped, want)


def test_rounding_slack_scales_with_the_cancelling_terms():
    import jax.numpy as jnp
    import numpy as np
    from speaker_recognition.models import gmm
    # one 1-d component at mu = 100, sigma = 0.01: at x = 100 the terms
    # x^2 A, x B and mu^2 / 2 sigma^2 are 5e7, 1e8 and 5e7 nats and cancel
    # to a density of ~40; x = 0 lies far under the floor (exact, no
    # slack); the third frame is masked out
    bank = gmm.GmmParams(jnp.ones((1, 1)), jnp.full((1, 1, 1), 100.0),
                         jnp.full((1, 1, 1), 0.01))
    feats = jnp.asarray([[[100.0], [0.0], [100.0]]])
    mask = jnp.asarray([[True, True, False]])
    c = abs(gmm.LOG_SQRT_2_PI + np.log(0.01))
    np.testing.assert_allclose(
        chip_smoke.rounding_slack(bank, feats, mask),
        [[chip_smoke.MAG_RTOL * (2e8 + c) / 2]], rtol=1e-5)


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 NVIDIA GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_interleaved_timing_turns():
    calls = []
    out = chip_smoke.interleaved(calls.append, ("a", "b"), trials=3)
    assert calls == ["a", "b"] + ["a", "b", "b", "a"] * 3
    assert set(out) == {"a", "b"}
    assert all(med >= 0 and iqr >= 0 for med, iqr in out.values())
