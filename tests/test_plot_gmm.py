"""tools/plot_gmm — the visualization utilities actually render
(replacement surface for src/gmm/plot-gmm.py, plot-point.py,
plot-point-3d.py)."""

import os

import numpy as np

from speaker_recognition.models.gmm import GmmParams
from speaker_recognition.tools import plot_gmm
from speaker_recognition.utils import serialization


def _model(tmp_path, d=4, K=3):
    rng = np.random.RandomState(0)
    params = GmmParams(
        weights=rng.dirichlet(np.ones(K)),
        means=rng.randn(K, d) * 2,
        sigmas=0.5 + rng.rand(K, d))
    path = str(tmp_path / "model.txt")
    with open(path, "w") as f:
        serialization.dump_reference_gmm(params, f)
    return params, path


def test_gmm_density_plot(tmp_path):
    params, model_path = _model(tmp_path)
    rng = np.random.RandomState(1)
    comp = rng.choice(3, size=200, p=params.weights / params.weights.sum())
    pts = params.means[comp] + params.sigmas[comp] * rng.randn(200, 4)
    data_path = str(tmp_path / "data.txt")
    np.savetxt(data_path, pts)
    out = str(tmp_path / "gmm.pdf")
    plot_gmm.plot_gmm_density(model_path, data_path, dims=(0, 1),
                              grid=50, out=out)
    assert os.path.getsize(out) > 1000
    # no data file: grid bounds come from the component means/sigmas
    out2 = str(tmp_path / "gmm2.pdf")
    plot_gmm.plot_gmm_density(model_path, None, dims=(1, 2), grid=40,
                              out=out2)
    assert os.path.getsize(out2) > 1000


def test_points_plots(tmp_path):
    xy = str(tmp_path / "xy.txt")
    np.savetxt(xy, np.stack([np.arange(30.0),
                             np.sin(np.arange(30.0))], axis=1))
    out = str(tmp_path / "points.pdf")
    plot_gmm.plot_points(xy, out=out, annotate_maximum=True,
                         annotate_minimum=True, title="t")
    assert os.path.getsize(out) > 1000

    yonly = str(tmp_path / "y.txt")
    np.savetxt(yonly, np.cos(np.arange(20.0)))
    out2 = str(tmp_path / "points2.pdf")
    plot_gmm.plot_points(yonly, out=out2)
    assert os.path.getsize(out2) > 1000


def test_points3d_plot(tmp_path):
    xyz = str(tmp_path / "xyz.txt")
    np.savetxt(xyz, np.random.RandomState(2).randn(50, 3))
    out = str(tmp_path / "p3.pdf")
    plot_gmm.plot_points_3d(xyz, out=out)
    assert os.path.getsize(out) > 1000


def test_cli(tmp_path):
    _, model_path = _model(tmp_path)
    out = str(tmp_path / "cli.pdf")
    plot_gmm.main(["gmm", "-m", model_path, "-o", out, "--grid", "30"])
    assert os.path.getsize(out) > 1000
