"""GMM / data visualization utilities.

Replacement for the reference's matplotlib helpers
(src/gmm/plot-gmm.py, plot-point.py, plot-point-3d.py, ~550 LoC):

  gmm      data scatter + mixture density contours + component means for a
           reference-format text GMM model (plot-gmm.py's view; the density
           grid is evaluated with the batched models/gmm.per_frame_loglik
           program instead of per-component mlab.bivariate_normal).
  points   2D scatter/line of whitespace-separated columns ("x y" pairs or
           bare "y" series), with optional max/min annotation
           (plot-point.py's surface).
  points3d 3D scatter of "x y z" rows (plot-point-3d.py).

Usage:
  python -m speaker_recognition.tools.plot_gmm gmm \
      -m model.txt -i data.txt -o fig.pdf [--dims 0,1] [--grid 300]
  python -m speaker_recognition.tools.plot_gmm points -i series.txt \
      -o fig.pdf [--annotate-maximum] [--annotate-minimum]
  python -m speaker_recognition.tools.plot_gmm points3d -i xyz.txt -o fig.pdf
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["plot_gmm_density", "plot_points", "plot_points_3d", "main"]


def _read_columns(path):
    """Whitespace-separated numeric columns; '-' = stdin
    (plot-point.py's input contract)."""
    fin = sys.stdin if path == "-" else open(path)
    rows = [[float(v) for v in line.split()] for line in fin
            if line.strip()]
    if path != "-":
        fin.close()
    if not rows:
        raise ValueError(f"no data rows in {path}")
    width = min(len(r) for r in rows)
    return np.asarray([r[:width] for r in rows])


def plot_gmm_density(model_path: str, data_path: str | None = None,
                     dims=(0, 1), grid: int = 300, out: str | None = None,
                     show: bool = False):
    """Contours of the mixture density marginalized to two dims, plus the
    component means (plot-gmm.py:77-105). Diagonal covariances make the
    2-dim marginal exact — just slice means/sigmas."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import jax.numpy as jnp
    from ..models import gmm as gmm_mod
    from ..utils import serialization

    with open(model_path) as f:
        params = serialization.load_reference_gmm(f)
    i, j = dims
    sub = gmm_mod.GmmParams(
        weights=jnp.asarray(params.weights, jnp.float32),
        means=jnp.asarray(params.means[:, [i, j]], jnp.float32),
        sigmas=jnp.asarray(params.sigmas[:, [i, j]], jnp.float32))

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_aspect("equal")
    if data_path:
        data = _read_columns(data_path)
        x, y = data[:, i], data[:, j]
        ax.scatter(x, y, s=4, alpha=0.4, label="data")
        x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    else:
        m, s = np.asarray(sub.means), np.asarray(sub.sigmas)
        x0, x1 = (m[:, 0] - 3 * s[:, 0]).min(), (m[:, 0] + 3 * s[:, 0]).max()
        y0, y1 = (m[:, 1] - 3 * s[:, 1]).min(), (m[:, 1] + 3 * s[:, 1]).max()
    gx = np.linspace(x0, x1, grid)
    gy = np.linspace(y0, y1, grid)
    X, Y = np.meshgrid(gx, gy)
    pts = jnp.asarray(np.stack([X.ravel(), Y.ravel()], axis=1), jnp.float32)
    # one batched device program for the whole grid (vs the reference's
    # python loop over components)
    ll = np.asarray(gmm_mod.per_frame_loglik(sub, pts, 1e-15))
    Z = np.exp(ll).reshape(grid, grid)
    ax.contour(X, Y, Z, levels=12, cmap="PuBu_r")
    ax.scatter(np.asarray(sub.means)[:, 0], np.asarray(sub.means)[:, 1],
               s=50, c="gold", edgecolors="k", zorder=3, label="means")
    ax.set_xlabel(f"dim {i}")
    ax.set_ylabel(f"dim {j}")
    ax.legend(loc="best")
    if out:
        fig.savefig(out, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return out


def _annotate(ax, x, y, idx, tag):
    ax.annotate(f"{tag}: ({x[idx]:g}, {y[idx]:g})", xy=(x[idx], y[idx]),
                xytext=(8, 8), textcoords="offset points",
                arrowprops={"arrowstyle": "->"})


def plot_points(data_path: str, out: str | None = None, show: bool = False,
                title: str = "", xlabel: str = "x", ylabel: str = "y",
                annotate_maximum: bool = False,
                annotate_minimum: bool = False):
    """plot-point.py: 'x y' pairs, or bare 'y' values against their index."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = _read_columns(data_path)
    if data.shape[1] >= 2:
        x, y = data[:, 0], data[:, 1]
    else:
        y = data[:, 0]
        x = np.arange(len(y), dtype=float)
    fig, ax = plt.subplots(figsize=(10, 6.18))
    ax.plot(x, y, marker="o", markersize=3, linewidth=1)
    if annotate_maximum:
        _annotate(ax, x, y, int(np.argmax(y)), "max")
    if annotate_minimum:
        _annotate(ax, x, y, int(np.argmin(y)), "min")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    if out:
        fig.savefig(out, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return out


def plot_points_3d(data_path: str, out: str | None = None,
                   show: bool = False, title: str = ""):
    """plot-point-3d.py: 'x y z' rows as a 3D scatter."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = _read_columns(data_path)
    if data.shape[1] < 3:
        raise ValueError("points3d needs 3 columns (x y z)")
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(data[:, 0], data[:, 1], data[:, 2], s=6)
    ax.set_title(title)
    if out:
        fig.savefig(out, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gmm")
    g.add_argument("-m", "--model", required=True,
                   help="reference-format text GMM model")
    g.add_argument("-i", "--input", default=None, help="data file (scatter)")
    g.add_argument("-o", "--output", default=None)
    g.add_argument("--dims", default="0,1")
    g.add_argument("--grid", type=int, default=300)
    g.add_argument("--show", action="store_true")

    p = sub.add_parser("points")
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-t", "--title", default="")
    p.add_argument("--xlabel", default="x")
    p.add_argument("--ylabel", default="y")
    p.add_argument("--annotate-maximum", action="store_true")
    p.add_argument("--annotate-minimum", action="store_true")
    p.add_argument("--show", action="store_true")

    q = sub.add_parser("points3d")
    q.add_argument("-i", "--input", default="-")
    q.add_argument("-o", "--output", default=None)
    q.add_argument("-t", "--title", default="")
    q.add_argument("--show", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd != "gmm" and not args.show and not args.output:
        ap.error("at least one of --show and --output must be given")
    if args.cmd == "gmm":
        dims = tuple(int(v) for v in args.dims.split(","))
        plot_gmm_density(args.model, args.input, dims, args.grid,
                         args.output, args.show)
    elif args.cmd == "points":
        plot_points(args.input, args.output, args.show, args.title,
                    args.xlabel, args.ylabel, args.annotate_maximum,
                    args.annotate_minimum)
    else:
        plot_points_3d(args.input, args.output, args.show, args.title)


if __name__ == "__main__":
    main()
