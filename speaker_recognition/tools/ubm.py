"""UBM workflow tools — equivalents of src/testbench/train-ubm.py and
src/testbench/adapt-ubm.py.

train_ubm pools background utterances' features and fits one large
diagonal GMM (the reference pools 300 random utterances and runs 500 EM
iterations at threshold 1e-15, train-ubm.py:41-51); across devices the
pooled frame matrix shards over the 'data' mesh axis and the EM statistics psum
(parallel/mesh.sharded_fit). adapt_speakers MAP-adapts each enrolled
speaker from the UBM in one vmapped program (adapt-ubm.py:25-36).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import GmmConfig
from ..models import gmm

__all__ = ["train_ubm", "adapt_speakers"]


def train_ubm(feature_arrays, n_mixtures: int = 32, n_iterations: int = 500,
              threshold: float = 1e-15, seed: int = 0, mesh=None,
              dtype="float32", checkpoint_path: str | None = None,
              checkpoint_every: int = 50) -> gmm.GmmParams:
    """Fit a UBM on pooled background features.

    feature_arrays: iterable of [T_i, d] arrays. Defaults mirror
    train-ubm.py:47 (GMM(32, nr_iteration=500, threshold=1e-15)).
    When a mesh is given, the frame axis shards across its devices.

    checkpoint_path enables resumable long runs (the reference dumps an
    intermediate model every second iteration for this, gmm.cc:622-630):
    EM runs in checkpoint_every-iteration jitted segments, writing the
    reference text format after each; an existing checkpoint is resumed
    from. Segment-level convergence checking stops between segments when
    the summed log-likelihood improvement falls under the threshold.
    """
    X = np.concatenate([np.asarray(f) for f in feature_arrays], axis=0)
    mask = np.ones(len(X), bool)
    key = jax.random.PRNGKey(seed)

    if checkpoint_path is None:
        cfg = GmmConfig(n_mixtures=n_mixtures, n_iterations=n_iterations,
                        threshold=threshold)
        if mesh is not None:
            from ..parallel import mesh as pmesh
            Xp, maskp = pmesh.pad_frames_for_mesh(
                X.astype(dtype), mask, mesh.devices.size)
            params, _ = pmesh.sharded_fit(mesh, cfg)(Xp, maskp, key)
        else:
            params, _ = gmm.fit(jnp.asarray(X, jnp.dtype(dtype)),
                                jnp.asarray(mask), cfg, key)
        return jax.tree.map(np.asarray, params)

    # checkpointed path: host-stepped segments with periodic text dumps
    import os

    from ..utils import serialization

    dt = jnp.dtype(dtype)
    Xj = jnp.asarray(X, dt)
    maskj = jnp.asarray(mask)
    seg_cfg = GmmConfig(n_mixtures=n_mixtures, n_iterations=checkpoint_every,
                        threshold=0.0)
    if os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            params = jax.tree.map(lambda a: jnp.asarray(a, dt),
                                  serialization.load_reference_gmm(f))
    else:
        params = gmm.init_params(Xj, maskj, n_mixtures, key)

    last_ll = -np.finfo(np.float64).max
    done_iters = 0
    while done_iters < n_iterations:
        params, ll = gmm.fit_from_params(Xj, maskj, params, seg_cfg)
        ll = float(ll)
        done_iters += checkpoint_every
        with open(checkpoint_path, "w") as f:
            serialization.dump_reference_gmm(jax.tree.map(np.asarray, params), f)
        ll_diff = ll - last_ll
        if abs(ll_diff) / max(abs(ll), 1e-300) < threshold and ll_diff < threshold:
            break
        last_ll = ll
    return jax.tree.map(np.asarray, params)


def adapt_speakers(ubm: gmm.GmmParams, speaker_features: dict,
                   cfg: GmmConfig | None = None, dtype="float32"):
    """MAP-adapt every speaker from the UBM in one vmapped program.

    speaker_features: {label: [T_i, d] array}. Returns (labels, bank).
    Mirrors adapt-ubm.py:25-36 (gmm.fit(x, ubm=ubm) per speaker).
    """
    cfg = cfg or GmmConfig(n_mixtures=int(np.asarray(ubm.weights).shape[-1]))
    labels = list(speaker_features.keys())
    feats = [np.asarray(speaker_features[l]) for l in labels]
    T = max(f.shape[0] for f in feats)
    d = feats[0].shape[1]
    Xs = np.zeros((len(labels), T, d), np.float64)
    masks = np.zeros((len(labels), T), bool)
    for i, f in enumerate(feats):
        Xs[i, : len(f)] = f
        masks[i, : len(f)] = True
    dt = jnp.dtype(dtype)
    ubm_j = jax.tree.map(lambda a: jnp.asarray(a, dt), ubm)
    bank, _ = jax.vmap(lambda x, m: gmm.fit_from_ubm(x, m, ubm_j, cfg))(
        jnp.asarray(Xs, dt), jnp.asarray(masks))
    return labels, jax.tree.map(np.asarray, bank)
