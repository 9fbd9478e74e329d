"""Device-mesh parallelism: data-sharded EM and bank-sharded scoring.

The reference's only concurrency is shared-memory thread pools
(src/gmm/src/Threadpool/) merging per-worker partial sums serially
(gmm.cc:447-530, kmeans.cc:206-233). Every one of those reductions is
associative, so the device-mesh mapping is mechanical (SURVEY.md section
2.4):

  * EM E-step over frames  -> shard the frame axis over a 'data' mesh axis;
    the per-component sufficient statistics (N_k, F_k, S_k) psum across it.
  * speaker-bank scoring   -> shard the stacked bank's S axis over a 'bank'
    mesh axis; per-speaker scores all_gather for the argmax.

Two styles are provided:
  * shard_map versions with explicit jax.lax.psum — the collectives are
    visible and testable;
  * GSPMD versions (jit + NamedSharding constraints) where XLA inserts the
    same collectives — the production path.

Multi-host: call jax.distributed.initialize() before building the mesh;
everything below is expressed over the global device set, so the same code
runs on one card, on the NVLink-joined cards of one host (every card
reaches every other at the same rate, so the mesh follows the algorithm
alone), or across hosts with the 'data' axis laid out over hosts and
'bank' within a host. XLA hands the collectives to NCCL.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GmmConfig
from ..models import gmm

__all__ = [
    "make_mesh", "sharded_em_step", "sharded_fit", "sharded_bank_scores",
    "pad_frames_for_mesh",
]


def make_mesh(data: int | None = None, bank: int = 1,
              devices=None) -> Mesh:
    """Build a ('data', 'bank') mesh. Defaults: all devices on 'data'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if data is None:
        data = devices.size // bank
    assert data * bank == devices.size, (data, bank, devices.size)
    return Mesh(devices.reshape(data, bank), ("data", "bank"))


def pad_frames_for_mesh(X: np.ndarray, mask: np.ndarray, n_shards: int):
    """Pad the frame axis to a multiple of n_shards (mask marks padding)."""
    n = X.shape[0]
    pn = -(-n // n_shards) * n_shards
    if pn != n:
        X = np.concatenate([X, np.zeros((pn - n,) + X.shape[1:], X.dtype)], axis=0)
        mask = np.concatenate([mask, np.zeros(pn - n, bool)])
    return X, mask


# -- explicit-collective (shard_map) versions ------------------------------

def sharded_em_step(mesh: Mesh, cfg: GmmConfig):
    """One EM iteration with frames sharded over the 'data' axis and the
    three sufficient statistics psum'd across it. Params replicate.

    Returns a jitted fn(params, X, mask) -> new params. X: [n, d] with n a
    multiple of the 'data' axis size.
    """
    shard_map = jax.shard_map

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("data", None), P("data")),
        out_specs=P(),
    )
    def step(params, X, mask):
        local = gmm.sufficient_stats(params, X, mask)
        # X replicates across 'bank', so the reduction is over 'data' only.
        stats = jax.tree.map(
            lambda s: jax.lax.psum(s, axis_name="data"), local)
        return gmm.m_step(stats, cfg)

    return jax.jit(step)


def sharded_bank_scores(mesh: Mesh):
    """Utterance-vs-bank scoring with the bank sharded over 'bank'.

    Returns jitted fn(bank, X, mask) -> [S] scores (replicated, via
    all_gather over the bank axis). S must be a multiple of the bank axis.
    """
    shard_map = jax.shard_map

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("bank", None), P("bank", None, None), P("bank", None, None),
                  P(), P()),
        out_specs=P(),
        # all_gather(tiled) makes the result bit-identical on every 'bank'
        # member; the static varying-axis checker cannot see that, so it is
        # disabled for this kernel.
        check_vma=False,
    )
    def score(w, m, s, X, mask):
        local = gmm.bank_avg_loglik(gmm.GmmParams(w, m, s), X, mask)  # [S/bank]
        return jax.lax.all_gather(local, axis_name="bank", tiled=True)

    return jax.jit(lambda bank, X, mask: score(bank.weights, bank.means,
                                               bank.sigmas, X, mask))


# -- GSPMD versions (production path) --------------------------------------

def sharded_fit(mesh: Mesh, cfg: GmmConfig):
    """Full EM fit (models/gmm.fit) with the frame axis sharded over 'data'.

    GSPMD: the input carries a NamedSharding, every matmul-reduction over
    frames lowers to a psum across devices, and the replicated M-step/convergence
    logic stays replicated. Same numerics as the single-device fit.
    """
    data_sharding = NamedSharding(mesh, P(("data", "bank"), None))
    mask_sharding = NamedSharding(mesh, P(("data", "bank")))
    rep = NamedSharding(mesh, P())

    fit = jax.jit(
        lambda X, mask, key: gmm.fit(X, mask, cfg, key),
        in_shardings=(data_sharding, mask_sharding, rep),
        out_shardings=rep,
    )

    def run(X, mask, key):
        return fit(jnp.asarray(X), jnp.asarray(mask), key)

    return run
