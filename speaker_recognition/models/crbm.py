"""Continuous Restricted Boltzmann Machine (Chen & Murray 2003) with CD-k.

Re-design of the reference's C++ CRBM (src/nn/src/crbm.cc, include/crbm.hh)
— the alternative speaker model classified by argmin per-speaker
reconstruction error (src/nn/src/main.cc:453-465). The reference trains one
sample at a time over a thread pool; here a whole minibatch is two matmuls
per CD step, minibatches advance under lax.scan, and the per-speaker
model bank trains as one vmapped program.

Semantics mirrored from the reference:
  * hidden unit: h = sig(a_j * (w'v + b_h + sigma*N(0,1)); range) with the
    range-scaled sigmoid lo + (hi-lo)/(1+e^-x) (crbm.cc:26-29,92-102);
    hidden range fixed [0,1], visible range tracked from data
    (crbm.cc:496-527), visible unit has no slope factor (crbm.cc:105-115)
  * sigma = 0.2 fixed (crbm.cc:118-123)
  * CD-k stats: <v h'> at data and after k (visible,hidden) resamples,
    averaged over the minibatch (crbm.cc:407-466)
  * updates: momentum 0.9, weight decay C = 0.001, lr 0.1; slope update
    delta_a = (<h^2>_0 - <h^2>_inf)/a^2 (crbm.cc:427-448)
  * init: N(0, 0.01) weights/biases, a = 1 (crbm.cc:468-480)
  * reconstruction error: one noise-free up-down pass, squared error
    (crbm.cc:187-200)
  * epoch loop walks minibatches with wrap-around indexing
    (train_batch's X[i % n], crbm.cc:398-405)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CrbmParams", "CrbmTrainConfig", "CrbmTrainState", "fit",
           "fit_bank", "fit_bank_segment", "init_train_state",
           "reconstruction_error", "bank_reconstruction_errors", "predict_bank"]

SIGMA = 0.2  # crbm.cc:122


class CrbmParams(NamedTuple):
    """vb [nv], hb [nh], w [nv, nh], a [nh] slopes, vlo/vhi [nv] visible
    range. Leading axes (if any) form a speaker bank."""

    vb: jnp.ndarray
    hb: jnp.ndarray
    w: jnp.ndarray
    a: jnp.ndarray
    vlo: jnp.ndarray
    vhi: jnp.ndarray


class CrbmTrainConfig(NamedTuple):
    learning_rate: float = 0.1   # crbm.hh:62
    n_epochs: int = 100          # crbm.hh:62 nr_epoch_max
    batch_size: int = 100
    cd_k: int = 1
    weight_decay: float = 0.001  # C, crbm.hh:70
    momentum: float = 0.9        # crbm.hh:71


def speaker_task_config(n_frames: int) -> "CrbmTrainConfig":
    """The reference's SPEAKER-identification trainer settings
    (overall_test_train_crbm, src/nn/src/main.cc:422-439): FULL-batch
    training (batch_train_size = X.size()) for 2000 epochs at lr 0.1 /
    CD-1, on at most ~1000 frames per speaker (overall_test_get_data's
    nr_data_max). The class defaults above are crbm.hh's GENERIC defaults;
    on speech features the minibatch-100 regime diverges for a fraction
    of speakers (measured near-chance bank classification vs clean
    separation under these settings — experiments/crbm_accuracy.py,
    r4_crbm_accuracy.jsonl), so pass this config for enrollment banks."""
    return CrbmTrainConfig(n_epochs=2000, batch_size=max(int(n_frames), 1))


def _scaled_sigmoid(x, lo, hi):
    return lo + (hi - lo) * jax.nn.sigmoid(x)


def sample_hidden(params: CrbmParams, V: jnp.ndarray, key=None) -> jnp.ndarray:
    """[B, nv] -> [B, nh]; noisy when a key is given (crbm.cc:92-102)."""
    act = V @ params.w + params.hb[None, :]
    if key is not None:
        act = act + SIGMA * jax.random.normal(key, act.shape, act.dtype)
    act = act * params.a[None, :]
    return _scaled_sigmoid(act, 0.0, 1.0)


def sample_visible(params: CrbmParams, H: jnp.ndarray, key=None) -> jnp.ndarray:
    """[B, nh] -> [B, nv] (crbm.cc:105-115; no slope factor)."""
    act = H @ params.w.T + params.vb[None, :]
    if key is not None:
        act = act + SIGMA * jax.random.normal(key, act.shape, act.dtype)
    return _scaled_sigmoid(act, params.vlo[None, :], params.vhi[None, :])


class _Velocity(NamedTuple):
    dv: jnp.ndarray
    dh: jnp.ndarray
    dw: jnp.ndarray
    da: jnp.ndarray


def _cd_batch(params: CrbmParams, vel: _Velocity, batch: jnp.ndarray,
              key, cfg: CrbmTrainConfig):
    """One minibatch CD-k + momentum update (train_batch, crbm.cc:381-452)."""
    B = batch.shape[0]
    keys = jax.random.split(key, 2 * cfg.cd_k + 1)
    V = batch
    H = sample_hidden(params, V, keys[0])
    v0, h0 = jnp.mean(V, 0), jnp.mean(H, 0)
    h2_0 = jnp.mean(H * H, 0)
    w0 = V.T @ H / B
    for j in range(cfg.cd_k):
        V = sample_visible(params, H, keys[1 + 2 * j])
        H = sample_hidden(params, V, keys[2 + 2 * j])
    vk, hk = jnp.mean(V, 0), jnp.mean(H, 0)
    h2_k = jnp.mean(H * H, 0)
    wk = V.T @ H / B

    lr, C, mom = cfg.learning_rate, cfg.weight_decay, cfg.momentum
    dv = mom * vel.dv + lr * ((v0 - vk) - C * params.vb)
    dh = mom * vel.dh + lr * ((h0 - hk) - C * params.hb)
    dw = mom * vel.dw + lr * ((w0 - wk) - C * params.w)
    da = mom * vel.da + lr * ((h2_0 - h2_k) / (params.a * params.a) - C * params.a)
    new = CrbmParams(params.vb + dv, params.hb + dh, params.w + dw,
                     params.a + da, params.vlo, params.vhi)
    return new, _Velocity(dv, dh, dw, da)


def init_params(key, nv: int, nh: int, X: jnp.ndarray, mask: jnp.ndarray,
                dtype=jnp.float32) -> CrbmParams:
    """N(0, 0.01) init + visible range from the data (crbm.cc:468-527)."""
    k1, k2, k3 = jax.random.split(key, 3)
    big = jnp.asarray(3.4e38, dtype)
    mexp = mask[:, None]
    vlo = jnp.min(jnp.where(mexp, X, big), axis=0)
    vhi = jnp.max(jnp.where(mexp, X, -big), axis=0)
    return CrbmParams(
        vb=0.01 * jax.random.normal(k1, (nv,), dtype),
        hb=0.01 * jax.random.normal(k2, (nh,), dtype),
        w=0.01 * jax.random.normal(k3, (nv, nh), dtype),
        a=jnp.ones((nh,), dtype),
        vlo=vlo, vhi=vhi,
    )


class CrbmTrainState(NamedTuple):
    """Resumable training state: parameters, momentum velocities, and the
    next global step index. The analogue of the reference's
    periodic model save during long runs (nr_epoch_save, crbm.cc:370-376) —
    training in segments from a saved state is bit-identical to one
    monolithic run with the same base key."""

    params: CrbmParams
    vel: "_Velocity"
    step: jnp.ndarray  # int32 scalar: next global step


def init_train_state(key, nh: int, X: jnp.ndarray,
                     mask: jnp.ndarray) -> CrbmTrainState:
    """Fresh state; the init draw is fold_in(key, 0) so step keys
    (fold_in(key, 1 + step)) never collide with it."""
    nv = X.shape[-1]
    params = init_params(jax.random.fold_in(key, 0), nv, nh, X, mask, X.dtype)
    vel = _Velocity(jnp.zeros_like(params.vb), jnp.zeros_like(params.hb),
                    jnp.zeros_like(params.w), jnp.zeros_like(params.a))
    return CrbmTrainState(params, vel, jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=("nh", "cfg", "n_epochs", "total_epochs"))
def _fit_segment(X: jnp.ndarray, mask: jnp.ndarray, nh: int,
                 cfg: CrbmTrainConfig, key, state: CrbmTrainState,
                 n_epochs: int, total_epochs: int) -> CrbmTrainState:
    """Advance training by n_epochs (of a total_epochs-epoch run).

    Minibatches wrap around modulo n like the reference's X[i % n] walk;
    padded rows are never visited because indices are taken modulo the true
    count. The scan's trip count is static (sized for the padded row count
    so a vmapped bank shares one program), but each speaker only applies
    total_epochs * ceil(n_valid / batch) updates — the reference's
    per-speaker epoch semantics (CRBMTrainer::train's `for i in 0..n step
    batch`, crbm.cc:398-405) — with later steps masked out.
    """
    n_total = X.shape[0]
    n = jnp.sum(mask.astype(jnp.int32))
    batches_per_epoch = max(-(-n_total // cfg.batch_size), 1)
    n_steps = n_epochs * batches_per_epoch
    budget = total_epochs * jnp.maximum(
        -(-n // jnp.maximum(cfg.batch_size, 1)), 1)
    step0 = state.step

    def step(carry, i):
        params, vel = carry
        gstep = step0 + i
        k = jax.random.fold_in(key, 1 + gstep)
        start = (gstep % batches_per_epoch) * cfg.batch_size
        idx = (start + jnp.arange(cfg.batch_size)) % jnp.maximum(n, 1)
        batch = X[idx]
        new_params, new_vel = _cd_batch(params, vel, batch, k, cfg)
        live = gstep < budget
        params = jax.tree.map(lambda a, b: jnp.where(live, a, b),
                              new_params, params)
        vel = jax.tree.map(lambda a, b: jnp.where(live, a, b), new_vel, vel)
        return (params, vel), None

    (params, vel), _ = jax.lax.scan(
        step, (state.params, state.vel), jnp.arange(n_steps, dtype=jnp.int32))
    return CrbmTrainState(params, vel, step0 + n_steps)


def fit(X: jnp.ndarray, mask: jnp.ndarray, nh: int, cfg: CrbmTrainConfig,
        key) -> CrbmParams:
    """Train one CRBM on [n, nv] frames (valid frames form a contiguous
    prefix) for cfg.n_epochs epochs."""
    state = init_train_state(key, nh, X, mask)
    return _fit_segment(X, mask, nh, cfg, key, state,
                        cfg.n_epochs, cfg.n_epochs).params


def reconstruction_error(params: CrbmParams, X: jnp.ndarray,
                         mask: jnp.ndarray) -> jnp.ndarray:
    """Summed squared reconstruction error over valid frames of one
    utterance: one noise-free up-down pass (crbm.cc:187-200)."""
    H = sample_hidden(params, X)
    V = sample_visible(params, H)
    err = jnp.sum((X - V) ** 2, axis=-1)
    return jnp.sum(err * mask.astype(X.dtype))


def fit_bank(Xs: jnp.ndarray, masks: jnp.ndarray, nh: int,
             cfg: CrbmTrainConfig, key) -> CrbmParams:
    """Train S speakers' CRBMs in one vmapped program: Xs [S, n, nv].
    Replaces the reference's 8-thread per-speaker fan-out
    (src/nn/src/main.cc:500-518)."""
    S = Xs.shape[0]
    keys = jax.random.split(key, S)
    return jax.vmap(lambda x, m, k: fit(x, m, nh, cfg, k))(Xs, masks, keys)


def fit_bank_segment(Xs: jnp.ndarray, masks: jnp.ndarray, nh: int,
                     cfg: CrbmTrainConfig, key,
                     state: CrbmTrainState | None, n_epochs: int,
                     total_epochs: int) -> CrbmTrainState:
    """Advance a whole speaker bank's training by n_epochs; resumable from a
    saved state (the reference's nr_epoch_save checkpointing,
    crbm.cc:370-376). Segments compose exactly: running total_epochs in one
    segment or many yields bit-identical parameters."""
    S = Xs.shape[0]
    keys = jax.random.split(key, S)
    if state is None:
        state = jax.vmap(lambda k, x, m: init_train_state(k, nh, x, m))(
            keys, Xs, masks)
    return jax.vmap(lambda x, m, k, s: _fit_segment(
        x, m, nh, cfg, k, s, n_epochs, total_epochs))(Xs, masks, keys, state)


@jax.jit
def bank_reconstruction_errors(bank: CrbmParams, X: jnp.ndarray,
                               mask: jnp.ndarray) -> jnp.ndarray:
    """[S] reconstruction errors of one utterance against every speaker."""
    return jax.vmap(lambda vb, hb, w, a, lo, hi: reconstruction_error(
        CrbmParams(vb, hb, w, a, lo, hi), X, mask))(*bank)


def predict_bank(bank: CrbmParams, labels, X: jnp.ndarray, mask: jnp.ndarray):
    """argmin reconstruction-error classification
    (src/nn/src/main.cc:453-465)."""
    errs = bank_reconstruction_errors(bank, X, mask)
    return labels[int(jnp.argmin(errs))]
