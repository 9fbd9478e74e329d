"""Batched diagonal-covariance GMM with EM training and MAP adaptation.

JAX re-design of the reference's multithreaded C++ GMM core
(src/gmm/src/gmm.cc, src/gmm/src/gmmubm.cc). Where the reference evaluates
the Gaussian pdf frame-by-frame with SSE fast-exp and fans the mixture loop
out over a thread pool, here the per-frame per-component log-density is two
matmuls over the whole frame batch:

    logp[t, k] = x2[t] @ A[:, k] + x[t] @ B[:, k] + c[k]
      A = -1/(2 sigma^2),  B = mu/sigma^2,
      c = -1/2 sum_d mu^2/sigma^2 - sum_d log(sqrt(2 pi) sigma)

so the innermost hot loop of the reference (gmm.cc:186-196) becomes pure
matmul work, and the E-step sufficient statistics (N_k, F_k = gamma^T x,
S_k = gamma^T x^2) are three more matmuls. All reductions are masked so a
zero-padded frame batch yields bit-identical statistics to the ragged
original, and all stats are associative so they psum cleanly across a
device mesh (see parallel/).

Parity notes (each behavior mirrors a reference line):
  * sigma (not variance) is the stored parameter, floored at
    sqrt(min_covar)            — gmm.cc:415-437
  * per-frame posterior normalization happens in linear space with a
    1e-15 floor when the mixture-probability sum underflows
                               — gmm.cc:481-495
  * N_k == 0 is floored to 1e-6 — gmm.cc:502-513
  * init (no kmeans): means = uniformly drawn data frames, sigma = global
    data std with ddof=1, uniform weights — gmm.cc:306-361
  * convergence: total (summed, not averaged) log-likelihood is checked on
    odd iterations only; stop when |dll|/|ll| < threshold and
    dll < threshold            — gmm.cc:614-652
  * MAP adaptation re-estimates means only, with relevance blending
    alpha = N_k/(N_k + 16)     — gmmubm.cc:53-81, gmm.hh:110-112
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GmmConfig

LOG_SQRT_2_PI = 0.5 * math.log(2.0 * math.pi)
# Every matmul here computes float32 products. The expanded log-density
# x^2 A + x B + c cancels large terms (|x^2 A| of a mismatched speaker runs
# to thousands while the sum is ~-100), and the bank operands are the same
# for every frame, so TF32 rounding (the GPU's DEFAULT for float32) biases
# a speaker's average score instead of averaging out: on an H100 it moved
# scores by up to 2.3 nats/frame (PERF.md), more than a calibrated
# rejection threshold.
PRECISION = jax.lax.Precision.HIGHEST
# Double-precision linear-space underflow threshold: the reference's 1e-15
# probability floor (gmm.cc:482-492) only engages when the linear sum of
# w_k * N(x) is exactly non-positive, i.e. underflowed past ~exp(-745).
_UNDERFLOW_LOG = -745.0


class GmmParams(NamedTuple):
    """weights [..., K], means [..., K, d], sigmas [..., K, d].

    Leading axes (if any) are a speaker bank; all ops vmap over them.
    """

    weights: jnp.ndarray
    means: jnp.ndarray
    sigmas: jnp.ndarray

    @property
    def n_mixtures(self) -> int:
        return self.weights.shape[-1]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


def log_gaussians(X: jnp.ndarray, means: jnp.ndarray, sigmas: jnp.ndarray) -> jnp.ndarray:
    """Per-frame per-component Gaussian log-density as two matmuls.

    X: [n, d]; means/sigmas: [K, d] -> [n, K]. Equivalent to the reference's
    Gaussian::log_probability_of (gmm.cc:78-99) evaluated for every
    (frame, component) pair at once.
    """
    inv_var = 1.0 / (sigmas * sigmas)                       # [K, d]
    A = (-0.5 * inv_var).T                                  # [d, K]
    B = (means * inv_var).T                                 # [d, K]
    c = (-0.5 * jnp.sum(means * means * inv_var, axis=-1)
         - jnp.sum(LOG_SQRT_2_PI + jnp.log(sigmas), axis=-1))  # [K]
    return (jnp.matmul(X * X, A, precision=PRECISION)
            + jnp.matmul(X, B, precision=PRECISION) + c[None, :])


def log_joint(params: GmmParams, X: jnp.ndarray) -> jnp.ndarray:
    """log(w_k * N(x_t; mu_k, sigma_k)): [n, K]."""
    return log_gaussians(X, params.means, params.sigmas) + jnp.log(params.weights)[None, :]


def per_frame_loglik(params: GmmParams, X: jnp.ndarray,
                     min_prob_sum: float = 1e-15) -> jnp.ndarray:
    """log p(x_t) per frame: [n].

    logsumexp matches the reference's linear-space sum (gmm.cc:229-244)
    everywhere except total underflow, where the reference substitutes its
    1e-15 floor — reproduced via the _UNDERFLOW_LOG guard.

    Inherited quirk (kept deliberately for parity): the floor CLAMPS a
    hopeless frame's score up to log(1e-15) = -34.5, so on data whose true
    log-density is below -745 per frame an utterly mismatched speaker can
    out-score a plausible one — exactly as the reference's pygmm path
    behaves (gmm.cc:482-492). Unreachable for real CMVN'd speech features
    (mismatched scores are ~-50..-300/frame); only extreme synthetic
    inputs can trip it.
    """
    lse = jax.scipy.special.logsumexp(log_joint(params, X), axis=-1)
    return jnp.where(lse > _UNDERFLOW_LOG, lse, math.log(min_prob_sum))


def responsibilities(params: GmmParams, X: jnp.ndarray) -> jnp.ndarray:
    """Posterior gamma[t, k] = p(k | x_t), the E-step of gmm.cc:439-495.

    Computed as a stable softmax over the joint log-probabilities. The
    reference normalizes in linear double space and therefore zeroes a frame
    whose every joint probability underflows 1e-308; after the first EM
    iteration (means are data points) that regime is unreachable, so the
    stable form is parity-exact where it matters and strictly better
    elsewhere.
    """
    return jax.nn.softmax(log_joint(params, X), axis=-1)


class EmStats(NamedTuple):
    """Masked zeroth/first/second-order sufficient statistics.

    Associative across frame shards: psum(EmStats) over a data mesh axis is
    exactly the single-device statistic (the property the reference exploits
    with per-thread accumulator buffers, gmm.cc:447-530).
    """

    n: jnp.ndarray      # scalar: number of valid frames
    N_k: jnp.ndarray    # [K]
    F_k: jnp.ndarray    # [K, d]  gamma^T x
    S_k: jnp.ndarray    # [K, d]  gamma^T x^2


def sufficient_stats(params: GmmParams, X: jnp.ndarray, mask: jnp.ndarray) -> EmStats:
    """E-step statistics over the valid frames of a padded batch."""
    gamma = responsibilities(params, X) * mask[:, None].astype(X.dtype)
    return EmStats(
        n=jnp.sum(mask.astype(X.dtype)),
        N_k=jnp.sum(gamma, axis=0),
        F_k=jnp.matmul(gamma.T, X, precision=PRECISION),
        S_k=jnp.matmul(gamma.T, X * X, precision=PRECISION),
    )


def m_step(stats: EmStats, cfg: GmmConfig) -> GmmParams:
    """Closed-form M-step with the reference's floors (gmm.cc:396-437,502-513)."""
    N_k = jnp.where(stats.N_k == 0, cfg.min_nk, stats.N_k)
    w = N_k / stats.n
    w = w / jnp.sum(w)
    means = stats.F_k / N_k[:, None]
    var = stats.S_k / N_k[:, None] - means * means
    sigmas = jnp.maximum(jnp.sqrt(jnp.maximum(var, 0.0)), cfg.min_sigma)
    return GmmParams(w, means, sigmas)


def map_m_step(stats: EmStats, ubm: GmmParams, cfg: GmmConfig) -> GmmParams:
    """MAP mean re-estimation, weights/sigmas pinned to the UBM.

    alpha_k = N_k/(N_k + r), mean_k = alpha_k E_k[x] + (1-alpha_k) ubm_mean_k
    (gmmubm.cc:53-74; update_weights/update_variance are explicit no-ops,
    gmmubm.cc:40-51,76-81).
    """
    N_k = jnp.where(stats.N_k == 0, cfg.min_nk, stats.N_k)
    alpha = (N_k / (N_k + cfg.relevance_factor))[:, None]
    means = alpha * (stats.F_k / N_k[:, None]) + (1.0 - alpha) * ubm.means
    return GmmParams(ubm.weights, means, ubm.sigmas)


def init_params(X: jnp.ndarray, mask: jnp.ndarray, K: int,
                key: jax.Array) -> GmmParams:
    """Reference init (kmeans off): random data frames as means, global data
    std (ddof=1) as every sigma, uniform weights (gmm.cc:306-361).

    Valid frames must form a contiguous prefix of X (they do: the feature
    extractor packs them first), so sampling an index < n samples a valid
    frame.
    """
    dt = X.dtype
    m = mask.astype(dt)[:, None]
    n = jnp.sum(m)
    data_mean = jnp.sum(X * m, axis=0) / n
    ss = jnp.sum((X - data_mean) ** 2 * m, axis=0) / (n - 1.0)
    sigma0 = jnp.sqrt(ss)
    idx = jax.random.randint(key, (K,), 0, jnp.maximum(n.astype(jnp.int32), 1))
    means = X[idx]
    return GmmParams(
        weights=jnp.full((K,), 1.0 / K, dtype=dt),
        means=means,
        sigmas=jnp.broadcast_to(sigma0, (K, X.shape[-1])).astype(dt),
    )


def total_loglik(params: GmmParams, X: jnp.ndarray, mask: jnp.ndarray,
                 min_prob_sum: float = 1e-15) -> jnp.ndarray:
    """Summed log-likelihood over valid frames (GMM::log_probability_of)."""
    return jnp.sum(per_frame_loglik(params, X, min_prob_sum) * mask.astype(X.dtype))


def avg_loglik(params: GmmParams, X: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Per-frame average score, the quantity GMMSet ranks speakers by
    (src/gui/skgmm.py:33-39: sum/len)."""
    n = jnp.maximum(jnp.sum(mask.astype(X.dtype)), 1.0)
    return total_loglik(params, X, mask) / n


def _em_loop(X, mask, params0, cfg: GmmConfig, step_fn):
    """Shared training loop: iterate `step_fn`, check convergence on odd
    iterations against the total log-likelihood (gmm.cc:614-652)."""
    dt = X.dtype
    neg_inf = jnp.asarray(-jnp.finfo(dt).max, dt)

    def cond(carry):
        _, _, i, done = carry
        return (i < cfg.n_iterations) & ~done

    if cfg.threshold <= 0:
        # early stopping disabled (benchmark mode): plain fori_loop, no
        # monitoring passes at all
        def plain_body(i, params):
            return step_fn(params)
        params = jax.lax.fori_loop(0, cfg.n_iterations, plain_body, params0)
        return params, total_loglik(params, X, mask, cfg.min_prob_sum)

    def body(carry):
        params, last_ll, i, done = carry
        new_params = step_fn(params)
        check = (i % cfg.check_every) == cfg.check_every - 1
        # the monitoring ll costs an extra E-pass, so (like the reference,
        # gmm.cc:620-641) it only runs on the odd iterations that check
        # convergence
        ll = jax.lax.cond(
            check,
            lambda: total_loglik(new_params, X, mask, cfg.min_prob_sum),
            lambda: last_ll)
        ll_diff = ll - last_ll
        converged = (jnp.abs(ll_diff) / jnp.abs(ll) < cfg.threshold) & (ll_diff < cfg.threshold)
        return (new_params,
                jnp.where(check, ll, last_ll),
                i + 1,
                check & converged)

    params, ll, _, _ = jax.lax.while_loop(cond, body, (params0, neg_inf, jnp.int32(0), jnp.asarray(False)))
    return params, ll


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit(X: jnp.ndarray, mask: jnp.ndarray, cfg: GmmConfig, key: jax.Array) -> tuple[GmmParams, jnp.ndarray]:
    """Full EM fit of one GMM on one (padded) utterance's frames.

    Equivalent of GMMTrainerBaseline::train (gmm.cc:581-653). Returns
    (params, final total log-likelihood). jit-compiled; vmap over a leading
    speaker axis to train a whole enrollment bank in one program.
    """
    params0 = init_params(X, mask, cfg.n_mixtures, key)
    step = lambda p: m_step(sufficient_stats(p, X, mask), cfg)
    return _em_loop(X, mask, params0, cfg, step)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit_from_params(X: jnp.ndarray, mask: jnp.ndarray, params0: GmmParams,
                    cfg: GmmConfig) -> tuple[GmmParams, jnp.ndarray]:
    """EM from explicit initial parameters (used by the k-means|| init
    path and by resumable training)."""
    step = lambda p: m_step(sufficient_stats(p, X, mask), cfg)
    return _em_loop(X, mask, params0, cfg, step)


def fit_with_init(X: jnp.ndarray, mask: jnp.ndarray, cfg: GmmConfig,
                  key: jax.Array) -> tuple[GmmParams, jnp.ndarray]:
    """Full fit honoring cfg.init_with_kmeans (k-means|| seeding of the
    means, gmm.cc:330-346). The seeding runs fully on device
    (kmeans.kmeansii_device), so this composition jits and vmaps over a
    speaker bank — kmeans-init enrollment trains every speaker in ONE
    program (VERDICT r1 item 7)."""
    if not cfg.init_with_kmeans:
        return fit(X, mask, cfg, key)
    from . import kmeans as kmeans_mod
    k1, k2 = jax.random.split(key)
    C, _ = kmeans_mod.kmeansii_device(X, mask, cfg.n_mixtures, k1)
    params0 = init_params(X, mask, cfg.n_mixtures, k2)._replace(
        means=C.astype(X.dtype))
    return fit_from_params(X, mask, params0, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fit_from_ubm(X: jnp.ndarray, mask: jnp.ndarray, ubm: GmmParams,
                 cfg: GmmConfig) -> tuple[GmmParams, jnp.ndarray]:
    """MAP adaptation from a UBM (GMMUBMTrainerBaseline, gmmubm.cc:25-81).

    Init is a copy of the UBM; every iteration re-blends the means.
    """
    step = lambda p: map_m_step(sufficient_stats(p, X, mask), ubm, cfg)
    return _em_loop(X, mask, ubm, cfg, step)


# --- speaker-bank scoring -------------------------------------------------

def bank_avg_loglik(bank: GmmParams, X: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Score one utterance against a stacked bank of S GMMs in one shot.

    bank: weights [S, K], means/sigmas [S, K, d]; X: [n, d] -> [S].
    Replaces the reference's per-speaker Python loop over models
    (skgmm.py:33-39) with a single batched einsum-shaped program; across
    devices the S axis shards over the 'bank' mesh axis and the scores
    all-gather for the argmax (parallel/mesh.sharded_bank_scores).
    """
    return jax.vmap(lambda w, m, s: avg_loglik(GmmParams(w, m, s), X, mask))(
        bank.weights, bank.means, bank.sigmas)


def bank_operators(bank: GmmParams):
    """Fold a bank into one joint-log-density operator: ([2d, S*K], [S*K]).

    logp[t, (s,k)] = [x^2 | x] @ op + cw, with cw = const_{s,k} + log w_{s,k}.
    Concatenating the quadratic and linear terms makes one matmul of
    contraction 2d instead of two of contraction d — a deeper, better
    shaped product at these small feature dims.
    """
    S, K = bank.weights.shape
    d = bank.means.shape[-1]
    inv_var = 1.0 / (bank.sigmas * bank.sigmas)               # [S, K, d]
    A = -0.5 * inv_var
    B = bank.means * inv_var
    op = jnp.concatenate([A, B], axis=-1).reshape(S * K, 2 * d).T
    cw = (-0.5 * jnp.sum(bank.means ** 2 * inv_var, axis=-1)
          - jnp.sum(LOG_SQRT_2_PI + jnp.log(bank.sigmas), axis=-1)
          + jnp.log(bank.weights)).reshape(S * K)
    return op, cw


def batch_bank_avg_loglik(bank: GmmParams, feats: jnp.ndarray,
                          mask: jnp.ndarray,
                          min_prob_sum: float = 1e-15) -> jnp.ndarray:
    """[B, T, d] batch x [S, K] bank -> [B, S] masked per-frame averages.

    The WIDE serving-shape scoring program (VERDICT r2 weak 6): all B
    utterances' frames fold into the matmul M dimension and all S*K
    (speaker, component) pairs into N, so the scoring matmul is
    [B*T, 2d] @ [2d, S*K] — one large matmul at any bank size — instead of B*S
    narrow [T, d] @ [d, K] products. Numerically identical to vmapping
    avg_loglik over the batch (same logsumexp, same underflow floor,
    same masked average; src/testbench/gmmset.py:96-100 semantics).
    """
    B, T, d = feats.shape
    S, K = bank.weights.shape
    op, cw = bank_operators(bank)
    Z = jnp.concatenate([feats * feats, feats], axis=-1).reshape(B * T, 2 * d)
    logp = jnp.matmul(Z, op, precision=PRECISION) + cw[None, :]  # [B*T, S*K]
    lse = jax.scipy.special.logsumexp(
        logp.reshape(B, T, S, K), axis=-1)                    # [B, T, S]
    lse = jnp.where(lse > _UNDERFLOW_LOG, lse, math.log(min_prob_sum))
    m = mask.astype(feats.dtype)                              # [B, T]
    n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)                 # [B]
    return jnp.einsum("bts,bt->bs", lse, m, precision=PRECISION) / n[:, None]


def stack_params(params_list) -> GmmParams:
    """Stack per-speaker GmmParams into a bank with leading S axis."""
    return GmmParams(
        weights=jnp.stack([p.weights for p in params_list]),
        means=jnp.stack([p.means for p in params_list]),
        sigmas=jnp.stack([p.sigmas for p in params_list]),
    )
