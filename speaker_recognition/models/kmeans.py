"""k-means family for GMM initialization: Lloyd's, k-means++, k-means||.

JAX re-design of the reference's thread-pool C++ solvers
(src/gmm/src/kmeans.cc, kmeans++.cc, kmeansII.cc). The hot op everywhere is
the point-to-centroid distance matrix, which is one matmul:

    dist2[i, j] = |x_i|^2 - 2 x_i . c_j + |c_j|^2

so assignment + accumulation is matmul work over the whole frame batch at once
(replacing calc_belonging's per-thread scratch buffers, kmeans.cc:62-106).
The per-round sampling of k-means|| (Bahmani et al. 2012; kmeansII.cc:82-171)
is orchestrated host-side — it is O(rounds) tiny decisions around jitted
device kernels, exactly the split SURVEY.md section 7.3 prescribes.

Semantics mirrored from the reference:
  * Lloyd's: <=200 iterations, track best-cost centroids, stop when
    |cost delta| < 1e-6 or cost exceeds 1.5x the best seen
    (kmeans.cc:150-246). Empty clusters keep their previous centroid
    (the reference divides by zero there — a bug we do not inherit).
  * k-means++: D^2-weighted sequential seeding (kmeans++.cc:102-155);
    the weighted variant scales sampling mass by point weight
    (kmeans++.cc:157-227).
  * k-means||: oversampling_factor=2, size_factor=2 (kmeansII.hh:29);
    per round each point joins the seed set independently with probability
    min(1, l*K*d2_i/sum d2); rounds end when > size_factor*K seeds or no
    new seeds; seeds are weighted by their cluster sizes and reclustered
    with weighted k-means++, then Lloyd's runs on the full data.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pairwise_dist2", "lloyd", "kmeanspp", "kmeansii",
           "kmeansii_device"]


def pairwise_dist2(X: jnp.ndarray, C: jnp.ndarray) -> jnp.ndarray:
    """[n, d], [K, d] -> [n, K] squared euclidean distances (one matmul).

    The matmul is pinned to HIGHEST precision: on the GPU the default f32
    matmul runs as TF32 (10 mantissa bits), whose absolute error on the
    cross term (~5e-4 relative to |x|^2 + |c|^2) floors small distances
    and distorts the D^2 sampling weights of k-means||; a reduced-precision
    pass has collapsed seeding to a far worse inertia before. Seeding and
    assignment cost is negligible next to EM, so full float32 here is
    free (tests_gpu/test_gpu_kernels.py checks the compiled seeding)."""
    x2 = jnp.sum(X * X, axis=-1, keepdims=True)
    c2 = jnp.sum(C * C, axis=-1)
    xc = jnp.matmul(X, C.T, precision=jax.lax.Precision.HIGHEST)
    d2 = x2 - 2.0 * xc + c2[None, :]
    return jnp.maximum(d2, 0.0)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def lloyd(X: jnp.ndarray, mask: jnp.ndarray, centroids0: jnp.ndarray,
          n_iter: int = 200, tol: float = 1e-6,
          terminate_cost_factor: float = 1.5,
          weights: jnp.ndarray | None = None):
    """Lloyd's iteration with the reference's stopping rules.

    Returns (best_centroids, best_cost). mask excludes padded frames from
    both assignment cost and centroid updates. With `weights`, runs the
    weighted variant (Lloyds_iteration_weighted / calc_belonging_weighted,
    kmeans.cc:108-146): point weights scale both the cost and the centroid
    accumulation — the k-means|| seed-recluster step depends on this.
    """
    dt = X.dtype
    m = mask.astype(dt)
    if weights is not None:
        m = m * weights.astype(dt)
    big = jnp.finfo(dt).max

    def assign(C):
        d2 = pairwise_dist2(X, C)
        belong = jnp.argmin(d2, axis=-1)
        cost = jnp.sum(jnp.min(d2, axis=-1) * m)
        return belong, cost

    def update(C, belong):
        onehot = (belong[:, None] == jnp.arange(C.shape[0])[None, :]).astype(dt) * m[:, None]
        counts = jnp.sum(onehot, axis=0)
        # full precision like pairwise_dist2: a bf16 pass would round X
        # into the centroid sums (output is tiny, cost negligible)
        sums = jnp.matmul(onehot.T, X, precision=jax.lax.Precision.HIGHEST)
        return jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), C)

    def cond(carry):
        C, best_C, best_cost, last_cost, i, done = carry
        return (i < n_iter) & ~done

    def body(carry):
        C, best_C, best_cost, last_cost, i, _ = carry
        belong, cost = assign(C)
        improved = cost < best_cost
        best_C = jnp.where(improved, C, best_C)
        best_cost = jnp.where(improved, cost, best_cost)
        done = (jnp.abs(last_cost - cost) < tol) | (cost > best_cost * terminate_cost_factor)
        C = update(C, belong)
        return C, best_C, best_cost, cost, i + 1, done

    init = (centroids0, centroids0, jnp.asarray(big, dt), jnp.asarray(big, dt),
            jnp.int32(0), jnp.asarray(False))
    _, best_C, best_cost, _, _, _ = jax.lax.while_loop(cond, body, init)
    return best_C, best_cost


@functools.partial(jax.jit, static_argnames=("K",))
def _pp_seed(X: jnp.ndarray, sample_w: jnp.ndarray, K: int, key: jax.Array) -> jnp.ndarray:
    """D^2-weighted sequential seeding core shared by kmeans++ variants.

    sample_w is an extra per-point multiplier on the sampling mass (1 for the
    plain variant, the point weight for cluster_weighted, 0 for padding).
    """
    n, d = X.shape
    k0, key = jax.random.split(key)
    total_w = jnp.sum(sample_w)
    # first centroid: uniform over valid points
    u = jax.random.uniform(k0) * total_w
    first = jnp.searchsorted(jnp.cumsum(sample_w), u)
    first = jnp.clip(first, 0, n - 1)

    C = jnp.zeros((K, d), X.dtype).at[0].set(X[first])
    dist = jnp.full((n,), jnp.finfo(X.dtype).max, X.dtype)

    def body(k, carry):
        C, dist, key = carry
        kk, key = jax.random.split(key)
        d2 = pairwise_dist2(X, C[k - 1][None, :])[:, 0]
        dist = jnp.minimum(dist, d2)
        w = dist * sample_w
        u = jax.random.uniform(kk, dtype=X.dtype) * jnp.sum(w)
        idx = jnp.clip(jnp.searchsorted(jnp.cumsum(w), u), 0, n - 1)
        return C.at[k].set(X[idx]), dist, key

    C, _, _ = jax.lax.fori_loop(1, K, body, (C, dist, key))
    return C


def kmeanspp(X: jnp.ndarray, mask: jnp.ndarray, K: int, key: jax.Array,
             weights: jnp.ndarray | None = None):
    """k-means++ seeding + Lloyd's (KMeansppSolver::cluster / _weighted;
    the weighted variant also weights the Lloyd refinement,
    kmeans++.cc:211-214)."""
    sample_w = mask.astype(X.dtype)
    if weights is not None:
        sample_w = sample_w * weights
    C0 = _pp_seed(X, sample_w, K, key)
    return lloyd(X, mask, C0, weights=weights)


def kmeansii(X, mask, K: int, key: jax.Array,
             oversampling_factor: float = 2.0, size_factor: float = 2.0):
    """k-means|| (KMeansIISolver::cluster, kmeansII.cc:82-171).

    Host-orchestrated sampling rounds around jitted distance kernels; the
    final weighted reclustering and full-data Lloyd's run on device.
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    mask_np = np.asarray(mask)
    valid_idx = np.nonzero(mask_np)[0]
    rng_key = key

    rng_key, k0 = jax.random.split(rng_key)
    first = int(valid_idx[int(jax.random.randint(k0, (), 0, len(valid_idx)))])
    seeds = [first]

    dist = jnp.where(jnp.asarray(mask_np), jnp.finfo(X.dtype).max, 0.0)
    min_dist_fn = jax.jit(lambda dist, C: jnp.minimum(dist, jnp.min(pairwise_dist2(X, C), axis=-1)))

    last_size = 0
    while True:
        newC = X[jnp.asarray(seeds[last_size:])]
        dist = min_dist_fn(dist, newC)
        if len(seeds) > size_factor * K:
            break
        dsum = float(jnp.sum(jnp.where(jnp.asarray(mask_np), dist, 0.0)))
        last_size = len(seeds)
        rng_key, ks = jax.random.split(rng_key)
        u = np.asarray(jax.random.uniform(ks, (n,)))
        p = np.asarray(dist) * oversampling_factor * K / max(dsum, 1e-300)
        chosen = np.nonzero((u < p) & mask_np)[0]
        seeds.extend(int(i) for i in chosen)
        if len(seeds) == last_size:
            break

    # top up with uniformly random valid points if undersampled
    while len(seeds) <= size_factor * K:
        rng_key, kr = jax.random.split(rng_key)
        seeds.append(int(valid_idx[int(jax.random.randint(kr, (), 0, len(valid_idx)))]))

    seed_idx = jnp.asarray(seeds)
    S = X[seed_idx]
    # weight each seed by the number of data points it currently claims
    belong = jnp.argmin(pairwise_dist2(X, S), axis=-1)
    w = jnp.sum((belong[:, None] == jnp.arange(len(seeds))[None, :]) & mask[:, None],
                axis=0).astype(X.dtype)

    rng_key, kpp = jax.random.split(rng_key)
    C, _ = kmeanspp(S, jnp.ones(len(seeds), dtype=bool), K, kpp, weights=w)
    return lloyd(X, mask, C)


@functools.partial(jax.jit,
                   static_argnames=("K", "oversampling_factor",
                                    "size_factor", "max_rounds"))
def kmeansii_device(X, mask, K: int, key: jax.Array,
                    oversampling_factor: float = 2.0,
                    size_factor: float = 2.0, max_rounds: int = 12):
    """Fully device-side k-means|| — one jitted program, vmappable over a
    speaker bank (VERDICT r1 item 7: the host-orchestrated `kmeansii`
    round-trips once per sampling round and forces the kmeans-init
    enrollment path to train speakers serially).

    Same algorithm as kmeansII.cc:82-171 (per-round Bernoulli inclusion
    with p = min(1, l*K*d2_i / sum d2), stop when > size_factor*K seeds or
    a round adds none, weight seeds by claimed cluster size, weighted
    k-means++ recluster, final Lloyd's on the full data) with the
    variable-length seed list carried as a boolean membership mask and a
    fixed per-round candidate buffer, so shapes stay static:

      * per round, at most R_MAX = 4*ceil(l*K) new seeds take effect
        (expected count is l*K, so the cap binds with negligible
        probability — and the reference's own loop caps total seeds at
        ~size_factor*K anyway);
      * rounds are bounded by max_rounds (the expected round count to
        exceed 2K seeds is ~2 rounds).
    """
    X = jnp.asarray(X)
    n, d = X.shape
    dt = X.dtype
    maskf = mask.astype(dt)
    l = oversampling_factor * K
    r_max = int(4 * np.ceil(l))
    cap = int(np.floor(size_factor * K)) + 1 + r_max  # seed buffer bound

    k0, k_rounds, k_fill, kpp = jax.random.split(key, 4)

    # first seed: uniform over valid points
    u0 = jax.random.uniform(k0, dtype=dt) * jnp.sum(maskf)
    first = jnp.clip(jnp.searchsorted(jnp.cumsum(maskf), u0), 0, n - 1)
    is_seed = jnp.zeros((n,), bool).at[first].set(True)
    dist = jnp.where(mask, jnp.full((n,), jnp.finfo(dt).max, dt), 0.0)
    dist = jnp.minimum(dist, pairwise_dist2(X, X[first][None])[:, 0])

    def round_body(i, carry):
        is_seed, dist, count, done = carry
        kk = jax.random.fold_in(k_rounds, i)
        dsum = jnp.maximum(jnp.sum(jnp.where(mask, dist, 0.0)), 1e-30)
        p = dist * (l / dsum)
        chosen = (jax.random.uniform(kk, (n,), dtype=dt) < p) & mask \
            & ~is_seed & ~done
        # gather at most r_max chosen indices into a fixed buffer
        order = jnp.where(chosen, jnp.arange(n), n)
        idx = jnp.sort(order)[:r_max]                    # [r_max], n = pad
        valid = idx < n
        gi = jnp.clip(idx, 0, n - 1)
        newC = X[gi]                                     # [r_max, d]
        d2 = pairwise_dist2(X, newC)                     # [n, r_max]
        d2 = jnp.where(valid[None, :], d2, jnp.finfo(dt).max)
        dist_new = jnp.minimum(dist, jnp.min(d2, axis=-1))
        n_new = jnp.sum(valid).astype(jnp.int32)
        # membership update must match the gathered set exactly: a point is
        # added iff its index made the first r_max chosen
        added = chosen & (order <= jnp.max(jnp.where(valid, idx, -1)))
        is_seed_new = is_seed | added
        count_new = count + n_new
        done_new = done | (count_new > size_factor * K) | (n_new == 0)
        keep = ~done
        return (jnp.where(keep, is_seed_new, is_seed),
                jnp.where(keep, dist_new, dist),
                jnp.where(keep, count_new, count),
                done_new)

    is_seed, dist, count, _ = jax.lax.fori_loop(
        0, max_rounds, round_body,
        (is_seed, dist, jnp.asarray(1, jnp.int32), jnp.asarray(False)))

    # gather seeds into the fixed [cap] buffer (pad slots -> random valid
    # points, the reference's uniform top-up, kmeansII.cc:139-146)
    order = jnp.where(is_seed, jnp.arange(n), n)
    sidx = jnp.sort(order)[:cap]
    if cap > n:
        # fewer frames than the seed buffer (short enrollments: n < ~2K +
        # 4*ceil(l) — e.g. a 3 s utterance at K=32): the [:cap] slice of a
        # length-n array stays length n, so pad the buffer explicitly;
        # pad slots (index n) become random valid points below, exactly
        # like unused buffer slots
        sidx = jnp.pad(sidx, (0, cap - n), constant_values=n)
    pad = sidx >= n
    u = jax.random.uniform(k_fill, (cap,), dtype=dt)[:, None]
    rand_idx = jnp.clip(jnp.searchsorted(jnp.cumsum(maskf),
                                         (u * jnp.sum(maskf))[:, 0]), 0, n - 1)
    sidx = jnp.where(pad, rand_idx, jnp.clip(sidx, 0, n - 1))
    S = X[sidx]                                          # [cap, d]

    # weight each seed by the number of valid points it claims
    belong = jnp.argmin(pairwise_dist2(X, S), axis=-1)
    w = jnp.sum((belong[:, None] == jnp.arange(cap)[None, :])
                & mask[:, None], axis=0).astype(dt)

    C, _ = kmeanspp(S, jnp.ones(cap, bool), K, kpp, weights=w)
    return lloyd(X, mask, C)
