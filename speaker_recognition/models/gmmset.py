"""Speaker model bank: enrollment, batched scoring, open-set rejection.

Re-design of the reference's GMMSet (src/gui/skgmm.py:11-39 and
src/testbench/gmmset.py:16-105). The reference loops over per-speaker GMM
objects to score an utterance; here the bank is one stacked GmmParams
([S, K, d]) and scoring every speaker against every frame is a single
batched program (models/gmm.py:bank_avg_loglik) — across devices the S
axis shards over the 'bank' mesh axis (see parallel/).

Training is equally batched: per-speaker feature sets are padded to a
common frame count and the EM fit vmaps over the speaker axis, replacing
the reference's serial fit loop (src/gui/interface.py:81-82).
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

from ..config import GmmConfig
from . import gmm

__all__ = ["GMMSet"]

# Serial predict calls arrive with exact per-utterance frame counts; the
# frame axis is padded (masked) to a multiple of this bucket so the jitted
# scoring program compiles once per bucket, not once per clip length.
SCORE_FRAME_BUCKET = 256


@jax.jit
def _serial_scores(bank: gmm.GmmParams, X: jnp.ndarray,
                   mask: jnp.ndarray) -> jnp.ndarray:
    """One padded utterance [Tp, d] against the bank -> [S], jitted."""
    return gmm.bank_avg_loglik(bank, X, mask)


@jax.jit
def _serial_scores_with_ubm(bank: gmm.GmmParams, ubm: gmm.GmmParams,
                            X: jnp.ndarray, mask: jnp.ndarray):
    """([S] bank scores, scalar UBM score) in ONE program — the open-set
    decision quantities (testbench/gmmset.py:69-81)."""
    return gmm.bank_avg_loglik(bank, X, mask), gmm.avg_loglik(ubm, X, mask)


def _pad_frames_bucket(x: np.ndarray):
    """[T, d] exact-length frames -> ([Tp, d], [Tp] mask) with Tp a
    SCORE_FRAME_BUCKET multiple (numpy-side; no device ops)."""
    T = x.shape[0]
    Tp = -(-max(T, 1) // SCORE_FRAME_BUCKET) * SCORE_FRAME_BUCKET
    if Tp != T:
        x = np.concatenate(
            [x, np.zeros((Tp - T, x.shape[1]), x.dtype)], axis=0)
    return x, np.arange(Tp) < T


def _pad_stack(feature_list):
    """list of [T_i, d] -> ([S, T_max, d], [S, T_max] mask)."""
    d = feature_list[0].shape[1]
    T = max(f.shape[0] for f in feature_list)
    X = np.zeros((len(feature_list), T, d), np.float64)
    mask = np.zeros((len(feature_list), T), bool)
    for i, f in enumerate(feature_list):
        X[i, : f.shape[0]] = f
        mask[i, : f.shape[0]] = True
    return X, mask


class GMMSet:
    """Bank of per-speaker GMMs with optional UBM for MAP + rejection.

    API mirrors src/testbench/gmmset.py:GMMSet: fit_new/fit, predict_one,
    predict_one_scores, predict_one_with_rejection; plus batched variants
    (predict_batch) that the reference lacks.
    """

    def __init__(self, gmm_order: int = 32, ubm: gmm.GmmParams | None = None,
                 reject_threshold: float = 10.0, config: GmmConfig | None = None,
                 dtype: str = "float32"):
        self.ubm = ubm
        self.reject_threshold = reject_threshold  # gmmset.py:18
        if ubm is not None:
            self.gmm_order = ubm.n_mixtures  # gmmset.py:24-27
        else:
            self.gmm_order = gmm_order
        self.config = config or GmmConfig(n_mixtures=self.gmm_order)
        self.dtype = dtype
        self.y: list[str] = []
        self._pending: list[np.ndarray] = []
        self.bank: gmm.GmmParams | None = None

    # -- enrollment --------------------------------------------------------

    def fit_new(self, x: np.ndarray, label: str):
        """Queue one speaker's frames; the actual (batched) fit happens in
        train(). Mirrors gmmset.py:29-34 but defers so all speakers train in
        one vmapped program."""
        self.y.append(label)
        self._pending.append(np.asarray(x, np.float64))

    def fit(self, X, y):
        """Group samples by label and enroll (gmmset.py:36-53)."""
        grouped: dict[str, list] = {}
        for xi, yi in zip(X, y):
            grouped.setdefault(yi, []).append(np.asarray(xi))
        for label, parts in grouped.items():
            self.fit_new(np.concatenate(parts, axis=0), label)
        self.train()

    def train(self, seed: int = 0):
        """Fit every pending speaker in one vmapped EM program."""
        if not self._pending:
            return
        dt = jnp.dtype(self.dtype)
        Xs, masks = _pad_stack(self._pending)
        Xs = jnp.asarray(Xs, dt)
        masks = jnp.asarray(masks)
        S = Xs.shape[0]
        cfg = self.config
        if self.ubm is not None:
            ubm = jax.tree.map(lambda a: jnp.asarray(a, dt), self.ubm)
            fit = jax.vmap(lambda x, m: gmm.fit_from_ubm(x, m, ubm, cfg))
            new_bank, _ = fit(Xs, masks)
        elif cfg.init_with_kmeans:
            # device-side k-means|| seeding (kmeans.kmeansii_device), so
            # the whole bank trains in one vmapped program like the other
            # init paths (init is off by default, pygmm.py:44)
            keys = jax.random.split(jax.random.PRNGKey(seed), S)
            fit = jax.vmap(lambda x, m, k: gmm.fit_with_init(x, m, cfg, k))
            new_bank, _ = fit(Xs, masks, keys)
        else:
            keys = jax.random.split(jax.random.PRNGKey(seed), S)
            fit = jax.vmap(lambda x, m, k: gmm.fit(x, m, cfg, k))
            new_bank, _ = fit(Xs, masks, keys)
        new_bank = jax.tree.map(lambda a: np.asarray(a), new_bank)
        if self.bank is None:
            self.bank = new_bank
        else:
            self.bank = gmm.GmmParams(*(np.concatenate([old, new], axis=0)
                                        for old, new in zip(self.bank, new_bank)))
        self._pending = []

    # -- scoring -----------------------------------------------------------

    def _device_bank(self):
        """Device-resident cast of the bank, cached so predict calls
        (batched requests, conversation ticks, per-utterance harness calls)
        do not re-upload the parameters every call."""
        dt = jnp.dtype(self.dtype)
        cached = getattr(self, "_bank_cache", None)
        if cached is None or cached[0] is not self.bank:
            dev = jax.tree.map(lambda a: jnp.asarray(a, dt), self.bank)
            self._bank_cache = (self.bank, dev)
        return self._bank_cache[1]

    def _device_ubm(self):
        dt = jnp.dtype(self.dtype)
        cached = getattr(self, "_ubm_cache", None)
        if cached is None or cached[0] is not self.ubm:
            dev = jax.tree.map(lambda a: jnp.asarray(a, dt), self.ubm)
            self._ubm_cache = (self.ubm, dev)
        return self._ubm_cache[1]

    def _scores(self, x: np.ndarray) -> np.ndarray:
        """Per-speaker average log-likelihood of one utterance: [S].

        Frame-bucketed + jitted: one program dispatch per call (the
        conversation-mode tick path; see SCORE_FRAME_BUCKET)."""
        if self.bank is None:  # real error, python -O safe (ADVICE r4)
            raise RuntimeError("train() must run before predict")
        dt = jnp.dtype(self.dtype)
        Xp, mask = _pad_frames_bucket(np.asarray(x, dt))
        return np.asarray(_serial_scores(
            self._device_bank(), jnp.asarray(Xp), jnp.asarray(mask)))

    def llr_scores(self, x: np.ndarray):
        """(per-speaker scores [S], ubm per-frame score) for one utterance —
        the open-set decision quantities (gmmset.py:69-81), exposed so
        callers need not recompute them."""
        if self.bank is None:
            raise RuntimeError("train() must run before predict")
        if self.ubm is None:
            raise RuntimeError("llr_scores requires a UBM")
        dt = jnp.dtype(self.dtype)
        Xp, mask = _pad_frames_bucket(np.asarray(x, dt))
        scores, ubm_score = _serial_scores_with_ubm(
            self._device_bank(), self._device_ubm(), jnp.asarray(Xp),
            jnp.asarray(mask))
        return np.asarray(scores), float(ubm_score)

    def predict_one_scores(self, x):
        return list(self._scores(x))

    def predict_one(self, x) -> str:
        """argmax over per-speaker scores (skgmm.py:33-39; the pygmm flavor
        normalizes by frame count, gmmset.py:96-100 — argmax invariant)."""
        scores = self._scores(x)
        return self.y[int(np.argmax(scores))]

    def predict(self, X):
        return [self.predict_one(x) for x in X]

    def predict_one_with_rejection(self, x):
        """Open-set decision (gmmset.py:69-81): reject (None) when the best
        per-frame score beats the UBM's by less than reject_threshold."""
        if self.ubm is None:
            # the reference's own message (testbench/gmmset.py:71)
            raise RuntimeError(
                "UBM must be given prior to conduct reject prediction.")
        scores, ubm_score = self.llr_scores(x)
        best = int(np.argmax(scores))
        if scores[best] - ubm_score < self.reject_threshold:
            return None
        return self.y[best]

    def predict_with_reject(self, X):
        return [self.predict_one_with_rejection(x) for x in X]

    # -- rejection calibration (VERDICT r4 item 4) -------------------------

    def rejection_margin(self, x) -> float:
        """The open-set decision statistic for one utterance: best
        per-frame bank score minus the UBM per-frame score — exactly what
        predict_one_with_rejection thresholds (gmmset.py:69-81)."""
        scores, ubm_score = self.llr_scores(x)
        return float(np.max(scores) - ubm_score)

    def calibrate_rejection(self, dev_genuine, dev_imposter,
                            target: str = "eer", max_far: float = 0.05):
        """Set reject_threshold from development data instead of the
        reference's fixed constant 10 (gmmset.py:18) — which r4 measured
        to be a corpus-dependent operating point (on the anchored corpus
        genuine margins are ~1-2 nats, so threshold 10 rejects 100% of
        genuine trials; experiments/results/r4_reject_ubm.jsonl).

        dev_genuine / dev_imposter: lists of feature arrays [T, d]
        (utterances of enrolled speakers / of impostors). target:
          "eer" — threshold where false-accept and false-reject rates
                  cross (the transferable operating point);
          "far" — smallest threshold with FAR <= max_far on the dev set.
        Returns the operating point dict (also what gets persisted with
        the session: reject_threshold round-trips via state())."""
        if self.ubm is None:
            raise RuntimeError("calibrate_rejection requires a UBM")
        if not dev_genuine or not dev_imposter:
            raise ValueError("both dev sets must be non-empty")
        g = np.asarray([self.rejection_margin(x) for x in dev_genuine])
        i = np.asarray([self.rejection_margin(x) for x in dev_imposter])
        # candidate thresholds: midpoints of the pooled sorted margins
        # (every distinct (FAR, FRR) trade-off appears at one of these)
        pooled = np.sort(np.concatenate([g, i]))
        cands = np.concatenate([[pooled[0] - 1.0],
                                (pooled[:-1] + pooled[1:]) / 2.0,
                                [pooled[-1] + 1.0]])
        far = np.asarray([(i >= t).mean() for t in cands])   # false accept
        frr = np.asarray([(g < t).mean() for t in cands])    # false reject
        if target == "eer":
            k = int(np.argmin(np.abs(far - frr)))
        elif target == "far":
            ok = np.nonzero(far <= max_far)[0]
            if len(ok) == 0:
                k = len(cands) - 1  # reject everything: FAR = 0
            else:
                k = int(ok[0])      # smallest such threshold: lowest FRR
        else:
            raise ValueError(f"unknown target {target!r}")
        self.reject_threshold = float(cands[k])
        return {"threshold": self.reject_threshold,
                "far": float(far[k]), "frr": float(frr[k]),
                "eer": float((far[k] + frr[k]) / 2.0),
                "target": target, "n_genuine": len(g), "n_imposter": len(i),
                "genuine_margins": [round(float(v), 4) for v in g],
                "imposter_margins": [round(float(v), 4) for v in i]}

    def load_gmm(self, label: str, fname: str):
        """Append a pre-trained GMM from a reference-format text model file
        as a new speaker (GMMSet.load_gmm, gmmset.py:83-88)."""
        from ..utils import serialization

        with open(fname) as f:
            params = serialization.load_reference_gmm(f)
        self.y.append(label)
        new = gmm.GmmParams(params.weights[None], params.means[None],
                            params.sigmas[None])
        if self.bank is None:
            self.bank = jax.tree.map(np.asarray, new)
        else:
            self.bank = gmm.GmmParams(*(np.concatenate([old, np.asarray(n)], axis=0)
                                        for old, n in zip(self.bank, new)))

    # -- persistence helpers ----------------------------------------------

    def state(self) -> dict:
        if self.bank is None:
            raise RuntimeError("train() must run before state()")
        st = {
            "labels": list(self.y),
            "weights": np.asarray(self.bank.weights),
            "means": np.asarray(self.bank.means),
            "sigmas": np.asarray(self.bank.sigmas),
            "reject_threshold": self.reject_threshold,
        }
        if self.ubm is not None:
            st["ubm_weights"] = np.asarray(self.ubm.weights)
            st["ubm_means"] = np.asarray(self.ubm.means)
            st["ubm_sigmas"] = np.asarray(self.ubm.sigmas)
        return st

    @classmethod
    def from_state(cls, st: dict, config: GmmConfig | None = None,
                   dtype: str = "float32") -> "GMMSet":
        ubm = None
        if "ubm_weights" in st:
            ubm = gmm.GmmParams(st["ubm_weights"], st["ubm_means"], st["ubm_sigmas"])
        obj = cls(gmm_order=st["weights"].shape[-1], ubm=ubm,
                  reject_threshold=float(st["reject_threshold"]),
                  config=config, dtype=dtype)
        obj.y = [str(l) for l in st["labels"]]
        obj.bank = gmm.GmmParams(st["weights"], st["means"], st["sigmas"])
        return obj
