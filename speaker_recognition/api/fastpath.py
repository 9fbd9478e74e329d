"""The batched serving program: one jitted program per geometry.

    scores = features (features/extract: packed DFT + mel/log/DCT + CMVN
                       + Levinson, plain XLA)
           + bank scoring (the fused kernel ops/pallas_gmm where
                           pallas_gmm.use_kernel holds, else
                           models/gmm.batch_bank_avg_loglik in XLA)

ModelInterface.scores_batch pads a request to a (batch bucket, length
bucket) geometry and calls `scores_fn` for it.
"""

from __future__ import annotations

import functools

import jax

from ..config import FeatureConfig
from ..features import extract
from ..models import gmm as gmm_mod
from ..ops import pallas_gmm

__all__ = ["scores_fn"]


@functools.lru_cache(maxsize=32)
def scores_fn(fs: int, cfg: FeatureConfig, padded_len: int,
              dtype: str = "float32", scoring: str = "xla",
              interpret: bool = False):
    """Jitted (signals [B, Lp], lengths [B], bank) -> ([B, S] average
    log-likelihoods, [B] has-valid-frames) for one geometry. `interpret`
    runs the kernel in the Pallas interpreter (CPU tests only)."""
    if scoring not in ("xla", "kernel"):
        raise ValueError(f"unknown scoring {scoring!r}")
    feature_fn = extract._feature_fn(fs, cfg, padded_len, dtype)

    @jax.jit
    def scores(signals, lengths, bank):
        with jax.named_scope("features"):
            feats, mask = feature_fn(signals, lengths)
        with jax.named_scope("scoring"):
            if scoring == "kernel":
                out = pallas_gmm.batch_bank_avg_loglik(
                    bank, feats, mask, interpret=interpret)
            else:
                out = gmm_mod.batch_bank_avg_loglik(bank, feats, mask)
        return out, mask.any(axis=-1)

    return scores
