"""VAD behavior on the UBM-anchored speech-like corpus (VERDICT r3 item 5).

The LTSD VAD tests elsewhere use tones/noise; these run the detector on
the r4 UBM-anchored generator's output — all-pole vocal tracts taken from
the reference's shipped 256-mix UBM with glottal-pulse excitation
(experiments/make_synth_corpus.synth_ubm), the most speech-like signal
family available in this environment — so the VAD decisions are exercised
on signals with real-speech spectral envelopes, voiced/unvoiced
alternation and pauses rather than on sinusoid stacks.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))), "experiments"))

from make_synth_corpus import (  # noqa: E402
    UBM_PATH, load_ubm_phones, make_ubm_speaker, synth_ubm)
from speaker_recognition.vad.ltsd import LtsdVad  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.exists(UBM_PATH),
    reason="reference UBM not mounted: the anchored generator needs "
           f"{UBM_PATH} (these tests exercise the VAD on UBM-anchored "
           "speech; the tone/noise LTSD tests in test_vad.py still run)")

FS = 8000


@pytest.fixture(scope="module")
def anchored_clip():
    rng = np.random.RandomState(42)
    phones = load_ubm_phones(n_phones=24, seed=3)
    spk = make_ubm_speaker(rng, phones)
    speech = synth_ubm(spk, phones, 4.0, rng, pause_p=0.0)
    noise = (rng.randn(FS * 2) * 60).astype(np.float64)
    return speech.astype(np.float64), noise


def test_vad_keeps_most_anchored_speech(anchored_clip):
    """Continuous anchored speech against a quiet noise profile must
    survive the VAD largely intact (the production enroll path depends on
    this — interface.py:43-53 keeps the original only above the 1/3
    rule)."""
    speech, noise = anchored_clip
    vad = LtsdVad()
    vad.init_params_by_noise(FS, noise)
    kept, intervals = vad.filter(speech)
    assert len(intervals) >= 1
    assert len(kept) > 0.5 * len(speech), (
        f"VAD kept only {len(kept)}/{len(speech)} samples of continuous "
        f"anchored speech")


def test_vad_strips_silence_gap(anchored_clip):
    """A long inserted silence gap (noise-level) inside anchored speech
    must be excluded from the kept intervals."""
    speech, noise = anchored_clip
    rng = np.random.RandomState(1)
    gap = (rng.randn(FS) * 60)  # 1 s of the same noise process
    mid = len(speech) // 2
    sig = np.concatenate([speech[:mid], gap, speech[mid:]])
    vad = LtsdVad()
    vad.init_params_by_noise(FS, noise)
    kept, intervals = vad.filter(sig)
    # the gap occupies samples [mid, mid+FS); intervals overlapping its
    # interior by more than the LTSD window are failures
    ws = vad.window_size
    overlap = sum(max(0, min(e, mid + FS - ws) - max(s, mid + ws))
                  for s, e in intervals)
    assert overlap < FS * 0.35, (
        f"VAD kept {overlap} samples inside a 1 s silence gap; "
        f"intervals={intervals}")
    assert len(kept) > 0.4 * len(speech)


def test_vad_rejects_pure_noise(anchored_clip):
    """A clip of the calibration-noise process alone must be (almost)
    fully rejected — the reject path of interface.py:43-53."""
    _, noise = anchored_clip
    rng = np.random.RandomState(2)
    clip = (rng.randn(FS * 3) * 60)
    vad = LtsdVad()
    vad.init_params_by_noise(FS, noise)
    kept, _ = vad.filter(clip)
    assert len(kept) < 0.2 * len(clip)
