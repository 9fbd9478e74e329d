"""Experiment harness — equivalent of the reference's src/test/ sweep
scripts (test-nperson.py, test-mixture.py, test-feature.py) and the Sample
container (src/test/sample.py).

Accuracy-as-test, batched: where the reference fans predictions out over a
multiprocessing pool, every test fragment here goes through one padded
batched device program (ModelInterface.predict_batch). The unbiased-split
rule is kept: the training fragment is removed from the sample before test
fragments are drawn (test-feature.py:178-182, "important to remove signal
used for training").

Results are emitted as structured jsonl (one record per configuration),
replacing the reference's stdout-redirect logs (SURVEY.md section 5).
"""

from __future__ import annotations

import glob
import json
import os
import random
import sys
import time

import numpy as np
import scipy.io.wavfile as wavfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speaker_recognition.api.interface import ModelInterface
from speaker_recognition.config import GmmConfig, PipelineConfig


class Sample:
    """Concatenated per-speaker audio with unbiased fragment extraction
    (src/test/sample.py:11-55)."""

    def __init__(self, fs=None, signal=None):
        self.fs = fs
        self.signal = np.array([]) if signal is None else signal

    @staticmethod
    def from_wavfile(fname):
        fs, signal = wavfile.read(fname)
        if signal.ndim > 1:
            signal = signal[:, 0]
        return Sample(fs, signal)

    def duration(self):
        return len(self.signal) / float(self.fs)

    def add(self, other: "Sample"):
        if self.fs:
            assert other.fs == self.fs
        else:
            self.fs = other.fs
        self.signal = np.concatenate((self.signal, other.signal))

    def get_fragment_with_interval(self, duration, rng: random.Random):
        count = min(len(self.signal), int(duration * self.fs))
        pos = rng.randint(0, len(self.signal) - count)
        return self.fs, self.signal[pos:pos + count], pos, pos + count

    def get_fragment(self, duration, rng: random.Random):
        fs, signal, _, _ = self.get_fragment_with_interval(duration, rng)
        return fs, signal

    def remove_subsignal(self, begin, end):
        self.signal = np.concatenate((self.signal[:begin], self.signal[end:]))


def load_corpus(corpus_glob: str) -> dict:
    """{speaker_label: Sample} from a glob of wav files; the label is the
    filename prefix up to the last underscore group (reference corpus names
    like f_001_03.wav -> f_001) or the parent directory name."""
    samples: dict[str, Sample] = {}
    for path in sorted(glob.glob(corpus_glob)):
        base = os.path.splitext(os.path.basename(path))[0]
        parent = os.path.basename(os.path.dirname(path))
        if "_" in base:
            label = "_".join(base.split("_")[:2])
        else:
            label = parent
        s = Sample.from_wavfile(path)
        samples.setdefault(label, Sample()).add(s)
    return samples


def closed_set_trial(samples: dict, n_persons: int, train_duration: float,
                     test_duration: float, n_tests_per_person: int,
                     config: PipelineConfig, seed: int = 0):
    """One closed-set identification trial: returns (accuracy, timings)."""
    rng = random.Random(seed)
    labels = sorted(samples.keys())
    rng.shuffle(labels)
    labels = labels[:n_persons]

    model = ModelInterface(config)
    test_pool = []
    t0 = time.time()
    for label in labels:
        s = samples[label]
        work = Sample(s.fs, s.signal.copy())
        fs, sig, begin, end = work.get_fragment_with_interval(train_duration, rng)
        # unbiased split: training fragment removed before drawing tests
        work.remove_subsignal(begin, end)
        model.enroll(label, fs, sig)
        for _ in range(n_tests_per_person):
            _, tsig = work.get_fragment(test_duration, rng)
            test_pool.append((label, tsig))
    t_enroll_feat = time.time() - t0

    t0 = time.time()
    model.train()
    t_train = time.time() - t0

    t0 = time.time()
    fs = samples[labels[0]].fs
    preds = model.predict_batch(fs, [s for _, s in test_pool])
    t_predict = time.time() - t0

    truth = [l for l, _ in test_pool]
    acc = float(np.mean([p == t for p, t in zip(preds, truth)]))
    return acc, {"enroll_feature_s": t_enroll_feat, "train_s": t_train,
                 "predict_s": t_predict,
                 "predict_audio_s": len(test_pool) * test_duration}


def emit(record: dict, logfile: str | None):
    line = json.dumps(record)
    print(line, flush=True)
    if logfile:
        with open(logfile, "a") as f:
            f.write(line + "\n")
