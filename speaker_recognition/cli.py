"""Command-line tool, drop-in compatible with src/speaker-recognition.py.

Same flags (-t/--task enroll|predict, -i/--input quoted globs, -m/--model),
same directory-name labeling, same stdout shape for predictions
("<file> -> <label>", speaker-recognition.py:85-90).
"""

from __future__ import annotations

import argparse
import glob
import itertools
import os
import sys

import numpy as np


def read_wav(fname):
    """Read a wav file -> (fs, mono signal) through the native IO runtime
    (threaded C++ decoder, utils/native_io.py), falling back to scipy.
    Mirrors src/gui/utils.py:10-13 but tolerates stereo (channel 0)."""
    from .utils import native_io
    return native_io.read_wav(fname)


def get_args(argv=None):
    desc = "Speaker Recognition Command Line Tool"
    epilog = """
Wav files in each input directory will be labeled as the basename of the
directory. Wildcard inputs should be *quoted* (they are passed to glob).

Examples:
    Enroll:  speaker-recognition.py -t enroll -i "./bob/ ./mary/" -m model.out
    Predict: speaker-recognition.py -t predict -i "./*.wav" -m model.out
"""
    parser = argparse.ArgumentParser(
        description=desc, epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('-t', '--task', required=True,
                        help='Task to do. Either "enroll" or "predict"')
    parser.add_argument('-i', '--input', required=True,
                        help='Input Files(to predict) or Directories(to enroll)')
    parser.add_argument('-m', '--model', required=True,
                        help='Model file to save(in enroll) or use(in predict)')
    return parser.parse_args(argv)


def task_enroll(input_dirs: str, output_model: str):
    """Mirrors speaker-recognition.py:52-83: glob dirs, label=dir basename,
    enroll every contained wav, train, dump."""
    from .api.interface import ModelInterface

    m = ModelInterface()
    patterns = [os.path.expanduser(k) for k in input_dirs.strip().split()]
    dirs = itertools.chain(*(glob.glob(d) for d in patterns))
    dirs = [d for d in dirs if os.path.isdir(d)]
    if len(dirs) == 0:
        print("No valid directory found!")
        sys.exit(1)
    training_stats = []
    for d in dirs:
        label = os.path.basename(d.rstrip('/'))
        wavs = glob.glob(d + '/*.wav')
        if len(wavs) == 0:
            print(f"No wav file found in {d}")
            continue
        print(f"Label '{label}' has files: {', '.join(wavs)}")
        total_len = 0
        for wav in wavs:
            fs, signal = read_wav(wav)
            print(f"   File '{wav}' has frequency={fs} and length={len(signal)}")
            total_len += len(signal)
            m.enroll(label, fs, signal)
        training_stats.append((label, total_len))
    print("--------------------------------------------")
    if not training_stats:
        print("No wav files found in any input directory!")
        sys.exit(1)
    for label, total_len in training_stats:
        print(f"Total length of training data for '{label}' is {total_len}")
    print("For best accuracy, please make sure all labels have similar "
          "amount of training data!")
    m.train()
    m.dump(output_model)


def task_predict(input_files: str, input_model: str):
    """Mirrors speaker-recognition.py:85-90, but scores all files in one
    batched program instead of looping per file."""
    from .api.interface import ModelInterface

    m = ModelInterface.load(input_model)
    files = sorted(glob.glob(os.path.expanduser(input_files)))
    if not files:
        return
    signals, fss = [], []
    for f in files:
        fs, signal = read_wav(f)
        fss.append(fs)
        signals.append(signal)
    if len(set(fss)) == 1:
        labels = m.predict_batch(fss[0], signals)
    else:  # mixed sample rates: per-file fallback
        labels = [m.predict(fs, s) for fs, s in zip(fss, signals)]
    for f, label in zip(files, labels):
        print(f, '->', label)


def main(argv=None):
    args = get_args(argv)
    from .utils import compile_cache
    compile_cache.enable()
    if args.task == 'enroll':
        task_enroll(args.input, args.model)
    elif args.task == 'predict':
        task_predict(args.input, args.model)
    else:
        print(f"unknown task: {args.task}")
        sys.exit(1)


if __name__ == '__main__':
    main()
