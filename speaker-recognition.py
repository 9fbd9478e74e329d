#!/usr/bin/env python3
"""Drop-in CLI entry point matching the reference's src/speaker-recognition.py
usage: -t enroll/predict, -i quoted globs, -m model file."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))

from speaker_recognition.cli import main

if __name__ == "__main__":
    main()
