"""The package's former import name (the alias package next to
speaker_recognition) resolves to the very same module objects, and runs
the GUI under `python -m`."""

import importlib
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMER = next(d for d in sorted(os.listdir(ROOT))
              if d.startswith("speaker_recognition_")
              and os.path.isfile(os.path.join(ROOT, d, "__init__.py")))


@pytest.mark.parametrize("sub", ["models.gmm", "api.interface",
                                 "ops.pallas_gmm"])
def test_former_name_is_the_same_module(sub):
    old = importlib.import_module(f"{FORMER}.{sub}")
    new = importlib.import_module(f"speaker_recognition.{sub}")
    assert old is new
    assert new.__spec__.name == f"speaker_recognition.{sub}"
    assert importlib.import_module(FORMER).__name__ == "speaker_recognition"


def test_former_name_runs_as_main():
    r = subprocess.run([sys.executable, "-m", f"{FORMER}.gui", "--help"],
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--model" in r.stdout
