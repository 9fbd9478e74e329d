"""The package's former import name, kept so that existing callers keep
working until they move to `speaker_recognition`.

Every module imported under this name is the module object of the same
path in `speaker_recognition` (no second copy is loaded), and
`python -m <this name>.gui` runs `speaker_recognition.gui`.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import speaker_recognition as _package

_PREFIX = __name__ + "."


def _target(name: str) -> str:
    return _package.__name__ + name[len(__name__):]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds `<this name>.x` as `speaker_recognition.x`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_PREFIX):
            return None
        real = importlib.util.find_spec(_target(fullname))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None)

    def create_module(self, spec):
        module = importlib.import_module(_target(spec.name))
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system pointed the shared module's __spec__ at the
        # alias name; give it back its own
        module.__spec__ = self._specs.pop(module.__name__)

    def get_code(self, fullname):
        """For `python -m`: the code of the module under its own name."""
        real = importlib.util.find_spec(_target(fullname))
        return real.loader.get_code(real.name)


sys.meta_path.insert(0, _AliasFinder())
sys.modules[__name__] = _package
