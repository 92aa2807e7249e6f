"""The package's former name, kept so that scripts and entry points written
against it keep working. Every module of this package is the same module
object as its counterpart under `amg_jax` (so `<this package>.utils.cli.main`
is `amg_jax.utils.cli.main`, and `python -m <this package>.utils.cli` runs
the CLI); nothing is copied and no state is duplicated."""

import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import sys

import amg_jax
from amg_jax import *  # noqa: F401,F403

_TARGET = amg_jax.__name__


def _target(name: str) -> str:
    return _TARGET + name[len(__name__):]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<this package>.x.y` to the module `amg_jax.x.y`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(__name__ + "."):
            return None
        real = importlib.util.find_spec(_target(fullname))
        if real is None:
            return None
        # origin: `python -m` puts it in sys.argv[0]
        return importlib.machinery.ModuleSpec(
            fullname, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None,
        )

    def create_module(self, spec):
        module = importlib.import_module(_target(spec.name))
        # the import system stamps the alias spec on the module it gets
        # back; exec_module puts the module's own spec back
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = self._specs.pop(module.__name__)

    def get_code(self, fullname):
        """For `python -m`: the code of the real module."""
        real = importlib.util.find_spec(_target(fullname))
        return real.loader.get_code(real.name)


sys.meta_path.insert(0, _AliasFinder())
