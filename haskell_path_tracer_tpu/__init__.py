"""Former import name of `haskell_path_tracer`, kept as an alias for one
release.  New code imports `haskell_path_tracer`.

Importing this package returns `haskell_path_tracer` itself, and every
submodule imported through this name is the very module object of
`haskell_path_tracer` (no second copy of any module or class), so
``python -m <this name>.app.main`` runs the CLI as before.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import haskell_path_tracer as _target

_PREFIX = __name__ + "."


def _target_name(name):
    return _target.__name__ + name[len(__name__):]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<this name>.X` to the module `haskell_path_tracer.X`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_PREFIX):
            return None
        real = importlib.util.find_spec(_target_name(name))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            name, self, is_package=real.submodule_search_locations is not None
        )

    def create_module(self, spec):
        module = importlib.import_module(_target_name(spec.name))
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # `create_module` returned the real, already executed module; undo
        # the import system's rebinding of its `__spec__` to the alias.
        module.__spec__ = self._specs.pop(module.__name__)

    def get_code(self, name):
        """For ``python -m``: the code of the real module."""
        real = importlib.util.find_spec(_target_name(name))
        return real.loader.get_code(real.name)


warnings.warn(
    f"{__name__} is now called {_target.__name__}; import that instead",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[__name__] = _target
