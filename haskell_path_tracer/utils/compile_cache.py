"""Where JAX keeps its persistent compilation cache.

Every entry point calls `configure()` once before it compiles anything.
If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this module
leaves it alone; otherwise the cache goes to `<checkout>/.jax_cache`, a
fixed path (the path is part of the cache key), listed in `.gitignore`.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
