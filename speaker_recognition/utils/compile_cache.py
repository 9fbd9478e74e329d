"""Where the program keeps JAX's persistent compilation cache.

JAX_COMPILATION_CACHE_DIR wins when it is set; otherwise the cache lives in
`<checkout>/.jax_cache` (listed in .gitignore). Entry points call
`enable()` once, before their first compile.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable() -> str:
    """Point JAX's compilation cache at cache_dir() and return it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
