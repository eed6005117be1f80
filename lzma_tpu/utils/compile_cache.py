"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache is
the fixed `.jax_cache/` directory at the root of the checkout (listed in
.gitignore).  A fixed path matters: the cache key includes it, so a
directory that moves never hits.  Importing the library sets nothing;
entry points that compile device code call `enable_compile_cache()`.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns
    the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
