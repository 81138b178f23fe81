"""JAX persistent compilation cache location.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set
(JAX reads that variable itself, so nothing else is configured then), and
otherwise in one fixed directory inside the checkout, ``<root>/.jax_cache``
(listed in ``.gitignore``): the path is part of the cache key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CACHE_SUBDIR = ".jax_cache"


def compile_cache_dir(root: str) -> str:
    """The cache directory a process rooted at ``root`` uses."""
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.abspath(root), CACHE_SUBDIR)


def configure_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and cache every compiled program; returns the directory.  Call before
    the first compilation."""
    import jax

    path = compile_cache_dir(root)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
