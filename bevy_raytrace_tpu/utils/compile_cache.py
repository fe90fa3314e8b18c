"""Persistent compile cache at a fixed path.

JAX keys its persistent cache on the directory as well as the program, so
a directory that moves (a pid, a time, a temporary name) never hits.  If
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives at `<checkout>/.jax_cache`, which
`.gitignore` lists.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory in use: the environment's, else the fixed
    in-checkout path."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()` and
    return it.  Sets no directory when the environment names one."""
    import jax

    environ = os.environ if environ is None else environ
    path = compile_cache_dir(environ)
    if not environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
