"""Runtime configuration helpers."""

import os

# fixed default: the cache path is part of a cached entry's key, so a
# directory that moved between runs would never hit
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Persistent XLA compilation cache, so a kernel compiles once per
    machine rather than once per process. JAX reads
    ``JAX_COMPILATION_CACHE_DIR`` itself; when it is unset the cache goes
    to ``<checkout>/.jax_cache``. Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_COMPILE_CACHE
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
