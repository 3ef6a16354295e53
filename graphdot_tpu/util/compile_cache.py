"""Persistent XLA compilation cache helper.

Compiling the Gram, gradient and sampler programs takes seconds to
minutes; JAX's persistent cache makes a later process with the same
programs start warm. The reference gets the same effect from its
source-keyed NVCC module cache
(``graphdot/kernel/marginalized/_backend_cuda.py:141-155``); here the
cache key is the XLA computation fingerprint, managed by JAX itself.
"""
import os

#: the cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: fixed, inside the checkout, and listed in ``.gitignore``
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def cache_dir():
    """The directory the persistent cache lives in:
    ``$JAX_COMPILATION_CACHE_DIR`` if set, else :data:`DEFAULT_DIR`."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs=1.0):
    """Turn on JAX's on-disk compilation cache in :func:`cache_dir`.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no path is set here. Programs that compiled in under
    ``min_compile_secs`` are not stored. Safe to call more than once;
    returns the cache directory in use.
    """
    import jax

    path = cache_dir()
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        os.makedirs(path, exist_ok=True)
        jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      float(min_compile_secs))
    return path
