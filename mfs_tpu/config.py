"""Global numerical configuration for mfs-tpu.

The moment-filtering pipeline factorises Hankel/Gram matrices whose
condition number grows roughly exponentially with the moment order
``2N - 1``.  The reference library (reference: ``dardel/*/mf.py:16``)
simply flips ``jax_enable_x64`` on and runs on CPU.  mfs-tpu does the
same on the GPU: the moment core runs in f64 by default
(``enable_x64()``), where no matrix product is computed in TF32.  The
default eigensolver engine seeds with an f32 ``eigh`` and polishes in
f64 (``mfs_tpu.ops.eigh.eigh_refined``).

For speed experiments the whole pipeline also runs in f32 together with
the scaled-central moment mode; see ``mfs_tpu.one_dim.filtering``.
"""
import os

import jax


def enable_x64(enable: bool = True) -> None:
    """Enable (or disable) double precision globally.

    Call this before creating any arrays.  The moment core is validated
    against the reference tolerances in f64.
    """
    jax.config.update("jax_enable_x64", enable)


def default_float():
    """The current default floating dtype (honours jax_enable_x64)."""
    import jax.numpy as jnp

    return jnp.zeros(0).dtype


# The compile cache's home when ``JAX_COMPILATION_CACHE_DIR`` is unset:
# one fixed directory in the checkout (listed in ``.gitignore``).  The
# path is part of the cache key, so it must not vary between runs.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is set here.  Otherwise the cache goes to
    ``DEFAULT_COMPILE_CACHE_DIR``.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR
