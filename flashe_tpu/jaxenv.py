"""Process-level JAX setup shared by every entry point, and the one place
that picks a kernel for the device an array lives on.

- backend selection: ``--cpu`` flags flip ``jax_platforms`` through
  ``jax.config`` before the first backend use;
- the persistent compilation cache: the bitsliced AES stream program
  costs tens of seconds of XLA compile time, and a federated job pays it
  once per role process.  With the on-disk cache only the first process
  compiles; later ones deserialize (cache keys include the backend, so
  CPU and GPU entries share one directory).  ``JAX_COMPILATION_CACHE_DIR``
  wins when it is set; otherwise the cache lives at ``<repo>/.jax_cache``,
  a fixed path, because the path is part of what a cache entry matches;
- ``mask_kernel``: the fused mask kernel (ops/fused_mask.py, CUDA through
  jax.ffi) runs where the data is on a CUDA GPU, the XLA stream path
  everywhere else.
"""

from __future__ import annotations

import os

__all__ = ["setup", "cache_dir", "mask_kernel"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DONE = False


def cache_dir() -> str:
    """Where the persistent compilation cache lives."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def setup(force_cpu: bool = False) -> None:
    """Idempotent; safe to call from any entry point, any number of times.

    Must run before the first jit trace for the cache to apply to it
    (later calls still help later compiles)."""
    global _DONE
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if _DONE:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # jax reads the variable itself when it is set
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    _DONE = True


def mask_kernel(where) -> str:
    """"cuda" where the fused CUDA mask kernel applies, else "xla".

    where: a concrete jax.Array (its committed device decides), a
    jax.Device, a jax.sharding.Mesh (its devices decide), or a numpy
    array (it will land on the default device).  A traced value carries
    no device: pass the mesh or device it runs on instead.
    """
    import numpy as np
    import jax
    from jax.sharding import Mesh

    if isinstance(where, Mesh):
        platforms = {d.platform for d in where.devices.flat}
    elif isinstance(where, jax.core.Tracer):
        raise TypeError("mask_kernel needs a concrete array, device or "
                        "mesh; a traced value has no device")
    elif isinstance(where, jax.Array):
        platforms = {d.platform for d in where.devices()}
    elif isinstance(where, np.ndarray):
        platforms = {jax.devices()[0].platform}
    else:
        platforms = {where.platform}
    return "cuda" if platforms == {"gpu"} else "xla"
