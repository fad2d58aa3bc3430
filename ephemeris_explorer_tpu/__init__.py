"""ephemeris_explorer_tpu: an accelerator-native ephemeris generation &
exploration engine.

A ground-up JAX/XLA rebuild of the compute core of Canleskis/ephemeris-explorer
(N-body propagation, piecewise-polynomial ephemerides, spacecraft flight-plan
propagation): lax.scan time stepping, batched least-squares fits, vmapped
spacecraft ensembles, shard_map scale-out.

The engine computes in native IEEE f64 (on the CPU and on the GPU alike);
the extended precisions keep the position state as f32 expansions beyond
what f64 holds (docs/ACCURACY.md).
"""

import os as _os

import jax as _jax

# The engine requires x64 semantics everywhere (km-scale positions at mm-scale
# precision).  Must run before any array is created.
_jax.config.update("jax_enable_x64", True)


def compile_cache_dir() -> str | None:
    """Where the package keeps JAX's persistent compilation cache.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX then reads the
    directory from the environment itself.  Otherwise a fixed path inside
    the checkout (``.jax_cache/``, listed in .gitignore): the path is part
    of the cache key, so it must not move between runs.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(__file__)), ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from . import ftime  # noqa: E402
from .ftime import Duration, Epoch  # noqa: E402

__version__ = "0.1.0"
