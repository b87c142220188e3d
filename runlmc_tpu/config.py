"""Global configuration helpers.

The library is dtype-polymorphic: numerical parity tests against dense
oracles run on CPU under ``jax_enable_x64`` in float64 (matching the
reference, which is float64 throughout — reference:
runlmc/linalg/matrix.py:22); models follow the x64 setting unless given
a ``dtype``.
"""

import os

import jax
import jax.numpy as jnp

# Platforms (``jax.default_backend()`` names) whose float64 arithmetic,
# Cholesky and FFT are native: XLA's CPU backend, and CUDA GPUs through
# cuBLAS/cuSOLVER/cuFFT.
_NATIVE_F64_PLATFORMS = ("cpu", "gpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_dtype():
    """Float dtype honoring ``jax_enable_x64``: f64 when enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_int_dtype():
    return jnp.int64 if jax.config.jax_enable_x64 else jnp.int32


def native_f64(platform=None):
    """Whether ``platform`` (default: JAX's default backend) factorizes
    float64 natively — true on the CPU and the GPU. Where it does, an
    f64 model escalates a failing f32 factorization to a model-dtype one;
    elsewhere it falls back to matvec-only (Krylov / Lanczos) paths."""
    return (platform or jax.default_backend()) in _NATIVE_F64_PLATFORMS


def compile_cache_dir(environ=None):
    """Directory for JAX's persistent compilation cache:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    root of the checkout (a fixed path, so later runs hit it)."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache at
    :func:`compile_cache_dir` for every compile that takes over half a
    second. For entry points (scripts), not for library code."""
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


# Machine epsilon used by numerical heuristics (reference:
# runlmc/util/numpy_convenience.py EPS).
EPS = 1e-10
