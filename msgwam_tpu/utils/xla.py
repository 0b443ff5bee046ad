"""XLA environment helpers."""

from __future__ import annotations

import os

# XLA's while-loop unroller makes long `lax.scan` compiles scale with trip
# count (measured on XLA:CPU: 1440-step scan 47 s -> 13 s with the pass
# disabled, same runtime).  Harmless elsewhere.
_DISABLE_UNROLLER = "--xla_disable_hlo_passes=while_loop_unroller"

# The persistent compilation cache's default home: a fixed directory inside
# the checkout (listed in .gitignore).  The path is part of the cache key, so
# it must never depend on a temporary name, a pid or the time.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def recommended_xla_flags() -> str:
    return _DISABLE_UNROLLER


def apply_recommended_xla_flags() -> None:
    """Append the recommended flags to ``XLA_FLAGS``.  Must run before the
    first JAX backend initialization to take effect."""
    cur = os.environ.get("XLA_FLAGS", "")
    if _DISABLE_UNROLLER not in cur:
        os.environ["XLA_FLAGS"] = f"{cur} {_DISABLE_UNROLLER}".strip()


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else
    :data:`DEFAULT_COMPILE_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE_DIR


def enable_persistent_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache at :func:`compile_cache_dir`.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and no
    other is set in code.  Otherwise the cache lives at the fixed in-checkout
    path, except on the CPU backend: XLA:CPU persists AOT executables whose
    machine-feature stamp can differ between the compiling and the loading
    process, and CPU compiles are cheap anyway.  Only compilations slower
    than 2 s are persisted.  Returns the cache directory, or ``None`` when
    the cache stays off.  Safe to call more than once.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env and jax.default_backend() == "cpu":
        return None
    cache_dir = compile_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        # a read-only checkout must not break a run; it only loses the cache
        return None
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache_dir
