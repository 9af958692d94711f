"""Platform/runtime knobs for the device engine.

The engine runs the same XLA programs on every platform (the row-scan
fills of :mod:`globalign_jax.ops.fill_rows`, the row-layout walks, the
``shard_map`` paths); :func:`engine_platform` names the device they run
on, and :func:`require_gpu` is the guard for callers that must not fall
back to the CPU (benchmarks, the on-card smoke run).

The single-pair CLI is a fresh process per invocation; without a
persistent compilation cache every run pays the full XLA compile.
Enabling JAX's on-disk cache makes repeat invocations with the same
shapes skip it.
"""

from __future__ import annotations

import os
from pathlib import Path

_CACHE_ENABLED = False

# Default persistent-cache location: a fixed directory inside the
# checkout (listed in .gitignore).  The path is part of the cache key,
# so it must not depend on the process, the time or a temp directory.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def engine_platform() -> str:
    """Platform of the device the engine runs on ("gpu" or "cpu").

    Reads an explicit ``jax_platforms`` setting first, so a caller that
    pinned the CPU is answered without initializing another backend.
    """
    import jax

    plats = jax.config.jax_platforms
    if plats and plats.split(",")[0].strip() == "cpu":
        return "cpu"
    return jax.devices()[0].platform


def require_gpu() -> str:
    """``device_kind`` of the first GPU, or RuntimeError when JAX found
    none (JAX falls back to the CPU with only a warning when its CUDA
    plugin fails to start; measurements must not)."""
    import jax

    platform = engine_platform()
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX runs on {platform!r} "
            f"({jax.devices()[0].device_kind})"
        )
    return jax.devices()[0].device_kind


def compilation_cache_dir() -> Path:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the in-checkout
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent).

    Set ``GLOBALIGN_NO_CACHE=1`` to skip.  CPU executables are
    AOT-compiled for the exact host CPU, and a cache read back on a
    migrated VM can SIGILL; CPU compiles take seconds, so the cache is
    kept for accelerator binaries only.
    """
    global _CACHE_ENABLED
    if _CACHE_ENABLED or os.environ.get("GLOBALIGN_NO_CACHE"):
        return
    import jax

    try:
        if engine_platform() == "cpu":
            return
        path = compilation_cache_dir()
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception:
        # Cache is an optimization only — never fail an alignment over it.
        return
    _CACHE_ENABLED = True
