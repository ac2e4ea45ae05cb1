"""Process set-up shared by the entry points: the accelerator they require
and the persistent compile cache."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

_CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Keep XLA's compiled programs across processes.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and wins.
    Otherwise the cache lives at ``<checkout>/.jax_cache``: a fixed path,
    since the path is part of the cache key. Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: measurement entry points never
    fall back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line each.

    Numbers taken on a card are only comparable at the same power limit, so
    every measurement prints this beside its results.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
