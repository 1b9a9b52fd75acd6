"""Process set-up shared by the entry points (CLI, bench, chip smoke test).

* ``enable_compile_cache``: JAX's persistent compilation cache.  When
  ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and nothing is
  set here; otherwise, on a GPU, the cache lives in ``.jax_cache`` at the
  root of the checkout (listed in ``.gitignore``), a fixed path, so later
  runs hit it.  On the CPU it stays off: XLA:CPU executables reloaded from
  the persistent cache abort the process (jaxlib 0.9.0, seen in the
  multi-trait resume test).
* ``require_gpu``: measurement paths fail, rather than fall back to the CPU,
  when JAX finds no GPU.
* ``card_info``: the card's name and power limit as ``nvidia-smi`` reports
  them, printed beside every number measured on it.
"""

from __future__ import annotations

import os
import subprocess

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache (module doc); returns the
    directory in use, or None (CPU without the env variable).  Reads the
    platform, so call it after any jax.distributed join."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    if jax.default_backend() != "gpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """Fail unless JAX's default device is a GPU; returns the devices."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU found (JAX devices: {devs})")
    return devs


def card_info() -> str:
    """``name, power.limit`` of each visible card, ';'-joined."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
