"""Set-up shared by the scripts that run on the GPU (``chip_smoke.py``,
``bench.py``): the persistent compile cache, the device guard, the card's
``nvidia-smi`` identity line and the one-line JSON result.

Nothing here imports ``genjax_tpu``; it needs only JAX and the standard
library.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

import jax

ROOT = Path(__file__).resolve().parent
NVIDIA_SMI_QUERY = (
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
)


def compile_cache_dir(environ=None) -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, otherwise ``<checkout>/.jax_cache`` next to this file."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(ROOT / ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
    nothing is set here. Returns the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


class NoGPUError(RuntimeError):
    """Raised when JAX's first device is not a GPU."""


def require_gpu():
    """Return ``jax.devices()[0]``, or raise :class:`NoGPUError` when it is
    not a GPU. A run that measures or checks the card never falls back to
    another platform."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind!r}); this script runs only on the card"
        )
    return dev


def device_fields() -> dict:
    """The device identity every result line carries."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
    }


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``[(name, power_limit), ...]`` from the csv lines that
    :data:`NVIDIA_SMI_QUERY` prints, one per card."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi printed no card")
    return cards


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, read
    by a child process that stays off JAX."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip()
    parse_nvidia_smi(out)
    return out


def result_line() -> str:
    """The last line of a run whose every phase passed: ``{"ok": true,
    "device": {platform, kind, count}}`` with the device as JAX reports
    it."""
    devs = jax.devices()
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    })
