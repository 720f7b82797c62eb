"""First-import health: every entry point must import cleanly in a FRESH
process, on the FIRST attempt.

Round 3 shipped an import cycle (``inference.smc_chees`` ↔
``kernels.chees`` through the eager ``inference/__init__`` fan-in) that the
in-process suite could never catch: after the first ``import genjax_tpu``
fails, the orphaned entries left in ``sys.modules`` make a *retry in the
same process* succeed, so any test that merely does ``import genjax_tpu``
passes as long as some earlier conftest import already paid the failure.
The only sound probe is a subprocess that imports once and exits
(VERDICT r3 item 1).

The reference analog is its root facade importing cleanly on first touch —
it even activates beartype at import, so breakage would be loud
(`/root/reference/src/genjax/__init__.py:26-43`).

Fast lane: the root facade plus every subpackage facade imported FIRST
(the orderings that historically broke). Slow lane: the exhaustive sweep —
every single ``genjax_tpu.*`` module imported first in its own process.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Force CPU inside the probe: the probe sets jax.config itself, so it does
# not depend on the environment it inherits.
_PROBE = (
    "import jax; jax.config.update('jax_platforms', 'cpu'); "
    "import importlib; importlib.import_module({mod!r}); print('IMPORTED-OK')"
)


def _import_first(module: str) -> None:
    """Import ``module`` as the first genjax_tpu touch of a fresh process."""
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mod=module)],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=300,
    )
    assert proc.returncode == 0 and "IMPORTED-OK" in proc.stdout, (
        f"first `import {module}` in a fresh process failed:\n"
        f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr[-4000:]}"
    )


def _all_modules():
    """Every importable module under genjax_tpu/ (no pycache, no mains)."""
    pkg_root = os.path.join(REPO, "genjax_tpu")
    mods = []
    for root, dirs, files in os.walk(pkg_root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)
            parts = rel[: -len(".py")].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return mods


FACADES = [
    "genjax_tpu",
    "genjax_tpu.core",
    "genjax_tpu.generative",
    "genjax_tpu.lang",
    "genjax_tpu.dists",
    "genjax_tpu.combinators",
    "genjax_tpu.adev",
    "genjax_tpu.models",
    "genjax_tpu.kernels",
    "genjax_tpu.parallel",
    "genjax_tpu.inference",
    "genjax_tpu.debug",
    "genjax_tpu.io",
    # the round-3 cycle participants, imported first explicitly:
    "genjax_tpu.kernels.chees",
    "genjax_tpu.inference.smc_chees",
    "genjax_tpu.inference.adaptation",
    "genjax_tpu.parallel.mcmc",
]


@pytest.mark.parametrize("module", FACADES)
def test_first_import_fresh_process(module):
    _import_first(module)


@pytest.mark.slow
@pytest.mark.parametrize("module", _all_modules())
def test_first_import_every_module(module):
    _import_first(module)
