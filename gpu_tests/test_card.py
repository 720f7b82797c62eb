"""The card lane: ``chip_smoke.py``'s phases at full size, as tests.

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m pytest gpu_tests -m gpu -p no:cacheprovider

This directory is outside ``tests/``, whose ``conftest.py`` pins the whole
process to the CPU. Without a GPU every test here skips.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from chip_env import NoGPUError, require_gpu  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        return require_gpu()
    except NoGPUError as e:
        pytest.skip(f"needs an NVIDIA GPU: {e}")


@pytest.fixture
def four_gpus(gpu):
    import jax

    if len(jax.devices()) != 4:
        pytest.skip(f"needs 4 GPUs, JAX sees {len(jax.devices())}")


@pytest.mark.parametrize(
    "phase", [fn for name, fn in cs.ONE_CARD], ids=[n for n, _ in cs.ONE_CARD]
)
def test_one_card_phase(gpu, phase):
    checks = phase(cs.FULL)
    assert not cs.failed(checks), [c.line() for c in checks]


@pytest.mark.parametrize(
    "phase", [fn for name, fn in cs.FOUR_CARDS[1:]],
    ids=[n for n, _ in cs.FOUR_CARDS[1:]],
)
def test_four_card_phase(four_gpus, phase):
    checks = phase(cs.FULL)
    assert not cs.failed(checks), [c.line() for c in checks]
