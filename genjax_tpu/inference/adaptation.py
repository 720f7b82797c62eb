"""Re-export shim: the unified MCMC warmup adaptation estimators.

The implementation lives in ``genjax_tpu.kernels.adaptation`` — a leaf
module below both ``kernels/`` and ``inference/`` — so that every consumer
imports strictly downward (round-3 verdict item 1: the old
``inference/adaptation.py`` home let ``kernels.chees`` import *up* into
``inference``, which combined with ``inference.smc_chees`` importing
``kernels.chees`` to break the very first ``import genjax_tpu``). This shim
keeps the established public path ``genjax_tpu.inference.adaptation``
stable.
"""

from ..kernels.adaptation import (
    StepSizeAdaptState,
    adapt_window,
    cross_chain_inv_mass,
    dual_averaging_update,
    multiplicative_nudge,
    rescale_for_metric,
    windowed_warmup,
)

__all__ = [
    "StepSizeAdaptState",
    "adapt_window",
    "cross_chain_inv_mass",
    "dual_averaging_update",
    "multiplicative_nudge",
    "rescale_for_metric",
    "windowed_warmup",
]
