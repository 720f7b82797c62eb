"""Column-layout inference kernels for the hot paths.

No reference counterpart (the reference drives moves one trace at a time).
Every kernel here takes a batched log-density over a ``(D, N)`` block of
chains (chains on the last axis) and runs a whole sweep — HMC, NUTS,
ChEES, parallel tempering, elliptical slice, SVGD, SG-MCMC — as one
``lax.scan`` that XLA compiles into a single program.
"""

from .adaptation import (
    StepSizeAdaptState,
    cross_chain_inv_mass,
    dual_averaging_update,
    multiplicative_nudge,
    windowed_warmup,
)
from .chees import ChEESInfo, chees_hmc
from .dense_mass import (
    cross_chain_cov,
    hmc_sweep_dense_cols,
    warmup_column_dense,
    whiten_logdensity,
)
from .elliptical import ess_sweep_cols, ess_sweep_gauss_cols, ess_transition_cols, ess_transition_gauss_cols
from .hmc import pallas_hmc, warmup_column
from .model_interface import ColumnPacker, column_chees, column_hmc, column_logdensity, column_nuts, column_pt, column_svgd
from .pt import PTInfo, geometric_ladder, pt_hmc
from .nuts import nuts_sweep_cols, nuts_transition
from .svgd import rbf_kernel_and_grad, svgd
from .sgld import (
    full_grad_cols,
    minibatch_grad_cols,
    sghmc_sweep_cols,
    sgld_sweep_cols,
)

__all__ = ["StepSizeAdaptState", "cross_chain_inv_mass", "dual_averaging_update", "multiplicative_nudge", "windowed_warmup", "ChEESInfo", "chees_hmc", "cross_chain_cov", "hmc_sweep_dense_cols", "warmup_column_dense", "whiten_logdensity", "ColumnPacker", "column_chees", "column_hmc", "column_logdensity", "column_nuts", "column_pt", "column_svgd", "PTInfo", "ess_sweep_cols", "ess_sweep_gauss_cols", "ess_transition_cols", "ess_transition_gauss_cols", "full_grad_cols", "geometric_ladder", "minibatch_grad_cols", "pt_hmc", "nuts_sweep_cols", "nuts_transition", "pallas_hmc", "rbf_kernel_and_grad", "sghmc_sweep_cols", "sgld_sweep_cols", "svgd", "warmup_column"]
