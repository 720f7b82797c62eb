"""Scale-out runtime: device meshes, sharded particle/chain batches,
collective resampling, multi-chip SMC and MCMC drivers.

This layer has **no reference counterpart** — the reference is single-process
``jax.vmap`` only (SURVEY.md §2 parallelism inventory: no pmap/pjit/
shard_map/collectives anywhere in its source). It is the accelerator-scale
execution story required by BASELINE.json's north star: chains/particles
sharded over a mesh with XLA collectives for log-weight normalization,
systematic resampling, and cross-chain adaptation.
"""

from .data import (
    data_sharded_logdensity,
    make_mesh_2d,
    minibatch_logdensity,
    shard_data,
)
from .audit import hlo_collectives
from .islands import IslandFilterResult, IslandParticleFilter
from .mesh import (
    host_local_mesh,
    initialize_distributed,
    make_hier_mesh,
    make_mesh,
    shard_batch,
    shard_map_compat,
)
from .mcmc import run_chains_sharded, warmup_adapt_step_size
from .resampling import (
    collective_resample,
    collective_weight_stats,
    effective_sample_size,
    multinomial_indices,
    redistribute,
    resample_particles,
    residual_indices,
    stratified_counts,
    stratified_indices,
    systematic_counts,
    systematic_indices,
)
from .rbpf import RBPFResult, rbpf
from .smc import SSMParticleFilter, sharded_importance
from .tensor_parallel import (
    bnn_logdensity_reference,
    bnn_param_count,
    shard_params,
    tensor_parallel_logdensity,
    tp_bnn_logdensity,
)

__all__ = [
    "IslandFilterResult",
    "IslandParticleFilter",
    "SSMParticleFilter",
    "hlo_collectives",
    "make_hier_mesh",
    "bnn_logdensity_reference",
    "bnn_param_count",
    "shard_params",
    "tensor_parallel_logdensity",
    "tp_bnn_logdensity",
    "collective_resample",
    "collective_weight_stats",
    "data_sharded_logdensity",
    "effective_sample_size",
    "host_local_mesh",
    "initialize_distributed",
    "make_mesh",
    "make_mesh_2d",
    "minibatch_logdensity",
    "multinomial_indices",
    "RBPFResult",
    "rbpf",
    "redistribute",
    "resample_particles",
    "residual_indices",
    "run_chains_sharded",
    "shard_batch",
    "shard_map_compat",
    "shard_data",
    "sharded_importance",
    "stratified_indices",
    "systematic_counts",
    "systematic_indices",
    "stratified_counts",
    "warmup_adapt_step_size",
]
