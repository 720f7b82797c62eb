"""Data-axis sharding: big-data log-densities over a 2-D (chains × data)
mesh.

The reference has no counterpart (single-process throughout —
`/root/reference/src/genjax/` has no pjit/shard_map/collectives; SURVEY §2 notes the
tensor-parallel equivalent for a PPL is "sharded-array log-density where
models are large"). A factorized posterior

    log p(q | x_1..M) = log p(q) + Σ_i log p(x_i | q)        (+ const)

has its FLOPs in the likelihood sum, which is embarrassingly parallel over
data. This module keeps the dataset resident shard-by-shard across a mesh
axis and evaluates the sum with one ``lax.psum`` — no device ever
materializes the full dataset, and the gradient (``jax.vjp`` through
``shard_map``/``psum``) is likewise computed shard-locally.

The result is a standard column log-density ``(D, N) -> (N,)`` — it drops
straight into ``pallas_hmc`` / ``nuts_sweep_cols`` / ``chees_hmc``
(``kernels/``), whose only contract is that ``jax.vjp`` works.

Layout: the mesh is ``(chain_axis, data_axis)``. Positions ``(D, N)`` shard
chains over ``chain_axis`` (the last axis — the framework's chains-last
layout) and are replicated over ``data_axis``; data leaves shard their
leading axis over ``data_axis`` and are replicated over ``chain_axis``.
Every device holds an (all-D × N/c) position block and an (M/d × ...)
data block.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.tree_util as jtu
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


def make_mesh_2d(
    shape: tuple[int, int] | None = None,
    axes: tuple[str, str] = ("batch", "data"),
    devices=None,
) -> Mesh:
    """A 2-D mesh ``axes=(chain_axis, data_axis)``. Default shape puts every
    device on the data axis (1, n_devices) — chains replicated, data fully
    spread — which is the right default when the dataset, not the chain
    count, is what exceeds one chip."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (1, len(devices))
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices but only "
            f"{len(devices)} are available"
        )
    devices = devices[:n]  # a smaller mesh deliberately uses a subset
    return Mesh(np.asarray(devices).reshape(shape), axes)


def shard_data(tree: Any, mesh: Mesh, data_axis: str = "data") -> Any:
    """Place ``tree`` with each leaf's leading axis sharded over
    ``data_axis`` (replicated over every other mesh axis)."""
    sharding = NamedSharding(mesh, P(data_axis))

    def place(leaf):
        return jax.device_put(leaf, sharding)

    return jtu.tree_map(place, tree)


def data_sharded_logdensity(
    log_prior: Callable,
    log_lik: Callable,
    data: Any,
    mesh: Mesh,
    *,
    chain_axis: str | None = "batch",
    data_axis: str = "data",
) -> Callable:
    """Build a column log-density ``(D, N) -> (N,)`` whose likelihood term
    is evaluated shard-locally and ``psum``-reduced over ``data_axis``.

    Args:
        log_prior: columns function ``(D, N) -> (N,)`` — e.g.
            ``column_logdensity(prior_model, ChoiceMap.empty(), args,
            packer)`` (kernels/model_interface.py), or any jnp function.
            Evaluated once per chain (outside the data reduction).
        log_lik: ``(q_block (D, N_local), data_shard) -> (N_local,)`` — the
            summed log-likelihood of one data shard for each chain column.
            Must be pure jnp (runs inside ``shard_map``).
        data: pytree whose leaves have the data dimension leading; every
            leaf's leading size must be divisible by the ``data_axis`` mesh
            size (pad with zero-weight rows otherwise — e.g. carry an
            explicit weight column and pad it with zeros).
        mesh: a mesh containing ``data_axis`` (and ``chain_axis`` if given —
            use :func:`make_mesh_2d`).
        chain_axis: mesh axis the chain (lanes) dimension of ``q`` shards
            over, or ``None`` to replicate chains.

    The returned function requires ``N`` divisible by the ``chain_axis``
    mesh size and is differentiable (one backward ``psum`` per ``vjp``).
    """
    d_size = mesh.shape[data_axis]
    for leaf in jtu.tree_leaves(data):
        if leaf.shape[0] % d_size:
            raise ValueError(
                f"data leading axis {leaf.shape[0]} is not divisible by the "
                f"'{data_axis}' mesh size {d_size}; pad the dataset (with "
                "zero-weight rows) to a multiple"
            )

    q_spec = P(None, chain_axis)
    data_specs = jtu.tree_map(lambda _: P(data_axis), data)
    out_spec = P(chain_axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(q_spec, data_specs),
        out_specs=out_spec,
    )
    def _lik_sum(q_block, shard):
        return lax.psum(log_lik(q_block, shard), data_axis)

    def logdensity_cols(q):
        return log_prior(q) + _lik_sum(q, data)

    return logdensity_cols


def minibatch_logdensity(
    log_prior: Callable,
    log_lik: Callable,
    data: Any,
    n_total: int,
    *,
    scale: bool = True,
) -> Callable:
    """Unsharded companion: a stochastic-gradient surrogate log-density from
    one minibatch, the likelihood scaled by ``n_total / batch`` so its
    gradient is an unbiased estimate of the full-data gradient (SGLD/SGHMC
    style). Useful for single-chip runs on datasets that fit but are slow;
    for exact sharded evaluation use :func:`data_sharded_logdensity`."""
    batch = jtu.tree_leaves(data)[0].shape[0]
    factor = (n_total / batch) if scale else 1.0

    def logdensity_cols(q):
        return log_prior(q) + factor * log_lik(q, data)

    return logdensity_cols
