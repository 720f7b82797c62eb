"""Tensor parallelism: parameter-sharded column log-densities.

The reference has no counterpart (single-process throughout — SURVEY §2's
parallelism inventory finds no pjit/shard_map/collectives in
`/root/reference/src/genjax/`). This is the third mesh axis of the scale-out
story (`parallel/` docstring): after chains (`mesh.py`, data parallel) and
data (`data.py`, sharded likelihood sums), this module shards the
*parameter* axis of the position matrix itself, for posteriors whose
per-chain state is too large — or whose likelihood FLOPs are too
matmul-heavy — for one chip.

Mechanics, Megatron-style but for a log-density instead of a forward pass:
the column positions ``(D, N)`` live sharded ``P(model_axis, chain_axis)``;
each device computes a *partial* statistic from its parameter rows
(shard-local prior mass, its hidden units' contribution to the network
output), one ``psum`` over the model axis assembles the full statistic,
and a cheap replicated combine turns it into the per-chain log-density.
``jax.vjp`` through ``shard_map``/``psum`` gives the gradient with the
transposed collective, so the result drops straight into the column HMC /
NUTS / ChEES kernels (``kernels/hmc.py:401`` ``_reference_hmc`` is pure
elementwise jnp around the user log-density — every carry shards cleanly
over the same spec and XLA keeps the whole sweep partitioned).

The flagship workload is :func:`tp_bnn_logdensity`: a wide single-hidden-
layer Bayesian neural network whose hidden units are split across the
model axis. Its per-step collective is one ``(M+1, N_local)`` psum
(activations + prior partial, fused), independent of the width ``H`` — the
parameter state and the ``(H, D_in)``-by-``(D_in, M)`` matmuls scale per
shard while the wire traffic doesn't.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import shard_map_compat


def shard_params(q, mesh: Mesh, model_axis: str = "model",
                 chain_axis: str | None = "batch"):
    """Place column positions ``(D, N)`` with the parameter axis sharded
    over ``model_axis`` (and chains over ``chain_axis`` if given)."""
    return jax.device_put(q, NamedSharding(mesh, P(model_axis, chain_axis)))


def tensor_parallel_logdensity(
    shard_fn: Callable,
    combine_fn: Callable,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    chain_axis: str | None = "batch",
) -> Callable:
    """Build a column log-density ``(D, N) -> (N,)`` from a shard-local
    partial-statistics map and a replicated combine.

    ``logdensity(q) = combine_fn(psum_over_model(shard_fn(q_shard)))``

    Args:
        shard_fn: ``(D_local, N_local) -> pytree of partials``, each leaf
            with the chain axis last. Computed per model shard from that
            shard's parameter rows only; leaves are summed across the
            model axis with ONE fused ``psum``.
        combine_fn: ``pytree of summed partials -> (N_local,)``. Runs
            replicated on every model shard (keep it cheap — elementwise
            over chains).
        mesh: mesh containing ``model_axis`` (build with
            ``make_mesh_2d(shape, axes=(model_axis, chain_axis))``).

    The returned function is differentiable: ``jax.vjp`` transposes the
    ``psum`` into the shard-local gradients, so it plugs directly into
    ``pallas_hmc``, ``nuts_sweep_cols`` and ``chees_hmc``.
    ``D`` must be divisible by the model-axis size and ``N`` by the
    chain-axis size.
    """

    def _local(q_block):
        partials = shard_fn(q_block)
        summed = lax.psum(partials, model_axis)
        return combine_fn(summed)

    wrapped = shard_map_compat(
        _local,
        mesh=mesh,
        in_specs=(P(model_axis, chain_axis),),
        out_specs=P(chain_axis),
    )

    def logdensity_cols(q):
        return wrapped(q)

    return logdensity_cols


def bnn_param_count(d_in: int, hidden: int) -> int:
    """Total parameter rows of :func:`tp_bnn_logdensity`'s layout:
    ``hidden`` units × (``d_in`` input weights + 1 bias + 1 output
    weight)."""
    return hidden * (d_in + 2)


def tp_bnn_logdensity(
    X,
    y,
    hidden: int,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    chain_axis: str | None = "batch",
    obs_scale: float = 0.5,
    weight_scale: float = 1.0,
) -> Callable:
    """Column log-density of a wide single-hidden-layer Bayesian neural
    network, hidden units sharded over ``model_axis``.

    Model (per chain column):

        W1 ~ N(0, weight_scale²)  (hidden × d_in),  b1, w2 likewise
        f(x) = (1/√hidden) · Σ_j w2_j · tanh(W1_j · x + b1_j)
        y_m ~ N(f(x_m), obs_scale²)

    The ``1/√hidden`` output scaling keeps the prior-predictive variance
    width-independent (the NNGP parameterization), so widening the network
    across more chips doesn't change the observation model.

    Layout: position rows are grouped per hidden unit — unit ``j`` owns
    rows ``[j·(d_in+2), (j+1)·(d_in+2))`` = its input weights, bias, and
    output weight — so an even row split over ``model_axis`` is exactly an
    even split of hidden units. ``hidden`` must be divisible by the
    model-axis size. Use :func:`bnn_param_count` for ``D`` and
    :func:`shard_params` to place initial positions.

    Args:
        X: data matrix ``(M, d_in)`` (host numpy is fine; replicated).
        y: observations ``(M,)``.
        hidden: total hidden width across all shards.

    Returns:
        ``logdensity_cols (D, N) -> (N,)`` for the column kernels.
    """
    m_size = mesh.shape[model_axis]
    if hidden % m_size:
        raise ValueError(
            f"hidden={hidden} is not divisible by the '{model_axis}' mesh "
            f"size {m_size}"
        )
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    d_in = X.shape[1]
    out_scale = 1.0 / jnp.sqrt(jnp.float32(hidden))
    inv_w2 = 1.0 / (weight_scale * weight_scale)
    inv_o2 = 1.0 / (obs_scale * obs_scale)

    def shard_fn(q_block):
        h_local, n = q_block.shape[0] // (d_in + 2), q_block.shape[1]
        u = q_block.reshape(h_local, d_in + 2, n)
        w1 = u[:, :d_in, :]          # (H_l, d_in, N)
        b1 = u[:, d_in, :]           # (H_l, N)
        w2 = u[:, d_in + 1, :]       # (H_l, N)
        # one (H_l·N, d_in) @ (d_in, M) matmul — the matmul-bound op
        pre = (
            w1.transpose(0, 2, 1).reshape(h_local * n, d_in) @ X.T
        ).reshape(h_local, n, -1)
        act = jnp.tanh(pre + b1[:, :, None])           # (H_l, N, M)
        partial_out = jnp.einsum("hn,hnm->nm", w2, act)  # (N, M)
        prior_partial = -0.5 * inv_w2 * jnp.sum(
            q_block * q_block, axis=0, keepdims=True
        )  # (1, N)
        return {"out": partial_out, "prior": prior_partial}

    def combine_fn(summed):
        f = out_scale * summed["out"]                  # (N, M)
        resid = y[None, :] - f
        loglik = -0.5 * inv_o2 * jnp.sum(resid * resid, axis=1)  # (N,)
        return summed["prior"][0] + loglik

    return tensor_parallel_logdensity(
        shard_fn, combine_fn, mesh,
        model_axis=model_axis, chain_axis=chain_axis,
    )


def bnn_logdensity_reference(
    X, y, hidden: int, *, obs_scale: float = 0.5, weight_scale: float = 1.0,
) -> Callable:
    """Unsharded twin of :func:`tp_bnn_logdensity` (same layout and math,
    plain jnp) — the single-chip path, and the exactness oracle the sharded
    version is tested against."""
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    d_in = X.shape[1]
    out_scale = 1.0 / jnp.sqrt(jnp.float32(hidden))
    inv_w2 = 1.0 / (weight_scale * weight_scale)
    inv_o2 = 1.0 / (obs_scale * obs_scale)

    def logdensity_cols(q):
        n = q.shape[1]
        u = q.reshape(hidden, d_in + 2, n)
        w1, b1, w2 = u[:, :d_in, :], u[:, d_in, :], u[:, d_in + 1, :]
        pre = (
            w1.transpose(0, 2, 1).reshape(hidden * n, d_in) @ X.T
        ).reshape(hidden, n, -1)
        act = jnp.tanh(pre + b1[:, :, None])
        f = out_scale * jnp.einsum("hn,hnm->nm", w2, act)
        resid = y[None, :] - f
        loglik = -0.5 * inv_o2 * jnp.sum(resid * resid, axis=1)
        prior = -0.5 * inv_w2 * jnp.sum(q * q, axis=0)
        return prior + loglik

    return logdensity_cols
