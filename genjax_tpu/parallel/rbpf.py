"""Rao-Blackwellized particle filter (mixture Kalman filter).

No reference counterpart (its SMC layer has no conditionally-linear
structure exploitation — `/root/reference/src/genjax/_src/inference/
smc.py`). For conditionally linear-Gaussian models

    u_t ~ f(u_t | u_{t-1})                       (nonlinear regime/state)
    z_t = A(u_t) z_{t-1} + w_t,  w_t ~ N(0, Q(u_t))
    y_t = C(u_t) z_t + v_t,      v_t ~ N(0, R(u_t))

each particle samples only ``u`` and carries the EXACT Gaussian filter
``(mean_t, cov_t)`` of ``z | u_{1:t}, y_{1:t}`` — the classic
Doucet–de Freitas–Murphy–Russell 2000 construction. Particle weights are
the exact one-step predictive densities from the per-particle Kalman
update, so the logZ estimator's variance collapses relative to jointly
sampling ``(u, z)`` (Rao-Blackwellization), and the latent dimension the
particles explore shrinks to dim(u).

Structure: the per-particle Kalman predict/update is dense (Dz, Dz)
matmuls vmapped over particles — batched matmuls; the whole filter is one
``lax.scan`` with the framework's counts-based systematic resampling.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..dists.lgssm import kalman_update
from .resampling import effective_sample_size, resample_particles


@Pytree.dataclass
class RBPFResult(Pytree):
    """Final regime particles, their per-particle Gaussian filters
    ``(means, covs)`` over the linear substate, normalized log weights,
    the exact-marginalized logZ estimate, and the ESS trace."""

    regimes: Any
    means: Any
    covs: Any
    log_weights: Any
    log_marginal: Any
    ess_history: Any


def rbpf(
    key: PRNGKey,
    sample_regime: Callable,
    matrices: Callable,
    ys,
    *,
    n_particles: int,
    init_regime: Any,
    mu0,
    P0,
    ess_threshold: float = 0.5,
    method: str = "systematic",
) -> RBPFResult:
    """Run the Rao-Blackwellized filter.

    Args:
        sample_regime: ``(key, u_prev, t) -> u`` — one prior draw of the
            nonlinear state (pure jnp; vmapped over particles).
        matrices: ``u -> (A, Q, C, R)`` — the conditionally-linear system
            for regime ``u`` (shapes ``(Dz,Dz), (Dz,Dz), (Dy,Dz),
            (Dy,Dy)``).
        ys: observations ``(T, Dy)``.
        init_regime: initial ``u_0`` pytree (broadcast per particle;
            ``sample_regime`` is first called with it at t=0).
        mu0 / P0: prior mean/covariance of ``z_0``  — the first
            observation is of ``z_1 = A(u_1) z_0 + w``.
        ess_threshold: adaptive-resampling trigger (fraction of K).
    """
    k = n_particles
    ys = jnp.asarray(ys)
    mu0 = jnp.asarray(mu0, jnp.float32)
    P0 = jnp.asarray(P0, jnp.float32)

    def broadcast(c):
        return jtu.tree_map(
            lambda v: jnp.broadcast_to(jnp.asarray(v), (k,) + jnp.shape(v)), c
        )

    def particle_step(pkey, u_prev, mean, cov, t, y):
        u = sample_regime(pkey, u_prev, t)
        A, Q, C, R = matrices(u)
        # Kalman predict through the regime's dynamics, then update on y:
        # the weight is the EXACT predictive density p(y_t | u_{1:t}, y_<t)
        mean_pred = A @ mean
        cov_pred = A @ cov @ A.T + Q
        mean_f, cov_f, ll = kalman_update(mean_pred, cov_pred, C, R, y)
        return u, mean_f, cov_f, ll

    def step(state, inp):
        us, means, covs, log_w, log_z = state
        t, y = inp
        extend_key, resample_key = jr.split(jr.fold_in(key, t))
        us, means, covs, lls = jax.vmap(
            lambda pk, u, m, c: particle_step(pk, u, m, c, t, y)
        )(jr.split(extend_key, k), us, means, covs)
        log_w = log_w + lls
        ess = effective_sample_size(log_w)

        def do_resample(args):
            us, means, covs, log_w, log_z = args
            inc = logsumexp(log_w) - jnp.log(k)
            us, means, covs = resample_particles(
                resample_key, (us, means, covs), log_w, k, method
            )
            return us, means, covs, jnp.zeros((k,)), log_z + inc

        us, means, covs, log_w, log_z = lax.cond(
            ess < ess_threshold * k,
            do_resample,
            lambda a: a,
            (us, means, covs, log_w, log_z),
        )
        return (us, means, covs, log_w, log_z), ess

    dz = mu0.shape[0]
    init = (
        broadcast(init_regime),
        jnp.broadcast_to(mu0, (k, dz)),
        jnp.broadcast_to(P0, (k, dz, dz)),
        jnp.zeros((k,)),
        jnp.asarray(0.0),
    )
    T = ys.shape[0]
    (us, means, covs, log_w, log_z), ess_hist = lax.scan(
        step, init, (jnp.arange(T), ys)
    )
    log_marginal = log_z + logsumexp(log_w) - jnp.log(k)
    return RBPFResult(
        regimes=us,
        means=means,
        covs=covs,
        log_weights=log_w - logsumexp(log_w),
        log_marginal=log_marginal,
        ess_history=ess_hist,
    )
