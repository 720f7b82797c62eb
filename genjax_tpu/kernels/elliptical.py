"""Elliptical slice sampling (Murray, Adams & MacKay 2010) in the column
layout — the tuning-free exact sampler for latent-Gaussian models.

No reference counterpart (the reference's only gradient-free move is
prior-proposal `Regenerate` MH — `/root/reference/src/genjax/_src/core/
generative/requests.py:64` — which mixes arbitrarily slowly when the
likelihood is informative). ESS targets

    p(f) ∝ N(f; mu, Sigma) · L(f)

with NO step size, NO trajectory length, and acceptance probability 1:
each transition draws an auxiliary ellipse through the current state and a
prior sample, then shrinks an angle bracket until the likelihood threshold
is met. It is the standard production sampler for GP latents
(`models/gp.py` provides the Gram/Cholesky machinery).

Batching: positions are chains-on-lanes ``(D, N)``. All chains run the
shrink loop in ONE ``lax.while_loop`` with a per-chain done mask — finished
chains idle (their state is frozen by ``jnp.where``) until the slowest
chain accepts. The expected iteration count is small and dimension-free
(geometric with rate ≈ the slice fraction), so lock-step masking wastes
little; the loop body is a likelihood evaluation, which is where the FLOPs
are anyway.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import jax.random as jr
from jax import lax

_TWO_PI = 6.283185307179586


def _prior_draw(chol, z):
    """``chol @ z`` at full float32 precision: at the default precision a
    GPU may run it in TF32, which draws the ellipse from a perturbed
    prior."""
    return jnp.dot(chol, z, precision=lax.Precision.HIGHEST)


def ess_transition_cols(
    log_lik_cols: Callable,
    q,
    key,
    *,
    chol_prior,
    mean=0.0,
    max_iters: int = 64,
):
    """One elliptical-slice transition for every chain column.

    Args:
        log_lik_cols: ``(D, N) -> (N,)`` log-likelihood (NOT including the
            Gaussian prior — the prior is sampled exactly on the ellipse).
        q: ``(D, N)`` current positions.
        chol_prior: ``(D, D)`` lower Cholesky factor of the prior
            covariance (or a ``(D,)``/scalar standard deviation for a
            diagonal prior).
        mean: prior mean — scalar, ``(D,)``, or ``(D, 1)``.
        max_iters: hard cap on shrink iterations (a safety net — the
            shrink loop terminates with probability 1; at the cap the
            current point is kept, an exact no-op move).

    Returns ``(q_new, n_iters)`` with ``n_iters`` the ``(N,)`` per-chain
    shrink-iteration counts (diagnostic; 0 = first proposal accepted).
    """
    d, n = q.shape
    mean = jnp.asarray(mean, q.dtype)
    if mean.ndim == 1:
        mean = mean.reshape(-1, 1)
    mean = jnp.broadcast_to(mean, (d, 1))
    k_nu, k_u, k_theta = jr.split(key, 3)
    z = jr.normal(k_nu, (d, n), q.dtype)
    chol_prior = jnp.asarray(chol_prior, q.dtype)
    if chol_prior.ndim == 2:
        nu = _prior_draw(chol_prior, z)
    else:
        nu = chol_prior.reshape(-1, 1) * z if chol_prior.ndim == 1 else chol_prior * z

    log_y = log_lik_cols(q) + jnp.log(jr.uniform(k_u, (n,), q.dtype))
    theta0 = jr.uniform(k_theta, (n,), q.dtype) * _TWO_PI
    lo0, hi0 = theta0 - _TWO_PI, theta0

    centered = q - mean

    def proposal(theta):
        return mean + centered * jnp.cos(theta) + nu * jnp.sin(theta)

    q1 = proposal(theta0)
    done0 = log_lik_cols(q1) > log_y

    def cond(state):
        i, _, _, _, _, done, _counts = state
        return jnp.logical_and(i < max_iters, ~jnp.all(done))

    # The loop carries only (N,)-vectors — brackets, angles, flags — and
    # the ACCEPTED ANGLE per chain; the (D, N) accepted-position buffer is
    # reconstructed ONCE after the loop from theta_acc. Carrying the
    # position itself cost an extra read+write of the full state every
    # body execution (~2x the loop's HBM traffic; the lock-step loop runs
    # to the max iteration count over all N chains, so every byte in the
    # body is paid that many times).
    def body(state):
        i, theta_acc, lo, hi, theta, done, counts = state
        # shrink the bracket toward 0 on the rejected side
        lo = jnp.where(jnp.logical_or(done, theta >= 0), lo, theta)
        hi = jnp.where(jnp.logical_or(done, theta >= 0), theta, hi)
        k = jr.fold_in(k_theta, i + 1)
        theta_new = lo + (hi - lo) * jr.uniform(k, (n,), q.dtype)
        theta = jnp.where(done, theta, theta_new)
        ok = log_lik_cols(proposal(theta)) > log_y
        accept_now = jnp.logical_and(~done, ok)
        theta_acc = jnp.where(accept_now, theta, theta_acc)
        counts = counts + jnp.asarray(~done, counts.dtype)
        return (
            i + 1, theta_acc, lo, hi, theta,
            jnp.logical_or(done, ok), counts,
        )

    counts0 = jnp.zeros((n,), jnp.int32)
    _, theta_acc, _, _, _, done, n_iters = lax.while_loop(
        cond,
        body,
        (
            jnp.asarray(0),
            theta0,
            lo0,
            hi0,
            theta0,
            done0,
            counts0,
        ),
    )
    # chains that hit the cap keep their current point (exact no-op)
    q_new = jnp.where(done[None, :], proposal(theta_acc), q)
    return q_new, n_iters


def ess_sweep_cols(
    log_lik_cols: Callable,
    q0,
    seed: int,
    *,
    n_steps: int,
    chol_prior,
    mean=0.0,
    max_iters: int = 64,
    collect: bool = False,
    rng_impl: str | None = None,
):
    """``n_steps`` elliptical-slice transitions in one ``lax.scan``.
    Returns ``(q_final, draws)`` with ``draws`` of shape
    ``(n_steps, D, N)`` when ``collect`` else ``None``.

    ``rng_impl="rbg"`` switches the PRNG to RngBitGenerator for the bulk
    ``(D, N)`` ellipse draws that dominate the transition (same tradeoff
    as ``kernels.chees``; the threefry default keeps cross-impl
    reproducibility)."""
    q0 = jnp.asarray(q0, jnp.float32)
    root = (
        jr.key(seed ^ 0xE5517, impl=rng_impl)
        if rng_impl
        else jr.key(seed ^ 0xE5517)
    )

    def step(q, i):
        q, _ = ess_transition_cols(
            log_lik_cols,
            q,
            jr.fold_in(root, i),
            chol_prior=chol_prior,
            mean=mean,
            max_iters=max_iters,
        )
        return q, (q if collect else None)

    q, draws = lax.scan(step, q0, jnp.arange(n_steps))
    return q, draws


def ess_transition_gauss_cols(
    q,
    key,
    *,
    chol_prior,
    y,
    prec=1.0,
    mean=0.0,
    max_iters: int = 64,
):
    """One elliptical-slice transition specialized to a GAUSSIAN (more
    generally, diagonal-quadratic) log-likelihood

        ll(f) = -0.5 * sum_d prec_d * (f_d - y_d)^2   (+ const)

    — the canonical GP-regression case. Along the ellipse
    ``f(theta) = m + c cos(theta) + nu sin(theta)`` the log-likelihood is
    an explicit trigonometric quadratic,

        ll(theta) = -0.5 [ A cos^2 + B sin^2 + 2C cos sin
                           + 2D cos + 2E sin + F ],

    whose six coefficients are per-chain REDUCTIONS over dimensions,
    computed ONCE per transition. Every shrink iteration then evaluates
    ll(theta) from six (N,) vectors in O(N) — no (D, N) traffic at all —
    so the lock-step while_loop (which runs to the max shrink count over
    all N chains) costs essentially nothing and the transition is bound
    by the ellipse-draw matmul ``chol_prior @ z``. Identical Markov
    chain to :func:`ess_transition_cols` with the matching likelihood:
    the same randomness stream drives the same accept/shrink decisions
    (up to float roundoff in the likelihood evaluation).

    Args:
        y: ``(D,)`` or ``(D, 1)`` observations.
        prec: scalar or ``(D,)``/``(D, 1)`` observation precisions
            (1/sigma^2).

    Returns ``(q_new, n_iters)`` as :func:`ess_transition_cols`.
    """
    d, n = q.shape
    mean = jnp.asarray(mean, q.dtype)
    if mean.ndim == 1:
        mean = mean.reshape(-1, 1)
    mean = jnp.broadcast_to(mean, (d, 1))
    y = jnp.asarray(y, q.dtype).reshape(d, 1)
    prec = jnp.asarray(prec, q.dtype)
    if prec.ndim == 1:
        prec = prec.reshape(-1, 1)

    k_nu, k_u, k_theta = jr.split(key, 3)
    z = jr.normal(k_nu, (d, n), q.dtype)
    chol_prior = jnp.asarray(chol_prior, q.dtype)
    if chol_prior.ndim == 2:
        nu = _prior_draw(chol_prior, z)
    else:
        nu = (
            chol_prior.reshape(-1, 1) * z
            if chol_prior.ndim == 1
            else chol_prior * z
        )

    c = q - mean
    r0 = mean - y  # (D, 1): chain-independent residual of the prior mean
    # six trig-quadratic coefficients, one fused pass over the (D, N) state
    A = jnp.sum(prec * c * c, axis=0)
    B = jnp.sum(prec * nu * nu, axis=0)
    Cc = jnp.sum(prec * c * nu, axis=0)
    Dc = jnp.sum(prec * c * r0, axis=0)
    E = jnp.sum(prec * nu * r0, axis=0)
    F = jnp.sum(prec * r0 * r0)  # scalar

    def ll_theta(theta):
        ct, st = jnp.cos(theta), jnp.sin(theta)
        return -0.5 * (
            A * ct * ct
            + B * st * st
            + 2.0 * Cc * ct * st
            + 2.0 * Dc * ct
            + 2.0 * E * st
            + F
        )

    # ll at the current point is theta = 0: cos=1, sin=0
    log_y = -0.5 * (A + 2.0 * Dc + F) + jnp.log(
        jr.uniform(k_u, (n,), q.dtype)
    )
    theta0 = jr.uniform(k_theta, (n,), q.dtype) * _TWO_PI
    lo0, hi0 = theta0 - _TWO_PI, theta0
    done0 = ll_theta(theta0) > log_y

    def cond(state):
        i, _, _, _, _, done, _counts = state
        return jnp.logical_and(i < max_iters, ~jnp.all(done))

    def body(state):
        i, theta_acc, lo, hi, theta, done, counts = state
        lo = jnp.where(jnp.logical_or(done, theta >= 0), lo, theta)
        hi = jnp.where(jnp.logical_or(done, theta >= 0), theta, hi)
        k = jr.fold_in(k_theta, i + 1)
        theta_new = lo + (hi - lo) * jr.uniform(k, (n,), q.dtype)
        theta = jnp.where(done, theta, theta_new)
        ok = ll_theta(theta) > log_y
        accept_now = jnp.logical_and(~done, ok)
        theta_acc = jnp.where(accept_now, theta, theta_acc)
        counts = counts + jnp.asarray(~done, counts.dtype)
        return (
            i + 1, theta_acc, lo, hi, theta,
            jnp.logical_or(done, ok), counts,
        )

    counts0 = jnp.zeros((n,), jnp.int32)
    _, theta_acc, _, _, _, done, n_iters = lax.while_loop(
        cond,
        body,
        (jnp.asarray(0), theta0, lo0, hi0, theta0, done0, counts0),
    )
    q_new = mean + c * jnp.cos(theta_acc) + nu * jnp.sin(theta_acc)
    q_new = jnp.where(done[None, :], q_new, q)
    return q_new, n_iters


def ess_sweep_gauss_cols(
    q0,
    seed: int,
    *,
    n_steps: int,
    chol_prior,
    y,
    prec=1.0,
    mean=0.0,
    max_iters: int = 64,
    collect: bool = False,
    rng_impl: str | None = None,
):
    """``n_steps`` Gaussian-likelihood ESS transitions in one ``lax.scan``
    (the fast path of :func:`ess_sweep_cols`; same key discipline, so the
    two produce the same chains for the matching likelihood — with the
    default PRNG; ``rng_impl="rbg"`` trades that reproducibility for
    RngBitGenerator bulk draws)."""
    q0 = jnp.asarray(q0, jnp.float32)
    root = (
        jr.key(seed ^ 0xE5517, impl=rng_impl)
        if rng_impl
        else jr.key(seed ^ 0xE5517)
    )

    def step(q, i):
        q, _ = ess_transition_gauss_cols(
            q,
            jr.fold_in(root, i),
            chol_prior=chol_prior,
            y=y,
            prec=prec,
            mean=mean,
            max_iters=max_iters,
        )
        return q, (q if collect else None)

    q, draws = lax.scan(step, q0, jnp.arange(n_steps))
    return q, draws
