"""Dense mass-matrix HMC in the column layout.

No reference counterpart (the reference ships constant-``eps`` HMC with
an implicit identity mass, `/root/reference/src/genjax/_src/inference/
requests/hmc.py:139-154`; this framework's other kernels adapt a
DIAGONAL inverse mass, ``kernels/adaptation.py cross_chain_inv_mass``).
A diagonal metric cannot precondition correlated posteriors: with
correlation ρ between dimensions, the integrator step size is capped by
the smallest conditional scale ~sqrt(1-ρ²), and at ρ = 0.99 diagonal
HMC needs ~7x smaller steps than a dense metric.

The massive-chain regime makes the dense metric nearly free:

* **Estimation** — with thousands of parallel chains, ONE cross-chain
  time slice gives a full-rank sample covariance (no within-chain
  windowing, no autocorrelation correction): ``cross_chain_cov`` is a
  single ``(D, N) @ (N, D)`` matmul plus diagonal shrinkage.
* **Application** — the ideal kinetic energy uses M = Σ⁻¹ (posterior
  precision), so each leapfrog needs ``Σ @ p`` and each momentum
  refresh ``L⁻ᵀ z`` (Σ = L Lᵀ). Both are ``(D, D) @ (D, N)`` matmuls —
  matmul-bound at any chain count, amortized over the N lanes.

Conventions: ``cov_chol`` is the lower Cholesky factor L of the
ESTIMATED POSTERIOR COVARIANCE Σ. Momenta are drawn p ~ N(0, Σ⁻¹) via
``p = L⁻ᵀ z`` (cov = L⁻ᵀ L⁻¹ = Σ⁻¹), kinetic energy is ½ pᵀ Σ p, and
the position update is ``q += eps · Σ p`` — so a perfectly estimated Σ
turns the target locally into an isotropic standard normal.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax


def cross_chain_cov(q, *, shrinkage: float = 0.1, jitter: float = 1e-6):
    """Full posterior-covariance estimate from the cross-chain spread.

    ``q`` is the ``(D, N)`` position batch; the estimate is the sample
    covariance over the N chains, shrunk toward its own diagonal:

        Σ̂ = (1 - shrinkage) · S + shrinkage · diag(S) + jitter · I

    Shrinkage keeps the estimate well-conditioned early in warmup (and
    under N ≲ D it is what makes the Cholesky exist at all); the
    diagonal target preserves per-dimension scales exactly.
    """
    d, n = q.shape
    mu = jnp.mean(q, axis=1, keepdims=True)
    c = q - mu
    s = (c @ c.T) / jnp.maximum(n - 1, 1)
    diag = jnp.diag(jnp.diag(s))
    return (1.0 - shrinkage) * s + shrinkage * diag + jitter * jnp.eye(d)


def hmc_sweep_dense_cols(
    logdensity_cols: Callable,
    q0,
    seed,
    *,
    n_steps: int,
    eps: float,
    L: int,
    cov_chol,
    rng_impl: str = "rbg",
    collect: bool = False,
):
    """``n_steps`` MH-adjusted HMC transitions with a DENSE metric.

    Args:
        logdensity_cols: batched log-density ``(D, N) -> (N,)``.
        q0: positions ``(D, N)`` float32.
        cov_chol: ``(D, D)`` lower Cholesky of the estimated posterior
            covariance Σ (e.g. ``jnp.linalg.cholesky(cross_chain_cov(q))``).
        seed: int seed or PRNG key array.
        collect: also return every transition's positions
            ``(n_steps, D, N)`` (for the ``sample_posterior`` driver).

    Returns ``(q, accept_rate)`` — or ``(q, accept_rate, draws)`` with
    ``collect`` — cost per transition is L+2 (D, D)x(D, N) matmuls on top
    of the L gradient evaluations.
    """
    d, n = q0.shape
    q0 = q0.astype(jnp.float32)
    cov_chol = jnp.asarray(cov_chol, jnp.float32)
    sigma = cov_chol @ cov_chol.T
    # momentum factor: p = Lm @ z with Lm = L^{-T}  =>  cov(p) = Σ^{-1}.
    # Materialized once per sweep (one D x D triangular solve) so every
    # refresh is a plain matmul instead of a per-step solve.
    mom_factor = jax.scipy.linalg.solve_triangular(
        cov_chol.T, jnp.eye(d, dtype=jnp.float32), lower=False
    )

    def lp_g(q):
        lp, pullback = jax.vjp(logdensity_cols, q)
        (g,) = pullback(jnp.ones_like(lp))
        return lp, g

    def kinetic(p):
        # ½ pᵀ Σ p per chain: one matmul + a fused reduce
        return 0.5 * jnp.sum(p * (sigma @ p), axis=0)

    def mh_step(carry, key):
        q, lp, g, acc = carry
        kp, ku = jr.split(key)
        p = mom_factor @ jr.normal(kp, (d, n))
        ke0 = kinetic(p)

        def leap(_, c):
            q, p, g, lp = c
            p = p + (eps / 2.0) * g
            q = q + eps * (sigma @ p)
            lp, g = lp_g(q)
            p = p + (eps / 2.0) * g
            return (q, p, g, lp)

        q_new, p_new, g_new, lp_new = lax.fori_loop(
            0, L, leap, (q, p, g, lp)
        )
        log_alpha = (lp_new - kinetic(p_new)) - (lp - ke0)
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = jnp.log(jr.uniform(ku, (n,))) < log_alpha
        q = jnp.where(accept[None, :], q_new, q)
        lp = jnp.where(accept, lp_new, lp)
        g = jnp.where(accept[None, :], g_new, g)
        out = q if collect else None
        return (q, lp, g, acc + jnp.mean(accept.astype(jnp.float32))), out

    if hasattr(seed, "dtype") and jnp.issubdtype(
        jnp.asarray(seed).dtype, jax.dtypes.prng_key
    ):
        root = seed
    else:
        root = jr.key(seed, impl=rng_impl)
    keys = jr.split(root, n_steps)
    lp0, g0 = lp_g(q0)
    (q, _, _, acc), draws = lax.scan(mh_step, (q0, lp0, g0, 0.0), keys)
    if collect:
        return q, acc / n_steps, draws
    return q, acc / n_steps


def warmup_column_dense(
    logdensity_cols: Callable,
    q0,
    seed: int,
    *,
    n_phases: int = 6,
    steps_per_phase: int = 25,
    eps0: float = 0.1,
    L: int = 5,
    target_accept: float = 0.8,
    shrinkage: float = 0.1,
    rng_impl: str = "rbg",
):
    """Windowed warmup for dense-metric HMC: per phase, sweep at the
    current metric, nudge the step size toward ``target_accept``
    (``kernels.adaptation.multiplicative_nudge``), and re-estimate the
    FULL covariance from the cross-chain spread (Cholesky taken in-jit —
    D x D, trivial next to the sweep). The shrinkage anneals linearly to
    its final value so early ill-conditioned estimates cannot derail the
    integrator. One ``lax.scan`` — a single dispatch and host sync.

    ``seed`` is an int (a dedicated warmup stream is derived from it) or
    a PRNG key array used as the stream root directly — pass a key when
    the caller's own key should drive warmup randomness (the
    ``sample_posterior`` driver does).

    Returns ``(q, eps, cov_chol)`` ready for
    :func:`hmc_sweep_dense_cols`.
    """
    from .adaptation import multiplicative_nudge, rescale_for_metric

    d, _ = q0.shape
    q0 = q0.astype(jnp.float32)
    if hasattr(seed, "dtype") and jnp.issubdtype(
        jnp.asarray(seed).dtype, jax.dtypes.prng_key
    ):
        root = seed
    else:
        root = jr.key((seed + 1) * 1_000_003, impl=rng_impl)

    def phase(carry, idx):
        q, eps, cov_chol = carry
        q, acc = hmc_sweep_dense_cols(
            logdensity_cols, q,
            jr.fold_in(root, idx),
            n_steps=steps_per_phase, eps=eps, L=L, cov_chol=cov_chol,
        )
        eps = multiplicative_nudge(eps, acc, target_accept=target_accept)
        # anneal shrinkage: heavy early (estimates from an unconverged
        # cloud), final value by the last phase
        lam = shrinkage + (1.0 - shrinkage) * (
            1.0 - (idx + 1.0) / n_phases
        )
        cov = cross_chain_cov(q, shrinkage=lam)
        # carry eps across a large change of the metric's scale
        eps = rescale_for_metric(
            eps, jnp.sum(cov_chol**2, axis=1), jnp.diag(cov)
        )
        cov_chol = jnp.linalg.cholesky(cov)
        return (q, eps, cov_chol), acc

    init = (
        q0,
        jnp.asarray(eps0, jnp.float32),
        jnp.eye(d, dtype=jnp.float32),
    )
    (q, eps, cov_chol), _accs = jax.jit(
        lambda init: lax.scan(phase, init, jnp.arange(n_phases))
    )(init)
    return q, eps, cov_chol


def whiten_logdensity(logdensity_cols: Callable, cov_chol, mean=0.0):
    """Give ANY column kernel a dense metric by reparameterization.

    With Σ = L Lᵀ the estimated posterior covariance, sampling
    ``u = L⁻¹ (q - m)`` from ``white_ld(u) = logdensity(m + L u)`` is
    exactly equivalent to running the chain with kinetic energy
    ½ pᵀ Σ p (the constant Jacobian |L| shifts the log-density by a
    constant, which MCMC ignores) — but it works with the IDENTITY
    metric, so NUTS (whose U-turn criterion has no dense-metric form
    here), ChEES, parallel tempering, and column HMC all gain
    full-covariance preconditioning unchanged.

    Returns ``(white_ld, whiten, unwhiten)``:
        white_ld:  ``(D, N) -> (N,)`` the whitened log-density;
        whiten:    ``q -> u`` (map positions into the white space);
        unwhiten:  ``u -> q`` (map draws back).

    >>> import jax.numpy as jnp
    >>> from genjax_tpu.kernels import whiten_logdensity
    >>> chol = jnp.asarray([[1.0, 0.0], [0.9, 0.435890]])  # rho ~ 0.9
    >>> ld = lambda q: -0.5 * jnp.sum(q * q, axis=0)
    >>> white_ld, whiten, unwhiten = whiten_logdensity(ld, chol)
    >>> q = jnp.asarray([[1.0], [0.5]])
    >>> bool(jnp.allclose(unwhiten(whiten(q)), q, atol=1e-6))
    True
    """
    cov_chol = jnp.asarray(cov_chol, jnp.float32)
    d = cov_chol.shape[0]
    mean_col = (
        jnp.asarray(mean, jnp.float32).reshape(-1, 1)
        if jnp.ndim(mean) > 0
        else jnp.full((d, 1), mean, jnp.float32)
    )

    def white_ld(u):
        return logdensity_cols(mean_col + cov_chol @ u)

    def whiten(q):
        return jax.scipy.linalg.solve_triangular(
            cov_chol, q - mean_col, lower=True
        )

    def unwhiten(u):
        return mean_col + cov_chol @ u

    return white_ld, whiten, unwhiten
