"""Column-layout HMC sweep in plain JAX.

Layout: positions are stored **column-major over chains** — shape ``(D,
N)`` with chains on the last axis — so every per-chain scalar
(log-density, accept test) is a row vector over chains. ``D`` is padded
by ``ColumnPacker`` to a multiple of 8.

The log-density is supplied as a *batched column function*
``logdensity_cols(q: (D, N)) -> (N,)`` in plain jnp; one ``jax.vjp`` per
evaluation yields the per-chain log-density and its gradient together.
The whole sweep (momentum refresh → L leapfrogs → MH accept, ×n_steps)
is one ``lax.scan``, so XLA compiles it into a single program.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def pallas_hmc(
    logdensity_cols: Callable,
    q0,
    seed: int,
    *,
    n_steps: int,
    eps: float,
    L: int,
    inv_mass=None,
):
    """Run ``n_steps`` of MH-adjusted HMC on ``N`` column-layout chains.

    The historical name is kept for API stability; the sweep is the
    plain-JAX ``lax.scan`` of :func:`_reference_hmc`, which XLA compiles
    for whichever device JAX runs on.

    Args:
        logdensity_cols: batched log-density ``(D, N) -> (N,)`` in jnp.
        q0: initial positions, shape ``(D, N)`` float32.
        seed: int32 PRNG seed.
        inv_mass: optional per-dimension inverse mass, ``(D,)`` or
            ``(D, 1)``.

    Returns:
        ``(q_final, accept_rate)`` — positions ``(D, N)`` and the mean
        acceptance rate over chains and steps.
    """
    return _reference_hmc(
        logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, L=L,
        inv_mass=inv_mass,
    )


def _reference_hmc(
    logdensity_cols, q0, seed, *, n_steps, eps, L, inv_mass=None,
    rng_impl: str = "rbg",
):
    """The column HMC sweep: one ``lax.scan`` of MH-adjusted transitions.

    ``inv_mass``: optional per-dimension inverse mass (≈ posterior variance
    estimate, shape (D,) or (D, 1)). Momenta draw from N(0, M); the drift
    is ``eps * M⁻¹ r``; kinetic energy ``½ rᵀ M⁻¹ r``.

    ``rng_impl``: PRNG implementation for the per-step bulk ``(D, N)``
    momentum draws. The default ``"rbg"`` lowers to XLA's
    RngBitGenerator; pass ``"threefry2x32"`` for the JAX default stream.
    """
    import jax.random as jr

    d, n = q0.shape
    if inv_mass is None:
        inv_mass = jnp.ones((d, 1), jnp.float32)
    else:
        inv_mass = jnp.reshape(jnp.asarray(inv_mass, jnp.float32), (d, 1))
    mom_std = 1.0 / jnp.sqrt(inv_mass)
    # One vjp per evaluation yields the per-chain log-density primal AND
    # its gradient in a single forward+backward pass; carrying (lp, grad)
    # across MH steps then makes a sweep cost exactly L evaluations per
    # step — the standalone lp0/lp1 passes of the textbook formulation
    # fold away (the cotangent is all-ones because chains are independent:
    # column j of the gradient is d lp[j] / d q[:, j])
    def lp_g(q):
        lp, pullback = jax.vjp(logdensity_cols, q)
        (g,) = pullback(jnp.ones_like(lp))
        return lp, g

    def kinetic(p):
        return 0.5 * jnp.sum(inv_mass * p * p, axis=0)

    def mh_step(carry, key):
        q, lp, g, acc = carry
        kp, ku = jr.split(key)
        p = mom_std * jr.normal(kp, (d, n))
        ke0 = kinetic(p)

        def leap(_, c):
            q, p, g, lp = c
            p = p + (eps / 2.0) * g
            q = q + eps * inv_mass * p
            lp, g = lp_g(q)
            p = p + (eps / 2.0) * g
            return (q, p, g, lp)

        q_new, p_new, g_new, lp_new = jax.lax.fori_loop(
            0, L, leap, (q, p, g, lp)
        )
        log_alpha = (lp_new - kinetic(p_new)) - (lp - ke0)
        accept = jnp.log(jr.uniform(ku, (n,))) < log_alpha
        q = jnp.where(accept[None, :], q_new, q)
        lp = jnp.where(accept, lp_new, lp)
        g = jnp.where(accept[None, :], g_new, g)
        return (q, lp, g, acc + jnp.mean(accept.astype(jnp.float32))), None

    keys = jr.split(jr.key(seed, impl=rng_impl), n_steps)
    q0 = q0.astype(jnp.float32)
    lp0, g0 = lp_g(q0)
    (q, _, _, acc), _ = jax.lax.scan(mh_step, (q0, lp0, g0, 0.0), keys)
    return q, acc / n_steps


def warmup_column(
    logdensity_cols,
    q0,
    seed: int,
    *,
    n_phases: int = 6,
    steps_per_phase: int = 25,
    eps0: float = 0.1,
    L: int = 5,
    target_accept: float = 0.8,
):
    """Windowed warmup for the column layout, on the unified adaptation
    interface (``inference.adaptation``): per phase, run a short HMC sweep,
    nudge the step size toward ``target_accept``, and re-estimate the
    diagonal inverse mass from the CROSS-CHAIN variance (with thousands of
    parallel chains, one time-slice across chains estimates the posterior
    covariance diagonal — no within-chain windows needed).

    The whole schedule compiles to ONE ``lax.scan`` — a single dispatch and
    a single host sync, instead of round-tripping per phase.

    Returns ``(q, eps, inv_mass)`` ready for the main sweep.
    """
    from .adaptation import windowed_warmup

    def sweep(q, idx, eps, inv_mass):
        # phase seeds live on a stream disjoint from any plausible main-
        # sweep seed: seed*1000+idx would make phase 0 of the default
        # seed=0 bit-identical to the main sweep's jr.key(0) stream
        return _reference_hmc(
            logdensity_cols, q, (seed + 1) * 1_000_003 + idx,
            n_steps=steps_per_phase, eps=eps, L=L, inv_mass=inv_mass,
        )

    q, eps, inv_mass, _accs = jax.jit(
        lambda q0: windowed_warmup(
            sweep, q0.astype(jnp.float32),
            n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        )
    )(q0)
    return q, float(eps), inv_mass
