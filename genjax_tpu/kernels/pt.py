"""Parallel-tempering (replica-exchange) HMC on the column layout.

Multimodal posteriors defeat single-temperature gradient MCMC: HMC/ChEES
chains equilibrate inside the mode they started in and essentially never
cross low-density barriers. Parallel tempering runs a ladder of ``R``
inverse temperatures ``1 = beta_0 > beta_1 > ... > beta_{R-1}`` — each rung
targets ``pi^beta`` — and exchanges states between adjacent rungs with a
Metropolis swap, so mode-hopping happens at the hot rungs (where barriers
are flat) and percolates down to the cold chain.

No reference counterpart (the reference ships no MCMC drivers at all;
its temperature machinery is SMC-side, cf. our ``inference/tempered.py``
which anneals a *particle population* once — this kernel keeps a
*stationary* ladder for equilibrium MCMC).

Design:

- State is ``(R, D, N)``: rungs on the sublane-major axis, chains on
  lanes. Every rung advances every chain in ONE fused HMC sweep — the
  ``R`` ladder is just another batch dimension on the ``(D, N)`` column
  kernel (``jax.vmap`` of the log-density over rungs), so the device sees
  an ``R``-times-larger batch, not a Python loop over rungs.
- Swaps are even-odd (deterministic-parity) adjacent exchanges
  (Okabe et al. 2001): pairs ``(r, r+1)`` with ``r ≡ sweep (mod 2)`` are
  disjoint, so the whole exchange phase is two ``jnp.roll``s (static
  shifts — no gathers) and a ``where``.
  The swap acceptance reuses the *already computed* untempered
  log-densities: ``log alpha = (beta_r - beta_{r+1}) (lp_{r+1} - lp_r)``
  — zero extra density evaluations.
- Per-rung step sizes adapt by vectorized dual averaging (one
  ``StepSizeAdaptState`` whose leaves are ``(R,)`` vectors), per-rung
  diagonal inverse mass from cross-chain variance — the massive-chain
  estimators of ``inference/adaptation.py``, broadcast over the ladder.

The whole run (warmup + sampling) is two ``lax.scan``s; nothing touches
the host between sweeps.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax

from ..core.pytree import Pytree
from .adaptation import (
    StepSizeAdaptState,
    cross_chain_inv_mass,
    dual_averaging_update,
)


@Pytree.dataclass
class PTInfo(Pytree):
    """Adapted settings + run statistics.

    ``eps``/``inv_mass``/``accept_rate`` are per-rung (``(R,)`` / ``(R, D)``
    / ``(R,)``); ``swap_rate`` is per adjacent pair (``(R-1,)``); ``draws``
    is ``None`` unless ``collect``: then ``(n_steps, D, N)`` cold-chain
    positions."""

    eps: Any
    accept_rate: Any
    swap_rate: Any
    inv_mass: Any
    draws: Any


def geometric_ladder(n_rungs: int, beta_min: float = 0.05):
    """``n_rungs`` inverse temperatures, 1 down to ``beta_min``,
    geometrically spaced — the standard default when the energy scale is
    unknown (swap rates stay roughly flat across a geometric ladder for
    Gaussian-like targets)."""
    if n_rungs < 1:
        raise ValueError("need at least one rung")
    if n_rungs == 1:
        return jnp.ones((1,), jnp.float32)
    return jnp.asarray(
        beta_min ** (jnp.arange(n_rungs) / (n_rungs - 1)), jnp.float32
    )


def pt_hmc(
    logdensity_cols,
    q0,
    seed,
    *,
    betas,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps0: float = 0.05,
    L: int = 8,
    target_accept: float = 0.8,
    inv_mass: Any | None = None,
    adapt_mass: bool = True,
    rng_impl: str = "rbg",
    collect: bool = False,
):
    """Replica-exchange HMC over ``N`` column-layout chains × ``R`` rungs.

    Args:
        logdensity_cols: batched UNTEMPERED log-density ``(D, N) -> (N,)``.
        q0: initial positions — ``(D, N)`` (tiled across rungs) or
            ``(R, D, N)`` for per-rung starts.
        seed: an int (a fresh ``jax.random.key(seed, impl=rng_impl)`` is
            derived) or a PRNG key array used directly.
        betas: inverse-temperature ladder, descending, ``betas[0] == 1``
            (the cold chain whose draws are returned); see
            ``geometric_ladder``.
        n_warmup: adaptation sweeps (per-rung eps + mass).
        n_steps: sampling sweeps at the adapted settings.
        L: leapfrog steps per HMC proposal (every rung, every sweep).
        collect: record every sampling sweep's cold-chain positions.

    Returns ``(q_cold, PTInfo)`` with ``q_cold`` the final ``(D, N)``
    cold-chain positions.
    """
    betas = jnp.asarray(betas, jnp.float32)
    if betas.ndim != 1:
        raise ValueError("betas must be a 1-D descending ladder")
    r = betas.shape[0]
    if q0.ndim == 2:
        q0 = jnp.broadcast_to(q0[None], (r,) + q0.shape)
    if q0.ndim != 3 or q0.shape[0] != r:
        raise ValueError(
            f"q0 must be (D, N) or (R, D, N) with R={r}, got {q0.shape}"
        )
    q0 = q0.astype(jnp.float32)
    _, d, n = q0.shape
    beta_col = betas[:, None, None]  # (R, 1, 1) over (R, D, N)
    beta_row = betas[:, None]  # (R, 1) over (R, N)

    if inv_mass is None:
        inv_mass0 = jnp.ones((r, d), jnp.float32)
    else:
        inv_mass0 = jnp.broadcast_to(
            jnp.asarray(inv_mass, jnp.float32), (r, d)
        )

    ld_rungs = jax.vmap(logdensity_cols)  # (R, D, N) -> (R, N), untempered

    def lp_g(q):
        lp, pullback = jax.vjp(ld_rungs, q)
        (g,) = pullback(jnp.ones_like(lp))
        return lp, g

    def hmc_sweep(q, lp, g, key, eps, inv_mass):
        """One tempered HMC transition on every rung/chain. ``lp``/``g``
        are UNTEMPERED; the temperature enters as a multiplier on the
        potential (grad and MH ratio), never on the carried state."""
        im = inv_mass[:, :, None]  # (R, D, 1)
        eps_b = eps[:, None, None]  # (R, 1, 1)
        kp, ku = jr.split(key)
        p = jr.normal(kp, (r, d, n)) / jnp.sqrt(im)

        def kinetic(p_):
            return 0.5 * jnp.sum(im * p_ * p_, axis=1)  # (R, N)

        def leap(_, c):
            q_, p_, g_, lp_ = c
            p_ = p_ + (eps_b / 2.0) * (beta_col * g_)
            q_ = q_ + eps_b * im * p_
            lp_, g_ = lp_g(q_)
            p_ = p_ + (eps_b / 2.0) * (beta_col * g_)
            return (q_, p_, g_, lp_)

        q1, p1, g1, lp1 = lax.fori_loop(0, L, leap, (q, p, g, lp))
        log_alpha = (beta_row * lp1 - kinetic(p1)) - (
            beta_row * lp - kinetic(p)
        )
        accept = jnp.log(jr.uniform(ku, (r, n))) < log_alpha  # NaN ⇒ False
        accept = accept & jnp.all(jnp.isfinite(q1), axis=1)
        qn = jnp.where(accept[:, None, :], q1, q)
        lpn = jnp.where(accept, lp1, lp)
        gn = jnp.where(accept[:, None, :], g1, g)
        alpha = jnp.where(
            jnp.isnan(log_alpha),
            0.0,
            jnp.minimum(1.0, jnp.exp(jnp.minimum(log_alpha, 0.0))),
        )
        return qn, lpn, gn, jnp.mean(alpha, axis=1)  # accept per rung

    def swap_sweep(q, lp, g, key, parity):
        """Even-odd adjacent exchange. Pair ``(r, r+1)`` is active when
        ``r ≡ parity (mod 2)`` — active pairs are disjoint, so the update
        is a pure select between a state and its roll-by-one neighbor."""
        if r == 1:
            return q, lp, g, jnp.zeros((0,), jnp.float32)
        # log swap-acceptance for every adjacent pair (R-1, N)
        dbeta = betas[:-1] - betas[1:]  # (R-1,)
        log_s = dbeta[:, None] * (lp[1:] - lp[:-1])
        u = jr.uniform(key, (r - 1, n))
        active = (jnp.arange(r - 1) % 2) == parity  # (R-1,)
        do = active[:, None] & (jnp.log(u) < log_s)  # (R-1, N)
        # swap_up[r]: rung r takes rung r+1's state (and vice versa)
        pad = jnp.zeros((1, n), bool)
        swap_up = jnp.concatenate([do, pad], axis=0)  # (R, N)
        swap_dn = jnp.concatenate([pad, do], axis=0)  # (R, N)

        def exchange(x, row_mask_up, row_mask_dn):
            up = jnp.roll(x, -1, axis=0)
            dn = jnp.roll(x, 1, axis=0)
            return jnp.where(
                row_mask_up, up, jnp.where(row_mask_dn, dn, x)
            )

        m_up3, m_dn3 = swap_up[:, None, :], swap_dn[:, None, :]
        q = exchange(q, m_up3, m_dn3)
        lp = exchange(lp, swap_up, swap_dn)
        g = exchange(g, m_up3, m_dn3)
        return q, lp, g, jnp.mean(do, axis=1)  # swap rate per pair

    if hasattr(seed, "dtype") and jnp.issubdtype(
        jnp.asarray(seed).dtype, jax.dtypes.prng_key
    ):
        root = seed
    else:
        root = jr.key(seed, impl=rng_impl)
    lp_init, g_init = lp_g(q0)

    def warm_step(carry, inp):
        q, lp, g, adapt, inv_mass = carry
        idx, key = inp
        k_hmc, k_swap = jr.split(key)
        eps = jnp.exp(adapt.log_eps)
        q, lp, g, acc = hmc_sweep(q, lp, g, k_hmc, eps, inv_mass)
        q, lp, g, _sw = swap_sweep(q, lp, g, k_swap, idx % 2)
        adapt = dual_averaging_update(
            adapt, acc, target_accept=target_accept
        )
        if adapt_mass:
            inv_mass = cross_chain_inv_mass(q, chain_axis=2)
        return (q, lp, g, adapt, inv_mass), None

    # vectorized dual averaging: every leaf (except the shared step
    # counter) carries the rung axis up front — lax.scan needs the carry
    # shape stable, so the zeros must be (R,) from sweep 0
    eps0_v = jnp.full((r,), eps0, jnp.float32)
    adapt0 = StepSizeAdaptState(
        jnp.log(eps0_v),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.asarray(0),
        jnp.log(10.0 * eps0_v),
    )
    if n_warmup > 0:
        wkeys = jr.split(jr.fold_in(root, 1), n_warmup)
        (q, lp, g, adapt, inv_mass_f), _ = lax.scan(
            warm_step,
            (q0, lp_init, g_init, adapt0, inv_mass0),
            (jnp.arange(n_warmup), wkeys),
        )
        eps_f = jnp.exp(adapt.log_eps_bar)
    else:
        q, lp, g = q0, lp_init, g_init
        eps_f = jnp.full((r,), eps0, jnp.float32)
        inv_mass_f = inv_mass0

    def sample_step(carry, inp):
        q, lp, g = carry
        idx, key = inp
        k_hmc, k_swap = jr.split(key)
        q, lp, g, acc = hmc_sweep(q, lp, g, k_hmc, eps_f, inv_mass_f)
        q, lp, g, sw = swap_sweep(q, lp, g, k_swap, idx % 2)
        out = q[0] if collect else None
        return (q, lp, g), (acc, sw, out)

    skeys = jr.split(jr.fold_in(root, 2), n_steps)
    (q, lp, g), (accs, sws, draws) = lax.scan(
        sample_step,
        (q, lp, g),
        (jnp.arange(n_warmup, n_warmup + n_steps), skeys),
    )
    info = PTInfo(
        eps=eps_f,
        accept_rate=jnp.mean(accs, axis=0),
        # each pair is active every OTHER sweep: the conditional
        # (per-attempt) swap rate is twice the raw mean
        swap_rate=2.0 * jnp.mean(sws, axis=0),
        inv_mass=inv_mass_f,
        draws=draws,
    )
    return q[0], info
