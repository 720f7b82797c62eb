"""Unified MCMC warmup adaptation: step size + diagonal mass matrix.

One interface shared by the fused column kernels (``kernels.hmc.
warmup_column``, ``kernels.model_interface.column_nuts``) and the
trace-based sharded chain driver (``parallel.mcmc.warmup_adapt_step_size``).
No reference counterpart (the reference ships no adaptation; ``HMC.eps``
is a constructor constant, hmc.py:152-154).

This module lives in ``kernels/`` — the lowest layer that needs it — so
that every consumer (``kernels.chees``, ``kernels.pt``, ``parallel.mcmc``,
``inference.smc_chees``) imports strictly *downward*. Round 3 ended with
``inference.smc_chees`` ↔ ``kernels.chees`` closing an import cycle through
the eager package facades; keeping the shared adaptation estimators in a
leaf module below both subpackages makes that cycle impossible
(``tests/test_layering.py`` enforces the direction).
``genjax_tpu.inference.adaptation`` remains as a re-export shim for the
public API.

Components:

- ``StepSizeAdaptState`` / ``dual_averaging_update`` — Nesterov
  dual averaging on the cross-chain mean accept probability (Hoffman &
  Gelman 2014 §3.2); the right tool when adapting per *transition*.
- ``multiplicative_nudge`` — coarse per-window step-size update; the right
  tool when adapting per *window* of many transitions (few updates, large
  windows: dual averaging's schedule never leaves its transient).
- ``cross_chain_inv_mass`` — diagonal inverse-mass (≈ posterior variance)
  estimated from the *cross-chain* variance of one time slice. With
  thousands of parallel chains this replaces within-chain windowed
  covariance estimation entirely.
- ``rescale_for_metric`` — carries the step size across a metric update
  that rescales every dimension the same way by more than 10x, so the
  position-space step, and with it the acceptance, is unchanged by it.
- ``adapt_window`` — the end-of-window rule of every windowed diagonal
  warmup: nudge, re-estimate the metric, carry the step size across.

All pieces are jit-compatible: warmups compile to a single ``lax.scan``
over windows with no host round-trips.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp
from jax import lax

from ..core.pytree import Pytree


@Pytree.dataclass
class StepSizeAdaptState(Pytree):
    """Dual-averaging state (Nesterov 2009 / Hoffman & Gelman 2014 §3.2)."""

    log_eps: Any
    log_eps_bar: Any
    h_bar: Any
    step: Any
    mu: Any  # shrinkage point: log(10 * eps0), fixed

    @staticmethod
    def init(eps0):
        return StepSizeAdaptState(
            jnp.log(jnp.asarray(eps0, jnp.float32)),
            jnp.asarray(0.0),
            jnp.asarray(0.0),
            jnp.asarray(0),
            jnp.log(10.0 * jnp.asarray(eps0, jnp.float32)),
        )


def dual_averaging_update(
    state: StepSizeAdaptState,
    accept_rate,
    *,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
) -> StepSizeAdaptState:
    step = state.step + 1
    eta = 1.0 / (step + t0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (target_accept - accept_rate)
    log_eps = state.mu - jnp.sqrt(step.astype(jnp.float32)) / gamma * h_bar
    w = step.astype(jnp.float32) ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return StepSizeAdaptState(log_eps, log_eps_bar, h_bar, step, state.mu)


def multiplicative_nudge(eps, accept_rate, *, target_accept: float = 0.8,
                         rate: float = 1.5):
    """``eps * exp(rate * (accept - target))`` — monotone, scale-free, and
    convergent in a handful of windows."""
    return eps * jnp.exp(rate * (accept_rate - target_accept))


_RESCALE_MIN_RATIO = 10.0


def rescale_for_metric(eps, old_inv_mass, new_inv_mass):
    """Carry the step size across a metric update that rescales every
    dimension the same way by more than 10x.

    Then ``eps * sqrt(gmean(old / new))`` keeps the geometric-mean
    position-space step ``eps * sqrt(inv_mass)`` unchanged, and with it
    the acceptance the nudge just tuned. Without it, a metric that shrinks
    by orders of magnitude (a data-heavy posterior far narrower than its
    prior) leaves ``eps`` orders of magnitude too small, which the bounded
    per-window :func:`multiplicative_nudge` cannot recover in a few
    windows. Any other update is left to the nudge: on a correlated
    posterior the marginal variances overstate the step the metric
    allows.

    The per-transition adapters (``kernels.chees``, ``kernels.pt``,
    ``inference.smc_chees``) do not need it: they re-estimate the metric
    after every transition, so consecutive metrics differ little, and
    their dual-averaging step size is not bounded per update."""
    log_r = jnp.log(jnp.asarray(old_inv_mass) / jnp.asarray(new_inv_mass))
    bound = jnp.log(_RESCALE_MIN_RATIO)
    uniform = jnp.logical_or(jnp.min(log_r) > bound, jnp.max(log_r) < -bound)
    return jnp.where(uniform, eps * jnp.exp(0.5 * jnp.mean(log_r)), eps)


def cross_chain_inv_mass(q, *, chain_axis: int = 1, floor: float = 1e-6):
    """Diagonal inverse mass from the cross-chain variance of one time
    slice. ``q`` is the position batch; padding dimensions (zero variance)
    are floored so their momenta stay finite."""
    return jnp.maximum(jnp.var(q, axis=chain_axis), floor)


def adapt_window(eps, inv_mass, accept_rate, q, *,
                 target_accept: float = 0.8, chain_axis: int = 1,
                 nudge_rate: float = 1.5):
    """End-of-window update of a diagonal warmup: nudge ``eps`` toward
    ``target_accept`` (:func:`multiplicative_nudge`), re-estimate the
    inverse mass from the chains ``q`` (:func:`cross_chain_inv_mass`), and
    carry ``eps`` across the new metric (:func:`rescale_for_metric`).
    Returns ``(eps, inv_mass)``."""
    eps = multiplicative_nudge(
        eps, accept_rate, target_accept=target_accept, rate=nudge_rate
    )
    new_inv_mass = cross_chain_inv_mass(q, chain_axis=chain_axis)
    return rescale_for_metric(eps, inv_mass, new_inv_mass), new_inv_mass


def windowed_warmup(
    sweep: Callable,
    q0,
    *,
    n_windows: int,
    eps0,
    target_accept: float = 0.8,
    chain_axis: int = 1,
    nudge_rate: float = 1.5,
):
    """Generic windowed warmup as ONE ``lax.scan``: per window, run
    ``sweep(q, window_index, eps, inv_mass) -> (q, accept_rate)``, then
    :func:`adapt_window`: nudge the step size toward ``target_accept``,
    re-estimate the diagonal inverse mass from cross-chain variance and
    carry the step size across it. No host synchronization between windows.

    Returns ``(q, eps, inv_mass, accept_history)`` (all traced — callers
    needing Python floats sync once at the end).
    """
    d = q0.shape[0] if chain_axis == 1 else q0.shape[-1]

    def window(carry, idx):
        q, eps, inv_mass = carry
        q, acc = sweep(q, idx, eps, inv_mass)
        eps, inv_mass = adapt_window(
            eps, inv_mass, acc, q, target_accept=target_accept,
            chain_axis=chain_axis, nudge_rate=nudge_rate,
        )
        return (q, eps, inv_mass), acc

    init = (
        q0,
        jnp.asarray(eps0, jnp.float32),
        jnp.ones((d,), jnp.float32),
    )
    (q, eps, inv_mass), accs = lax.scan(
        window, init, jnp.arange(n_windows)
    )
    return q, eps, inv_mass, accs


def _halton2(i):
    """Base-2 van der Corput value of ``i`` in (0, 1) — 24 bits.

    Low-discrepancy trajectory-length jitter shared by the ChEES chain
    kernel (``kernels.chees``) and the ChEES-adaptive tempered SMC sampler
    (``inference.smc_chees``); lives here so both import downward.
    """
    bits = jnp.arange(24)
    digits = (i >> bits) & 1
    return jnp.sum(digits * 0.5 ** (bits + 1.0)) + 2.0**-25
