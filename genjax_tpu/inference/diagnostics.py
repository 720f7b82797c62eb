"""MCMC convergence diagnostics: split-R̂ and effective sample size.

No reference counterpart (SURVEY.md §5: no metrics/observability beyond
rendering) — production chain batches need convergence monitoring. All
diagnostics are pure reductions over the (chains, draws) axes, so they
compile to collectives when the chain axis is sharded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def split_rhat(draws) -> jnp.ndarray:
    """Split-chain potential scale reduction factor (Gelman et al., BDA3 /
    Vehtari et al. 2021). ``draws``: (n_chains, n_draws[, ...]). Values
    near 1 indicate convergence.

    >>> import jax
    >>> from genjax_tpu.inference.diagnostics import split_rhat
    >>> iid = jax.random.normal(jax.random.key(0), (4, 400))
    >>> bool(split_rhat(iid) < 1.05)      # well-mixed chains
    True
    >>> shifted = iid + jax.numpy.arange(4)[:, None] * 5.0
    >>> bool(split_rhat(shifted) > 1.5)   # chains disagree
    True
    """
    n_chains, n_draws = draws.shape[0], draws.shape[1]
    half = n_draws // 2
    split = jnp.concatenate(
        [draws[:, :half], draws[:, half : 2 * half]], axis=0
    )
    m, n = split.shape[0], split.shape[1]
    chain_means = jnp.mean(split, axis=1)
    chain_vars = jnp.var(split, axis=1, ddof=1)
    w = jnp.mean(chain_vars, axis=0)
    b = n * jnp.var(chain_means, axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / w)


def ess(
    draws, max_lag: int | None = None, *, return_tau: bool = False
) -> jnp.ndarray:
    """Bulk effective sample size (Vehtari et al. 2021): split chains,
    cross-chain pooled-variance autocorrelations, Geyer initial positive
    sequence with a fixed lag budget. ``draws``: (n_chains, n_draws).

    ``return_tau=True`` additionally returns ``(tau_hat, truncated)``:
    the integrated autocorrelation time estimate and whether the Geyer
    initial-positive-sequence stop happened INSIDE the lag budget (if it
    did not, ``tau_hat`` is budget-limited and ESS may be overestimated —
    callers self-certify by checking ``tau_hat`` against ``max_lag``; see
    ``bench.py _ess_line``).

    >>> import jax
    >>> from genjax_tpu.inference.diagnostics import ess
    >>> iid = jax.random.normal(jax.random.key(0), (4, 400))
    >>> bool(ess(iid) > 1000.0)   # iid draws: ESS near n_chains*n_draws
    True
    >>> _e, (tau, trunc) = ess(iid, return_tau=True)
    >>> bool(tau < 2.0), bool(trunc)  # iid: tau ~ 1, stops inside budget
    (True, True)

    The lag-t correlation is ``rho_t = 1 - (W - mean_acov_t) / var_plus``
    with ``var_plus = (n-1)/n W + B/n`` — between-chain disagreement
    (chains stuck at different modes) inflates ``var_plus`` and drives the
    estimate toward zero, where a within-chain-only normalization would
    report maximal ESS for an unconverged run."""
    n_chains, n_draws = draws.shape[0], draws.shape[1]
    half = n_draws // 2
    if half >= 2:
        # split each chain in two so within-chain drift also registers
        split = jnp.concatenate(
            [draws[:, :half], draws[:, half : 2 * half]], axis=0
        )
    else:
        split = draws
    m, n = split.shape[0], split.shape[1]
    if max_lag is None:
        max_lag = min(n - 1, 256)
    else:
        max_lag = min(max_lag, n - 1)
    if max_lag < 1:
        # a single draw per chain carries no autocorrelation information:
        # tau = 1 (jnp.stack on zero lags would crash)
        out = jnp.asarray(float(n_chains * n_draws))
        if return_tau:
            return out, (jnp.asarray(1.0), jnp.asarray(True))
        return out
    centered = split - jnp.mean(split, axis=1, keepdims=True)
    chain_vars = jnp.sum(centered**2, axis=1) / (n - 1)
    w = jnp.mean(chain_vars) + 1e-12
    b_over_n = jnp.var(jnp.mean(split, axis=1), ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b_over_n

    # all-lag autocovariance as ONE compiled loop (roll + prefix mask) —
    # a fixed-size graph, vs. an unrolled per-lag Python loop that
    # dominates trace time. (Not FFT: XLA's CPU fft thunk rejects the
    # transposed layouts vmap feeds it.)
    positions = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)

    def acov_at(_, lag):
        shifted = jnp.roll(centered, -lag, axis=1)
        valid = (positions < n - lag).astype(centered.dtype)
        return None, jnp.mean(jnp.sum(centered * shifted * valid, axis=1) / n)

    _, mean_acovs = jax.lax.scan(
        acov_at, None, jnp.arange(1, max_lag + 1)
    )
    rhos = 1.0 - (w - mean_acovs) / var_plus
    # Geyer: sum consecutive pairs while positive
    pair_sums = rhos[0::2][: max_lag // 2] + rhos[1::2][: max_lag // 2]
    positive = jnp.cumprod(pair_sums > 0)
    tau = 1.0 + 2.0 * jnp.sum(jnp.where(positive, pair_sums, 0.0))
    total = n_chains * n_draws
    out = jnp.clip(total / tau, 0.0, float(total))
    if return_tau:
        # truncated-inside-budget = the positive sequence hit a
        # non-positive pair before the last pair in the budget
        truncated = jnp.any(positive == 0)
        return out, (jnp.maximum(tau, 1.0), truncated)
    return out


__all__ = ["ess", "split_rhat"]
