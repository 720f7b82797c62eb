"""Dense-HMM toolset: forward-backward smoothing, Baum-Welch EM, Viterbi.

Generalizes the reference's circulant-configured exact HMM machinery
(`/root/reference/src/genjax/_src/generative_functions/distributions/
custom/discrete_hmm.py:98-239` — forward filter + exact marginals; parity
lives in ``dists/discrete_hmm.py``) to arbitrary dense matrices, and adds
the three classic operations the reference lacks entirely: posterior state
marginals via forward-backward, maximum-likelihood parameter estimation
via Baum-Welch (the discrete twin of ``lgssm_em``), and MAP path decoding
via Viterbi.

All three are single ``lax.scan`` passes whose per-step work is an
``(N, N)`` log-matrix product — batched matmul/elementwise, no host logic.
Everything operates in log space (no underflow for long sequences).

Convention: ``log_pi (N,)`` initial, ``log_trans (N, N)`` rows =
``log p(z_t = j | z_{t-1} = i)``, ``log_obs (N, M)`` rows =
``log p(y = m | z = i)``; observations are an int sequence ``(T,)``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree


@Pytree.dataclass
class HMMPosterior(Pytree):
    """Forward-backward output: per-step smoothed state log-marginals
    ``log p(z_t | y)``, pairwise ``log p(z_t, z_{t+1} | y)``, and the data
    log-likelihood."""

    log_gammas: Any  # (T, N)
    log_xis: Any  # (T-1, N, N)
    log_marginal: Any


def _forward_alphas(log_pi, log_trans, lo):
    """The one sequential forward recursion: ``(alphas (T, N),
    log_marginal)`` from per-step observation log-likelihood rows ``lo``.
    Shared by forward_backward / hmm_posterior_sample (and conceptually
    twinned by the associative-scan :func:`forward_parallel`)."""

    def fwd(alpha, lo_t):
        alpha_new = lo_t + logsumexp(alpha[:, None] + log_trans, axis=0)
        return alpha_new, alpha_new

    alpha0 = log_pi + lo[0]
    _, alphas = lax.scan(fwd, alpha0, lo[1:])
    alphas = jnp.concatenate([alpha0[None], alphas], axis=0)
    return alphas, logsumexp(alphas[-1])


def forward_backward(log_pi, log_trans, log_obs, ys) -> HMMPosterior:
    """Exact smoothing for a dense HMM."""
    lo = log_obs[:, ys].T  # (T, N): log p(y_t | z_t = i)
    alphas, log_marginal = _forward_alphas(log_pi, log_trans, lo)

    def bwd(beta, lo_t):
        beta_new = logsumexp(log_trans + (lo_t + beta)[None, :], axis=1)
        return beta_new, beta_new

    beta_T = jnp.zeros_like(log_pi)
    _, betas = lax.scan(bwd, beta_T, lo[1:], reverse=True)
    betas = jnp.concatenate([betas, beta_T[None]], axis=0)

    log_gammas = alphas + betas - log_marginal
    # xi_t(i, j) = alpha_t(i) + trans(i,j) + obs_{t+1}(j) + beta_{t+1}(j)
    log_xis = (
        alphas[:-1, :, None]
        + log_trans[None]
        + (lo[1:] + betas[1:])[:, None, :]
        - log_marginal
    )
    return HMMPosterior(log_gammas, log_xis, log_marginal)


def hmm_log_marginal(log_pi, log_trans, log_obs, ys):
    """Exact ``log p(y_{0:T-1})`` (forward pass only)."""
    lo = log_obs[:, ys].T
    _, log_marginal = _forward_alphas(log_pi, log_trans, lo)
    return log_marginal



def _semiring_prefix(log_trans, lo, reduce_fn):
    """Prefix products of the per-step matrices ``M_t(i, j) = trans(i, j)
    + obs_t(j)`` over a (reduce, +) semiring via ``associative_scan`` —
    the shared core of the parallel forward, smoothing, and Viterbi
    passes. ``reduce_fn`` is ``logsumexp`` (sum-product) or ``jnp.max``
    (max-product). Returns ``(mats, prefix)`` with prefix[t] =
    M_1 ⊗ … ⊗ M_{t+1}."""
    mats = log_trans[None] + lo[1:, None, :]  # (T-1, N, N)

    def combine(a, b):
        return reduce_fn(a[..., :, :, None] + b[..., None, :, :], axis=-2)

    return mats, lax.associative_scan(combine, mats)


def forward_parallel(log_pi, log_trans, log_obs, ys):
    """Temporally PARALLEL forward pass via ``lax.associative_scan``:
    the forward recursion is a chain of log-space matrix products
    ``alpha_t = alpha_{t-1} ∘ M_t`` with ``M_t(i, j) = trans(i, j) +
    obs_t(j)`` — matrix product over the (log, +) semiring is associative,
    so the whole chain evaluates in O(log T) DEPTH (T·N³ work): on an
    accelerator the sequential scan's T-long dependency chain becomes
    log₂(T) rounds of batched (N, N) einsums. Returns
    ``(alphas (T, N), log_marginal)``, bit-compatible with the sequential
    :func:`forward_backward` alphas up to float-summation order.

    Worth it when T is large and N is small-to-moderate (N³ work per step
    vs the sequential N² — the crossover is wherever the T-step latency
    chain dominates)."""
    lo = log_obs[:, ys].T  # (T, N)
    _, prefix = _semiring_prefix(log_trans, lo, logsumexp)
    alpha0 = log_pi + lo[0]
    alphas_rest = logsumexp(
        alpha0[None, :, None] + prefix, axis=-2
    )  # (T-1, N)
    alphas = jnp.concatenate([alpha0[None], alphas_rest], axis=0)
    return alphas, logsumexp(alphas[-1])


def forward_backward_parallel(log_pi, log_trans, log_obs, ys) -> HMMPosterior:
    """Fully parallel smoothing: both the forward and backward recursions
    are (log, +)-semiring matrix-product chains, so the complete
    forward-backward pass runs in O(log T) depth (two associative scans).
    Returns the same :class:`HMMPosterior` as :func:`forward_backward`."""
    lo = log_obs[:, ys].T  # (T, N)
    alphas, log_marginal = forward_parallel(log_pi, log_trans, log_obs, ys)
    if ys.shape[0] == 1:
        return HMMPosterior(
            alphas - log_marginal,
            jnp.zeros((0,) + log_trans.shape),
            log_marginal,
        )
    mats, _ = _semiring_prefix(log_trans, lo, logsumexp)

    def combine(a, b):
        return logsumexp(a[..., :, :, None] + b[..., None, :, :], axis=-2)

    # backward: beta_t needs the ORDERED suffix product M_{t+1} … M_{T-1}.
    # associative_scan(reverse=True) folds from the end with the same
    # operand order (M_{T-1} ⊗ M_{T-2} ⊗ …), so flip the combine operands
    # to keep left-to-right matrix-product order.
    suffix = lax.associative_scan(
        lambda a, b: combine(b, a), mats, reverse=True
    )
    betas = jnp.concatenate(
        [logsumexp(suffix, axis=-1), jnp.zeros_like(log_pi)[None]], axis=0
    )
    log_gammas = alphas + betas - log_marginal
    log_xis = (
        alphas[:-1, :, None]
        + log_trans[None]
        + (lo[1:] + betas[1:])[:, None, :]
        - log_marginal
    )
    return HMMPosterior(log_gammas, log_xis, log_marginal)


def hmm_posterior_sample(key, log_pi, log_trans, log_obs, ys):
    """One exact joint draw ``z_{0:T-1} ~ p(z | y)`` by forward-filtering
    backward-sampling (the dense generalization of
    ``discrete_hmm.backward_sample``). Returns ``(path (T,),
    log_marginal)``."""
    import jax.random as jr

    lo = log_obs[:, ys].T
    alphas, log_marginal = _forward_alphas(log_pi, log_trans, lo)

    k_last, k_rest = jax.random.split(key)
    z_last = jr.categorical(k_last, alphas[-1])

    def back(z_next, inp):
        k, alpha_t = inp
        z = jr.categorical(k, alpha_t + log_trans[:, z_next])
        return z, z

    T = ys.shape[0]
    _, path_rest = lax.scan(
        back,
        z_last,
        (jr.split(k_rest, T - 1), alphas[:-1]),
        reverse=True,
    )
    path = jnp.concatenate([path_rest, z_last[None]])
    return path, log_marginal


def viterbi(log_pi, log_trans, log_obs, ys):
    """MAP state path: returns ``(path (T,), log p(path, y))``."""
    lo = log_obs[:, ys].T

    def fwd(delta, lo_t):
        scores = delta[:, None] + log_trans  # (N, N)
        best = jnp.argmax(scores, axis=0)
        delta_new = lo_t + jnp.max(scores, axis=0)
        return delta_new, best

    delta0 = log_pi + lo[0]
    delta, backptrs = lax.scan(fwd, delta0, lo[1:])
    z_last = jnp.argmax(delta)

    def back(z_next, ptrs):
        z = ptrs[z_next]
        return z, z

    _, path_rest = lax.scan(back, z_last, backptrs, reverse=True)
    path = jnp.concatenate([path_rest, z_last[None]])
    return path, jnp.max(delta)


def viterbi_parallel(log_pi, log_trans, log_obs, ys):
    """Temporally parallel Viterbi: the max-product forward pass is a
    (max, +)-semiring matrix-product chain, so the delta values come from
    one ``associative_scan`` (O(log T) depth). The backtrack is
    reconstructed from the deltas with a cheap sequential argmax scan
    (vector ops only — no density evaluations). Same output as
    :func:`viterbi`."""
    lo = log_obs[:, ys].T
    T = ys.shape[0]
    delta0 = log_pi + lo[0]
    if T == 1:
        return jnp.argmax(delta0)[None], jnp.max(delta0)
    _, prefix = _semiring_prefix(log_trans, lo, jnp.max)
    deltas = jnp.concatenate(
        [delta0[None], jnp.max(delta0[None, :, None] + prefix, axis=-2)],
        axis=0,
    )  # (T, N)
    z_last = jnp.argmax(deltas[-1])

    def back(z_next, delta_t):
        # z_t = argmax_i delta_t(i) + trans(i, z_next): the max-product
        # recursion guarantees this reconstructs an optimal path
        z = jnp.argmax(delta_t + log_trans[:, z_next])
        return z, z

    _, path_rest = lax.scan(back, z_last, deltas[:-1], reverse=True)
    return jnp.concatenate([path_rest, z_last[None]]), jnp.max(deltas[-1])


def hmm_em(
    log_pi,
    log_trans,
    log_obs,
    ys,
    *,
    n_iters: int = 20,
    fit: tuple = ("pi", "trans", "obs"),
):
    """Baum-Welch: EM over the dense HMM parameters. Returns
    ``((log_pi, log_trans, log_obs), log_marginals (n_iters,))`` with the
    log-marginal trace evaluated at the START of each iteration (monotone
    non-decreasing — the EM guarantee this module is tested by)."""
    ys = jnp.asarray(ys)
    n_obs = log_obs.shape[1]
    y_onehot = jax.nn.one_hot(ys, n_obs)  # (T, M)

    def one_iter(params, _):
        lp, lt, lo = params
        post = forward_backward(lp, lt, lo, ys)
        gammas = jnp.exp(post.log_gammas)  # (T, N)
        xis = jnp.exp(post.log_xis)  # (T-1, N, N)
        lp_new = post.log_gammas[0] if "pi" in fit else lp

        def safe_row_normalize(num, old_log_rows):
            # a state with zero posterior mass has a 0/0 row: keep its old
            # parameters (it is unvisited, so any row is M-step-optimal)
            # instead of letting one NaN row poison every state next pass
            den = jnp.sum(num, axis=1, keepdims=True)
            rows = jnp.log(num / jnp.where(den > 0, den, 1.0))
            return jnp.where(den > 0, rows, old_log_rows)

        lt_new = (
            safe_row_normalize(jnp.sum(xis, axis=0), lt)
            if "trans" in fit
            else lt
        )
        lo_new = (
            safe_row_normalize(gammas.T @ y_onehot, lo)
            if "obs" in fit
            else lo
        )
        return (lp_new, lt_new, lo_new), post.log_marginal

    return lax.scan(one_iter, (log_pi, log_trans, log_obs), None, length=n_iters)
