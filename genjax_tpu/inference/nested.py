"""Nested sampling (Skilling 2006): evidence estimation by repeatedly
replacing the worst live point with a prior draw constrained to higher
likelihood.

The reference has no counterpart (its only evidence estimators are SMC
marginal-likelihood estimates, ``/root/reference/src/genjax/_src/inference/
smc.py:96``); this module adds the third classic evidence family next to
``tempered_smc`` / ``adaptive_tempered_smc``. Useful where tempering
struggles: likelihood plateaus, phase transitions (Z(beta) ladders place
no rungs where d log Z / d beta jumps), and when the *full* Z(X) profile
or an information estimate H is wanted.

Shape discipline:

- A single run is inherently sequential (one dead point per iteration),
  so the unit of parallelism is the RUN: ``n_runs`` independent replicas
  execute in one vmapped ``lax.scan`` — replicas supply both throughput
  and a between-run spread that is the honest error bar (Skilling's
  single-run sqrt(H/n_live) underestimates error when the constrained
  walk mixes poorly).
- Everything is fixed-shape: ``n_iter`` is static, the constrained
  replacement walk is a fixed ``n_mcmc``-step MH scan targeting the prior
  restricted to ``{log_lik > L_min}``, step scale self-tunes toward a
  ~35% acceptance rate from the per-iteration acceptance fraction, and
  the proposal uses the per-dimension std of the live set (an implicit
  ellipsoidal proposal that needs no covariance factorization).

``column_nested_sampling`` bridges ``@gen`` models: the latent prior
density is the ``generate`` weight under a latents-only constraint (the
weight counts exactly the constrained addresses — reference
``distribution.py:144`` semantics), and the likelihood is the joint
column density minus that prior, so tile-padding dimensions cancel
exactly and contribute factor 1 to the evidence.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey


@Pytree.dataclass
class NestedSamplingResult(Pytree):
    """Per-run arrays lead with the run axis ``R = n_runs``."""

    log_z: Any  # (R,) per-run evidence estimates
    h: Any  # (R,) information  H = E_post[log L] - log Z  (nats)
    dead: Any  # (R, n_iter, D) dead points — the posterior draws
    dead_log_lik: Any  # (R, n_iter) dead-point likelihoods (non-decreasing)
    dead_log_weight: Any  # (R, n_iter) normalized posterior log-weights
    live: Any  # (R, D, n_live) final live points (innermost L shell)
    live_log_lik: Any  # (R, n_live)
    accept_rate: Any  # (R,) mean constrained-walk acceptance

    @property
    def log_z_mean(self):
        return jnp.mean(self.log_z)

    @property
    def log_z_std(self):
        return jnp.std(self.log_z)

    @property
    def n_live(self) -> int:
        return self.live.shape[-1]

    def error_estimate(self):
        """Classic per-run error sqrt(H / n_live), averaged over runs;
        compare with the between-run ``log_z_std`` — disagreement signals
        a poorly mixing constrained walk."""
        return jnp.mean(jnp.sqrt(jnp.maximum(self.h, 0.0) / self.n_live))

    def posterior_mean(self):
        """Posterior expectation of the position, pooling every run's
        weighted dead points: ``(D,)``. (The *live* points are NOT
        posterior draws — they concentrate on the innermost likelihood
        shell; posterior mass lives on the weighted dead sequence.)"""
        w = jnp.exp(self.dead_log_weight)  # (R, n_iter), sums to ~1 per run
        w = w / jnp.sum(w)
        return jnp.einsum("ri,rid->d", w, self.dead)

    def resample_posterior(self, key: PRNGKey, n: int):
        """``n`` equally-weighted posterior draws ``(n, D)`` by categorical
        resampling of the pooled dead points."""
        r, n_iter, d_dim = self.dead.shape
        logits = jnp.reshape(self.dead_log_weight, (-1,))
        idx = jr.categorical(key, logits, shape=(n,))
        flat = jnp.reshape(self.dead, (r * n_iter, d_dim))
        return flat[idx]


def nested_sampling(
    sample_prior: Callable[[PRNGKey, int], Any],
    log_prior: Callable,
    log_lik: Callable,
    key: PRNGKey,
    *,
    n_live: int = 256,
    n_iter: int,
    n_mcmc: int = 20,
    n_runs: int = 32,
    step_scale: float = 0.4,
) -> NestedSamplingResult:
    """Run ``n_runs`` independent nested-sampling replicas.

    Args:
        sample_prior: ``(key, n) -> (D, n)`` column draw from the prior.
        log_prior: batched column log prior density ``(D, NB) -> (NB,)``
            (an unnormalized density shifts nothing: only ratios enter).
        log_lik: batched column log likelihood ``(D, NB) -> (NB,)``.
        key: PRNG key.
        n_live: live points per run.
        n_iter: dead points per run. The prior-to-posterior compression is
            ``exp(-n_iter / n_live)``; choose ``n_iter >~ n_live * (H + a
            few nats)`` so the live remainder is negligible.
        n_mcmc: constrained random-walk MH steps per replacement.
        n_runs: independent replicas (the parallel axis).
        step_scale: initial proposal scale, in units of the live set's
            per-dimension std; self-tunes toward ~35% acceptance.

    Returns:
        :class:`NestedSamplingResult`.
    """

    def one_run(run_key):
        k_init, k_scan = jr.split(run_key)
        q = sample_prior(k_init, n_live)  # (D, n_live)
        q = jnp.asarray(q, jnp.float32)
        lp = log_prior(q)
        ll = log_lik(q)

        def replace(kk, q, lp, ll, eps):
            """One dead point: record the min, walk a copy of a surviving
            live point through prior-constrained MH."""
            i_min = jnp.argmin(ll)
            l_min = ll[i_min]
            k_pick, k_mcmc = jr.split(kk)
            j = jr.randint(k_pick, (), 0, n_live)
            j = jnp.where(j == i_min, (j + 1) % n_live, j)
            sigma = jnp.std(q, axis=1) + 1e-12  # (D,)

            def mh(c, km):
                qq, qlp, qll, n_acc = c
                k1, k2 = jr.split(km)
                prop = qq + eps * sigma * jr.normal(k1, qq.shape)
                plp = log_prior(prop[:, None])[0]
                pll = log_lik(prop[:, None])[0]
                ok = (jnp.log(jr.uniform(k2)) < plp - qlp) & (pll > l_min)
                qq = jnp.where(ok, prop, qq)
                qlp = jnp.where(ok, plp, qlp)
                qll = jnp.where(ok, pll, qll)
                return (qq, qlp, qll, n_acc + ok.astype(jnp.float32)), None

            (q_new, lp_new, ll_new, n_acc), _ = lax.scan(
                mh,
                (q[:, j], lp[j], ll[j], jnp.float32(0.0)),
                jr.split(k_mcmc, n_mcmc),
            )
            acc = n_acc / n_mcmc
            q_dead = q[:, i_min]
            q = q.at[:, i_min].set(q_new)
            lp = lp.at[i_min].set(lp_new)
            ll = ll.at[i_min].set(ll_new)
            # multiplicative nudge toward ~35% acceptance (clipped so a
            # run of all-rejects cannot collapse the walk to zero)
            eps = jnp.clip(eps * jnp.exp(0.3 * (acc - 0.35)), 1e-4, 1e2)
            return q, lp, ll, eps, q_dead, l_min, acc

        def step(carry, kk):
            q, lp, ll, eps = carry
            q, lp, ll, eps, q_dead, l_min, acc = replace(kk, q, lp, ll, eps)
            return (q, lp, ll, eps), (q_dead, l_min, acc)

        (q, lp, ll, _eps), (dead_q, dead_ll, accs) = lax.scan(
            step,
            (q, lp, ll, jnp.float32(step_scale)),
            jr.split(k_scan, n_iter),
        )

        # --- evidence quadrature (deterministic X_i = exp(-i/n_live)) ---
        t = 1.0 / n_live
        i = jnp.arange(n_iter)
        #   log dX_i = log(X_{i-1} - X_i) = -i*t + log(1 - e^{-t})
        log_dx = -i * t + jnp.log(-jnp.expm1(-t))
        log_z_dead = logsumexp(dead_ll + log_dx)
        # live remainder: X_final * mean(L_live)
        log_z_live = logsumexp(ll) - jnp.log(n_live) - n_iter * t
        log_z = jnp.logaddexp(log_z_dead, log_z_live)

        # information H = sum p_i log L_i - log Z over dead + live mass
        dead_log_w = dead_ll + log_dx - log_z
        p_dead = jnp.exp(dead_log_w)
        p_live = jnp.exp(ll - jnp.log(n_live) - n_iter * t - log_z)
        h = (
            jnp.sum(p_dead * dead_ll)
            + jnp.sum(p_live * ll)
            - log_z
        )
        return log_z, h, dead_q, dead_ll, dead_log_w, q, ll, jnp.mean(accs)

    log_z, h, dead_q, dead_ll, dead_log_w, live, live_ll, acc = jax.vmap(
        one_run
    )(jr.split(key, n_runs))
    return NestedSamplingResult(
        log_z, h, dead_q, dead_ll, dead_log_w, live, live_ll, acc
    )


def column_nested_sampling(
    model,
    constraint,
    args: tuple,
    addresses,
    key: PRNGKey,
    *,
    n_live: int = 256,
    n_iter: int,
    n_mcmc: int = 20,
    n_runs: int = 32,
    step_scale: float = 0.4,
):
    """Nested sampling over a model's continuous latents in the column
    layout. Returns ``(result, packer)``; ``result.log_z`` estimates the
    log evidence ``log p(constraint)`` and ``packer.unpack`` decodes live
    points back to choice maps.

    The prior density over a packed column is the ``generate`` weight
    under the latents-only constraint (tile-padding dimensions carry the
    same standard-normal factor as ``column_logdensity``, so the
    likelihood = joint - prior is exactly padding-free and the padding
    contributes factor 1 to the evidence).
    """
    from ..generative.choice_map import ChoiceMap
    from ..kernels.model_interface import ColumnPacker, column_logdensity

    if constraint is None:
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    joint_cols = column_logdensity(model, constraint, args, packer)
    n_pad = packer.padded_dim - packer.dim

    def prior_one(q):
        latents = packer.unpack(q)
        # weight of generate == log prior density of the constrained
        # (latent) addresses; obs addresses are sampled and not counted
        _, w = model.generate(jr.key(0), latents, args)
        if n_pad:
            w = w - 0.5 * jnp.sum(q[packer.dim :] ** 2)
        return w

    prior_cols = jax.vmap(prior_one, in_axes=1)

    def lik_cols(q):
        return joint_cols(q) - prior_cols(q)

    def sample_prior(k, n):
        def init_one(kk):
            k_tr, k_pad = jr.split(kk)
            tr, _ = model.generate(k_tr, constraint, args)
            q = packer.pack(tr.get_choices())
            if n_pad:
                q = q.at[packer.dim :].set(jr.normal(k_pad, (n_pad,)))
            return q

        return jax.vmap(init_one, out_axes=1)(jr.split(k, n))

    result = nested_sampling(
        sample_prior,
        prior_cols,
        lik_cols,
        key,
        n_live=n_live,
        n_iter=n_iter,
        n_mcmc=n_mcmc,
        n_runs=n_runs,
        step_scale=step_scale,
    )
    return result, packer
