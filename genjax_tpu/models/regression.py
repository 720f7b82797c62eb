"""Bayesian regression families (BASELINE config: "Bayesian linear/
hierarchical regression via NUTS, 1k-64k parallel chains")."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..lang.static_lang import gen


def _xw(X, w):
    """``X @ w`` at full float32 precision. At the default precision a GPU
    may run it in TF32, and the log-likelihood sums one rounded residual
    per row: at 10,000 rows that moved the log-joint by over a nat."""
    return jnp.dot(X, w, precision=jax.lax.Precision.HIGHEST)


def linear_regression(X, *, obs_scale: float = 0.25, prior_scale: float = 1.0):
    """``w ~ N(0, prior_scale); y ~ N(X @ w, obs_scale)``.

    Returns ``(model, exact_posterior)`` where ``exact_posterior(y)`` gives
    the conjugate ``(mean, covariance)`` of ``w | y``.
    """
    from ..dists import mv_normal_diag

    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape

    @gen
    def model():
        w = mv_normal_diag(jnp.zeros(d), prior_scale * jnp.ones(d)) @ "w"
        y = mv_normal_diag(_xw(X, w), obs_scale * jnp.ones(n)) @ "y"
        return y

    def exact_posterior(y):
        y = jnp.asarray(y)
        prec = jnp.eye(d) / prior_scale**2 + (X.T @ X) / obs_scale**2
        cov = jnp.linalg.inv(prec)
        mean = cov @ (X.T @ y) / obs_scale**2
        return mean, cov

    return model, exact_posterior


def hierarchical_regression(X, *, obs_scale: float = 0.25):
    """The flagship benchmark model: ``tau ~ LogNormal(0, 0.5)``,
    ``w ~ N(0, tau)``, ``y ~ N(X @ w, obs_scale)``. Addresses: ``tau``,
    ``w``, ``y``."""
    from ..dists import log_normal, mv_normal_diag

    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape

    @gen
    def model():
        tau = log_normal(0.0, 0.5) @ "tau"
        w = mv_normal_diag(jnp.zeros(d), tau * jnp.ones(d)) @ "w"
        y = mv_normal_diag(_xw(X, w), obs_scale * jnp.ones(n)) @ "y"
        return y

    return model


def logistic_regression(X, *, prior_scale: float = 2.0):
    """Bayesian logistic regression: ``w ~ N(0, prior_scale)``,
    ``y_i ~ Bernoulli(sigmoid(x_i . w))``. Addresses: ``"w"`` and
    ``("obs", i, "y")`` — one flip per data point through a vmapped
    observation model; constrain with ``C["obs", :, "y"].set(y01)``.

    Returns ``model`` (no conjugate posterior; validate with MCMC vs a
    long-chain reference or posterior-predictive checks)."""
    import jax
    import jax.numpy as jnp

    from ..dists import flip, mv_normal_diag

    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape

    # defined OUTSIDE the model body: an inner @gen would mint a fresh
    # Closure every handler run, destabilizing trace treedefs (mh_accept's
    # where-select needs old/new traces with identical static structure)
    @gen
    def obs_point(i, probs):
        return flip(probs[i]) @ "y"

    obs_vmap = obs_point.vmap(in_axes=(0, None))

    @gen
    def model():
        w = mv_normal_diag(jnp.zeros(d), prior_scale * jnp.ones(d)) @ "w"
        probs = jax.nn.sigmoid(X @ w)
        _ = obs_vmap(jnp.arange(n), probs) @ "obs"
        return probs

    return model


def poisson_regression(X, *, prior_scale: float = 1.0):
    """Poisson GLM: ``w ~ N(0, prior_scale)``,
    ``y_i ~ Poisson(exp(x_i . w))``. Addresses: ``"w"`` and
    ``("obs", i, "y")``; constrain with ``C["obs", :, "y"].set(counts)``.

    Returns ``model`` (no conjugate posterior; the log-posterior is
    strictly concave, so ``laplace_approximation`` is the standard
    validation reference — see tests/models/test_glm.py)."""
    from ..dists import mv_normal_diag, poisson

    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape

    # outside the body for treedef stability (see logistic_regression)
    @gen
    def obs_point(i, rates):
        return poisson(rates[i]) @ "y"

    obs_vmap = obs_point.vmap(in_axes=(0, None))

    @gen
    def model():
        w = mv_normal_diag(jnp.zeros(d), prior_scale * jnp.ones(d)) @ "w"
        rates = jnp.exp(X @ w)
        _ = obs_vmap(jnp.arange(n), rates) @ "obs"
        return rates

    return model
