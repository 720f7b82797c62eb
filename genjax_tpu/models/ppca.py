"""Probabilistic PCA (Tipping & Bishop 1999) — exact answers throughout.

No reference counterpart (the reference ships no model zoo —
`/root/reference/docs/cookbook/` notebooks only; SURVEY.md §1). PPCA is the canonical linear latent-variable family:

    z ~ N(0, I_q);  x | z ~ N(W z + mu, sigma² I_d)
    ⇒ x ~ N(mu, W Wᵀ + sigma² I_d)        (marginal, exact)

Everything about it is closed-form — the ML solution is an
eigendecomposition of the sample covariance (W_ML spans the top-q
principal subspace), the posterior over latents is Gaussian, and EM has
exact M-steps — which makes it the strongest possible testbed for the
framework's gradient samplers and VI on a multivariate latent model: every
approximate answer can be judged against the spectral solution.

Notes: the ML path is one (d, d) eigendecomposition plus matmuls; the
batched log-likelihood evaluates the marginal MVN density with one shared
Cholesky across the data batch (matmul-bound for large d).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..lang.static_lang import gen

_LOG_2PI = 1.8378770664093453


def ppca_model(W, mu, sigma):
    """The ``@gen`` generative model for one observation: addresses
    ``"z"`` (latent, q-dim) and ``"x"`` (observed, d-dim). ``vmap``/
    ``repeat`` it for a dataset."""
    from ..dists import mv_normal_diag

    W = jnp.asarray(W, jnp.float32)
    d, q = W.shape

    @gen
    def model():
        z = mv_normal_diag(jnp.zeros(q), jnp.ones(q)) @ "z"
        x = mv_normal_diag(W @ z + mu, sigma * jnp.ones(d)) @ "x"
        return x

    return model


def ppca_log_likelihood(X, W, mu, sigma2):
    """Exact marginal ``Σ_n log N(x_n; mu, W Wᵀ + σ² I)`` with one shared
    Cholesky."""
    X = jnp.asarray(X, jnp.float32)
    d = X.shape[1]
    cov = W @ W.T + sigma2 * jnp.eye(d)
    chol = jnp.linalg.cholesky(cov)
    resid = jax.scipy.linalg.solve_triangular(
        chol, (X - mu).T, lower=True
    )  # (d, n)
    n = X.shape[0]
    return (
        -0.5 * jnp.sum(resid**2)
        - n * jnp.sum(jnp.log(jnp.diag(chol)))
        - 0.5 * n * d * _LOG_2PI
    )


def ppca_ml(X, q: int):
    """Exact maximum-likelihood PPCA fit (Tipping & Bishop 1999 §3.2):
    eigendecompose the sample covariance; ``σ²_ML`` is the mean discarded
    eigenvalue and ``W_ML = U_q (Λ_q − σ² I)^{1/2}``. Returns
    ``(W, mu, sigma2)``."""
    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape
    mu = jnp.mean(X, axis=0)
    S = (X - mu).T @ (X - mu) / n
    evals, evecs = jnp.linalg.eigh(S)  # ascending
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    sigma2 = jnp.mean(evals[q:]) if q < d else jnp.asarray(0.0)
    W = evecs[:, :q] * jnp.sqrt(jnp.maximum(evals[:q] - sigma2, 0.0))
    return W, mu, sigma2


def ppca_posterior(x, W, mu, sigma2):
    """Exact latent posterior ``z | x ~ N(M⁻¹ Wᵀ (x − mu), σ² M⁻¹)`` with
    ``M = Wᵀ W + σ² I`` (Tipping & Bishop eq. 8). Returns ``(mean, cov)``."""
    q = W.shape[1]
    M = W.T @ W + sigma2 * jnp.eye(q)
    mean = jnp.linalg.solve(M, W.T @ (x - mu))
    cov = sigma2 * jnp.linalg.inv(M)
    return mean, cov


def ppca_em(X, q: int, *, n_iters: int = 50):
    """EM for PPCA (Tipping & Bishop §3.3) — converges to the spectral ML
    solution. Returns ``((W, mu, sigma2), log_likelihoods (n_iters,))``
    with the trace evaluated at the START of each iteration (monotone)."""
    from jax import lax

    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape
    mu = jnp.mean(X, axis=0)
    Xc = X - mu
    S = Xc.T @ Xc / n

    def one_iter(state, _):
        W, sigma2 = state
        ll = ppca_log_likelihood(X, W, mu, sigma2)
        M = W.T @ W + sigma2 * jnp.eye(q)
        # E-step in moment form: SW = S W; M-step (eqs 29-30)
        SW = S @ W
        inner = sigma2 * jnp.eye(q) + jnp.linalg.solve(M, W.T @ SW)
        W_new = jnp.linalg.solve(inner.T, SW.T).T
        # σ²_new = tr(S − S W M⁻¹ W_newᵀ) / d   (eq. 30)
        sigma2_new = jnp.trace(S - SW @ jnp.linalg.solve(M, W_new.T)) / d
        return (W_new, jnp.maximum(sigma2_new, 1e-8)), ll

    key_init = jnp.eye(d)[:, :q] * 0.5 + 0.01
    (W, sigma2), lls = lax.scan(
        one_iter, (key_init, jnp.asarray(1.0)), None, length=n_iters
    )
    return (W, mu, sigma2), lls
