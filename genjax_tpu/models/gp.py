"""Gaussian-process regression (exact conjugate answers throughout).

No reference counterpart (the reference ships no model zoo —
`/root/reference/docs/cookbook/` notebooks only; SURVEY.md §1). A GP is the canonical matmul workload in a PPL: the
kernel Gram matrix, its Cholesky factor, and the triangular solves are all
dense (N, N) linear algebra that XLA tiles straight onto the systolic
array, and vmapping chains over hyperparameter candidates batches them.

Two entry points:

- :func:`gp_regression` — a ``@gen`` model with log-amplitude /
  log-lengthscale / log-noise latents whose likelihood is the EXACT GP
  marginal (latent function values integrated out analytically via
  ``mv_normal``), so MCMC over the hyperparameters targets the true
  hyperparameter posterior with no latent-space mixing cost.
- :func:`gp_posterior` — the closed-form predictive ``(mean, cov)`` at test
  points given hyperparameters, for validating inference end-to-end.

Kernel: squared exponential ``k(x, x') = amp² · exp(−‖x−x'‖²/(2ℓ²))``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lang.static_lang import gen


def _as_points(x):
    """Normalize inputs to (N, D): a 1-D array is N scalar points, not one
    N-dimensional point (the `atleast_2d` reading — which would silently
    build a 1-observation model — is never what a user means here)."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim <= 1:
        return x.reshape(-1, 1)
    return x


def sq_exp_kernel(x1, x2, amplitude, lengthscale):
    """Squared-exponential Gram matrix between row-sets ``x1 (N, D)`` and
    ``x2 (M, D)`` (1-D inputs are treated as N scalar points) — one matmul
    for the cross terms (a matmul) plus rank-1 corrections."""
    x1 = _as_points(x1)
    x2 = _as_points(x2)
    sq1 = jnp.sum(x1**2, axis=1)[:, None]
    sq2 = jnp.sum(x2**2, axis=1)[None, :]
    d2 = sq1 + sq2 - 2.0 * (x1 @ x2.T)
    return amplitude**2 * jnp.exp(-0.5 * jnp.maximum(d2, 0.0) / lengthscale**2)


def gp_regression(X, *, jitter: float = 1e-5):
    """``log_amp, log_ls, log_noise ~ N(0, 1)``; ``y ~ N(0, K + σ²I)`` with
    the function values marginalized exactly. Addresses: ``"log_amp"``,
    ``"log_ls"``, ``"log_noise"``, ``"y"``.

    Returns the ``@gen`` model; pair with :func:`gp_posterior` /
    :func:`gp_log_marginal` for exact checks.
    """
    from ..dists import mv_normal, normal

    X = _as_points(X)
    n = X.shape[0]

    @gen
    def model():
        log_amp = normal(0.0, 1.0) @ "log_amp"
        log_ls = normal(0.0, 1.0) @ "log_ls"
        log_noise = normal(0.0, 1.0) @ "log_noise"
        K = sq_exp_kernel(X, X, jnp.exp(log_amp), jnp.exp(log_ls))
        cov = K + (jnp.exp(2.0 * log_noise) + jitter) * jnp.eye(n)
        y = mv_normal(jnp.zeros(n), cov) @ "y"
        return y

    return model


def gp_log_marginal(X, y, amplitude, lengthscale, noise, *, jitter=1e-5):
    """Exact log marginal likelihood log N(y | 0, K + σ²I): ONE Cholesky
    factorization, reused for both the quadratic form and the
    log-determinant."""
    from jax.scipy.linalg import cho_solve

    X = _as_points(X)
    y = jnp.asarray(y, jnp.float32)
    n = X.shape[0]
    cov = sq_exp_kernel(X, X, amplitude, lengthscale) + (
        noise**2 + jitter
    ) * jnp.eye(n)
    chol = jnp.linalg.cholesky(cov)
    alpha = cho_solve((chol, True), y)
    return (
        -0.5 * y @ alpha
        - jnp.sum(jnp.log(jnp.diag(chol)))
        - 0.5 * n * jnp.log(2.0 * jnp.pi)
    )


def gp_posterior(
    X, y, X_test, amplitude, lengthscale, noise, *, jitter: float = 1e-5
):
    """Closed-form GP predictive at ``X_test``: returns ``(mean, cov)`` of
    the noise-free function values f* | y. K is factorized ONCE and the
    factor reused for both solves."""
    from jax.scipy.linalg import cho_solve

    X = _as_points(X)
    X_test = _as_points(X_test)
    y = jnp.asarray(y, jnp.float32)
    n = X.shape[0]
    K = sq_exp_kernel(X, X, amplitude, lengthscale) + (
        noise**2 + jitter
    ) * jnp.eye(n)
    Ks = sq_exp_kernel(X_test, X, amplitude, lengthscale)
    Kss = sq_exp_kernel(X_test, X_test, amplitude, lengthscale)
    chol = jnp.linalg.cholesky(K)
    mean = Ks @ cho_solve((chol, True), y)
    cov = Kss - Ks @ cho_solve((chol, True), Ks.T)
    return mean, cov


def gp_classify_laplace(
    X, y01, amplitude, lengthscale, *, jitter: float = 1e-5, n_newton: int = 20
):
    """Laplace approximation for GP BINARY classification (Rasmussen &
    Williams 2006, Algorithm 3.1): logistic likelihood, Newton iterations
    to the posterior mode of the latent function values, Gaussian
    curvature around it. Returns ``(f_hat (N,), cov (N, N),
    log_marginal_approx)``; pair with :func:`gp_classify_predict` for test
    points — and with ``kernels.elliptical.ess_sweep_cols`` for EXACT
    latent posterior sampling to audit the approximation."""
    import jax

    X = _as_points(X)
    y = jnp.asarray(y01, jnp.float32)
    n = X.shape[0]
    K = sq_exp_kernel(X, X, amplitude, lengthscale) + jitter * jnp.eye(n)

    def newton_step(f, _):
        pi = jax.nn.sigmoid(f)
        W = pi * (1.0 - pi)  # Hessian diag of -log lik
        grad = y - pi
        # (K^-1 + W)^-1 (W f + grad) via the stabilized B-form (RW 3.26)
        sw = jnp.sqrt(W)
        B = jnp.eye(n) + sw[:, None] * K * sw[None, :]
        L = jnp.linalg.cholesky(B)
        b = W * f + grad
        a = b - sw * jax.scipy.linalg.cho_solve(
            (L, True), sw * (K @ b)
        )
        return K @ a, None

    f_hat, _ = jax.lax.scan(newton_step, jnp.zeros(n), None, length=n_newton)
    pi = jax.nn.sigmoid(f_hat)
    W = pi * (1.0 - pi)
    sw = jnp.sqrt(W)
    B = jnp.eye(n) + sw[:, None] * K * sw[None, :]
    L = jnp.linalg.cholesky(B)
    # posterior covariance (K^-1 + W)^-1 = K - K sw B^-1 sw K
    V = jax.scipy.linalg.solve_triangular(L, sw[:, None] * K, lower=True)
    cov = K - V.T @ V
    # approximate log marginal (RW 3.32)
    a = jnp.linalg.solve(K, f_hat)
    log_lik = jnp.sum(y * f_hat - jnp.logaddexp(0.0, f_hat))
    lml = (
        -0.5 * f_hat @ a
        + log_lik
        - jnp.sum(jnp.log(jnp.diag(L)))
    )
    return f_hat, cov, lml


def gp_classify_predict(
    X, y01, X_test, amplitude, lengthscale, *, jitter: float = 1e-5
):
    """Predictive class probabilities at ``X_test`` under the Laplace
    approximation, with the probit-style moderation integral approximated
    by MacKay's kappa correction."""
    import jax

    f_hat, cov, _ = gp_classify_laplace(
        X, y01, amplitude, lengthscale, jitter=jitter
    )
    X = _as_points(X)
    X_test = _as_points(X_test)
    y = jnp.asarray(y01, jnp.float32)
    n = X.shape[0]
    K = sq_exp_kernel(X, X, amplitude, lengthscale) + jitter * jnp.eye(n)
    Ks = sq_exp_kernel(X_test, X, amplitude, lengthscale)
    Kss_diag = amplitude**2 * jnp.ones(X_test.shape[0])
    pi = jax.nn.sigmoid(f_hat)
    mean_star = Ks @ (y - pi)  # RW 3.21: K_*^T (y - pi) at the mode
    # var via the B-form
    W = pi * (1.0 - pi)
    sw = jnp.sqrt(W)
    B = jnp.eye(n) + sw[:, None] * K * sw[None, :]
    L = jnp.linalg.cholesky(B)
    v = jax.scipy.linalg.solve_triangular(
        L, sw[:, None] * Ks.T, lower=True
    )
    var_star = Kss_diag - jnp.sum(v * v, axis=0)
    kappa = 1.0 / jnp.sqrt(1.0 + jnp.pi * var_star / 8.0)
    return jax.nn.sigmoid(kappa * mean_star), mean_star, var_star
