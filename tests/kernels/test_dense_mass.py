"""Dense mass-matrix HMC (kernels/dense_mass.py) vs exact correlated
Gaussians: moment exactness, covariance-estimator recovery, and the
preconditioning benefit over a diagonal metric that motivates the kernel."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_tpu.kernels.dense_mass import (
    cross_chain_cov,
    hmc_sweep_dense_cols,
    warmup_column_dense,
)

N_CHAINS = 2048


def _correlated_target(rho=0.9, scales=(1.0, 0.3, 0.1)):
    """N(mu*, Sigma*) with constant correlation rho and given scales."""
    d = len(scales)
    corr = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    s = np.diag(scales)
    sigma = (s @ corr @ s).astype(np.float64)
    mu = np.linspace(-1.0, 1.0, d).astype(np.float32)
    prec = np.linalg.inv(sigma).astype(np.float32)

    def ld(q):
        r = q - jnp.asarray(mu)[:, None]
        return -0.5 * jnp.sum(r * (jnp.asarray(prec) @ r), axis=0)

    return ld, mu, sigma.astype(np.float32)


class TestCrossChainCov:
    def test_recovers_known_covariance(self):
        rng = np.random.RandomState(0)
        _, _, sigma = _correlated_target()
        chol = np.linalg.cholesky(sigma)
        q = jnp.asarray(chol @ rng.randn(3, 8192), jnp.float32)
        est = np.asarray(cross_chain_cov(q, shrinkage=0.0))
        np.testing.assert_allclose(est, sigma, atol=0.05)

    def test_shrinkage_preserves_diagonal(self):
        rng = np.random.RandomState(1)
        _, _, sigma = _correlated_target()
        chol = np.linalg.cholesky(sigma)
        q = jnp.asarray(chol @ rng.randn(3, 8192), jnp.float32)
        full = np.asarray(cross_chain_cov(q, shrinkage=0.0, jitter=0.0))
        shrunk = np.asarray(cross_chain_cov(q, shrinkage=0.5, jitter=0.0))
        np.testing.assert_allclose(
            np.diag(shrunk), np.diag(full), rtol=1e-5
        )
        # off-diagonals scaled by (1 - shrinkage)
        off = ~np.eye(3, dtype=bool)
        np.testing.assert_allclose(
            shrunk[off], 0.5 * full[off], rtol=1e-5
        )

    def test_singular_cloud_stays_choleskyable(self):
        """N < D: the raw sample covariance is singular; shrinkage +
        jitter must keep the Cholesky finite."""
        rng = np.random.RandomState(2)
        q = jnp.asarray(rng.randn(8, 4), jnp.float32)  # D=8 > N=4
        cov = cross_chain_cov(q, shrinkage=0.3)
        chol = np.asarray(jnp.linalg.cholesky(cov))
        assert np.isfinite(chol).all()


class TestDenseMassExactness:
    def test_posterior_moments_with_true_metric(self):
        """With cov_chol = chol(Sigma*), the sweep must reproduce the
        target's mean and FULL covariance."""
        ld, mu, sigma = _correlated_target()
        chol = jnp.asarray(np.linalg.cholesky(sigma))
        q0 = jnp.zeros((3, N_CHAINS), jnp.float32)
        q, acc = jax.jit(
            lambda: hmc_sweep_dense_cols(
                ld, q0, 0, n_steps=300, eps=0.8, L=4, cov_chol=chol
            )
        )()
        draws = np.asarray(q)
        # the dense metric makes the target locally isotropic: near-unit
        # step size on a rho=0.9, 10x-anisotropic target still accepts
        assert float(acc) > 0.6, float(acc)
        np.testing.assert_allclose(draws.mean(axis=1), mu, atol=0.05)
        np.testing.assert_allclose(np.cov(draws), sigma, atol=0.06)

    def test_warmup_recovers_metric_and_samples(self):
        """warmup_column_dense from an isotropic start: the adapted
        cov_chol must recover Sigma* and the post-warmup sweep must be
        exact."""
        ld, mu, sigma = _correlated_target(rho=0.85, scales=(1.0, 0.2))
        q0 = jnp.asarray(
            np.random.RandomState(3).randn(2, N_CHAINS), np.float32
        )
        q, eps, cov_chol = warmup_column_dense(
            ld, q0, 7, n_phases=8, steps_per_phase=30, eps0=0.1, L=4,
            shrinkage=0.05,
        )
        est = np.asarray(cov_chol @ cov_chol.T)
        # estimated metric ~ target covariance (shrinkage biases the
        # off-diagonal down by ~5%)
        np.testing.assert_allclose(est, sigma, rtol=0.35, atol=0.05)
        q, acc = jax.jit(
            lambda q: hmc_sweep_dense_cols(
                ld, q, 11, n_steps=200, eps=float(eps), L=4,
                cov_chol=cov_chol,
            )
        )(q)
        draws = np.asarray(q)
        assert float(acc) > 0.5
        np.testing.assert_allclose(draws.mean(axis=1), mu[:2], atol=0.05)
        np.testing.assert_allclose(np.cov(draws), sigma, atol=0.05)

    def test_dense_beats_diagonal_on_correlated_target(self):
        """The motivating comparison: at the SAME step size, the dense
        metric accepts where the diagonal metric (identity here — the
        per-dim scales are equal) collapses. rho=0.99 caps the diagonal
        conditional scale at sqrt(1-rho^2) ~ 0.14 of the marginal."""
        ld, _, sigma = _correlated_target(rho=0.99, scales=(1.0, 1.0))
        chol = jnp.asarray(np.linalg.cholesky(sigma))
        q0 = jnp.asarray(
            np.linalg.cholesky(sigma) @ np.random.RandomState(4).randn(
                2, 512
            ),
            jnp.float32,
        )
        _, acc_dense = jax.jit(
            lambda: hmc_sweep_dense_cols(
                ld, q0, 1, n_steps=50, eps=0.9, L=4, cov_chol=chol
            )
        )()
        # identity metric = diagonal metric with the (equal) marginal
        # scales; same eps
        _, acc_diag = jax.jit(
            lambda: hmc_sweep_dense_cols(
                ld, q0, 1, n_steps=50, eps=0.9, L=4,
                cov_chol=jnp.eye(2),
            )
        )()
        assert float(acc_dense) > 0.6, float(acc_dense)
        assert float(acc_diag) < 0.25, float(acc_diag)


class TestColumnBridgeDense:
    def test_gen_model_correlated_posterior_exact(self):
        """@gen linear regression with near-collinear design: the w
        posterior is a strongly correlated Gaussian with a closed form;
        column_hmc(mass='dense', warmup=True) must recover it."""
        import genjax_tpu as g
        from genjax_tpu.kernels import column_hmc

        rng = np.random.RandomState(0)
        n_obs, s2 = 32, 0.25
        x1 = rng.randn(n_obs)
        X = np.stack([x1, x1 + 0.15 * rng.randn(n_obs)], axis=1).astype(
            np.float32
        )
        w_true = np.asarray([1.0, -0.5], np.float32)
        y = (X @ w_true + np.sqrt(s2) * rng.randn(n_obs)).astype(np.float32)

        prec_post = np.eye(2) + X.T @ X / s2
        cov_post = np.linalg.inv(prec_post)
        mean_post = cov_post @ (X.T @ y) / s2
        rho = cov_post[0, 1] / np.sqrt(cov_post[0, 0] * cov_post[1, 1])
        assert abs(rho) > 0.9  # the regime a diagonal metric cannot serve

        @g.gen
        def model():
            w = g.mv_normal_diag(jnp.zeros(2), jnp.ones(2)) @ "w"
            _ = g.mv_normal_diag(
                jnp.asarray(X) @ w, jnp.full(n_obs, float(np.sqrt(s2)))
            ) @ "y"

        q, accept, packer = column_hmc(
            model,
            g.C["y"].set(jnp.asarray(y)),
            (),
            ["w"],
            n_chains=1024,
            n_steps=300,
            eps=0.3,
            L=4,
            warmup=True,
            mass="dense",
        )
        assert float(accept) > 0.5, float(accept)
        draws = np.asarray(q[:2])  # first two packed dims = w
        np.testing.assert_allclose(draws.mean(axis=1), mean_post, atol=0.05)
        np.testing.assert_allclose(np.cov(draws), cov_post, atol=0.03)


class TestWhitening:
    def test_nuts_gains_dense_metric_via_whitening(self):
        """NUTS has no dense-metric form here; whitening gives it one.
        On a rho=0.99 target the whitened chain needs FAR fewer
        leapfrogs per transition and still matches the exact law."""
        from genjax_tpu.kernels.dense_mass import whiten_logdensity
        from genjax_tpu.kernels.nuts import nuts_sweep_cols

        ld, mu, sigma = _correlated_target(rho=0.99, scales=(1.0, 1.0))
        chol = jnp.asarray(np.linalg.cholesky(sigma))
        white_ld, whiten, unwhiten = whiten_logdensity(
            ld, chol, mean=jnp.asarray(mu)
        )

        # start both from exact draws of the target
        rng = np.random.RandomState(7)
        q0 = jnp.asarray(
            np.linalg.cholesky(sigma) @ rng.randn(2, 1024)
            + mu[:, None],
            jnp.float32,
        )
        u0 = whiten(q0)
        u, _acc, leaps_w = jax.jit(
            lambda u0: nuts_sweep_cols(
                white_ld, u0, 1, n_steps=40, eps=0.9, max_depth=6
            )
        )(u0)
        q = unwhiten(u)
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), mu, atol=0.1)
        np.testing.assert_allclose(np.cov(draws), sigma, atol=0.12)
        # whitened target is isotropic: trajectories terminate in a
        # handful of leapfrogs
        assert float(leaps_w) < 8.0, float(leaps_w)

        _q2, _acc2, leaps_raw = jax.jit(
            lambda q0: nuts_sweep_cols(
                ld, q0, 1, n_steps=10, eps=0.05, max_depth=6
            )
        )(q0)
        # the unwhitened rho=0.99 target needs many more leapfrogs at a
        # step size small enough to integrate the narrow direction
        assert float(leaps_raw) > 2.0 * float(leaps_w), (
            float(leaps_raw), float(leaps_w),
        )

    def test_roundtrip(self):
        from genjax_tpu.kernels.dense_mass import whiten_logdensity

        ld, mu, sigma = _correlated_target()
        chol = jnp.asarray(np.linalg.cholesky(sigma))
        _, whiten, unwhiten = whiten_logdensity(ld, chol, mean=jnp.asarray(mu))
        q = jnp.asarray(np.random.RandomState(0).randn(3, 16), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(unwhiten(whiten(q))), np.asarray(q), atol=1e-5
        )
