"""Elliptical slice sampling vs exact Gaussian posteriors: with a Gaussian
likelihood the target is conjugate, so sample moments must match the
closed form; the GP-latent case cross-checks `models/gp.py.gp_posterior`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_tpu.kernels.elliptical import ess_sweep_cols, ess_transition_cols

N_CHAINS = 2048


class TestConjugateGaussian:
    def test_posterior_moments_exact(self):
        """prior N(0, Sigma), lik N(y | f, s2 I): posterior
        N(C y / s2, C), C = (Sigma^-1 + I/s2)^-1."""
        rng = np.random.RandomState(0)
        D, s2 = 3, 0.25
        A = rng.randn(D, D)
        Sigma = (A @ A.T + D * np.eye(D)).astype(np.float32) / D
        y = rng.randn(D).astype(np.float32)
        C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(D) / s2)
        m_post = C @ y / s2

        chol = jnp.asarray(np.linalg.cholesky(Sigma))

        def ll(q):
            return -0.5 * jnp.sum((q - jnp.asarray(y)[:, None]) ** 2, axis=0) / s2

        q0 = jnp.zeros((D, N_CHAINS), jnp.float32)
        q, _ = jax.jit(
            lambda: ess_sweep_cols(ll, q0, 0, n_steps=200, chol_prior=chol)
        )()
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.06)
        np.testing.assert_allclose(np.cov(draws), C, atol=0.08)

    def test_nonzero_prior_mean(self):
        mu = np.asarray([2.0, -1.0], np.float32)
        s2 = 0.5
        y = np.asarray([1.0, 0.0], np.float32)
        # prior N(mu, I): posterior N((mu + y/s2)/(1+1/s2), I/(1+1/s2))
        v = 1.0 / (1.0 + 1.0 / s2)
        m_post = v * (mu + y / s2)

        def ll(q):
            return -0.5 * jnp.sum((q - jnp.asarray(y)[:, None]) ** 2, axis=0) / s2

        q0 = jnp.tile(jnp.asarray(mu)[:, None], (1, N_CHAINS))
        q, _ = jax.jit(
            lambda: ess_sweep_cols(
                ll, q0, 1, n_steps=150, chol_prior=1.0, mean=mu[:, None]
            )
        )()
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.05)
        np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.12)

    def test_stationarity_one_step(self):
        """Initialize chains with EXACT posterior draws; one ESS transition
        must leave the moments unchanged (detailed-balance smoke test that
        catches bracket/threshold sign errors moments-convergence tests
        can miss)."""
        import jax.random as jr

        rng = np.random.RandomState(5)
        D, s2 = 2, 0.3
        Sigma = np.asarray([[1.0, 0.6], [0.6, 1.0]], np.float32)
        y = np.asarray([0.8, -0.4], np.float32)
        C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(D) / s2)
        m_post = C @ y / s2
        q0 = (
            np.linalg.cholesky(C) @ rng.randn(D, N_CHAINS)
            + m_post[:, None]
        ).astype(np.float32)

        def ll(q):
            return -0.5 * jnp.sum((q - jnp.asarray(y)[:, None]) ** 2, axis=0) / s2

        q1, _ = ess_transition_cols(
            ll,
            jnp.asarray(q0),
            jr.key(7),
            chol_prior=jnp.asarray(np.linalg.cholesky(Sigma)),
        )
        draws = np.asarray(q1)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.05)
        np.testing.assert_allclose(np.cov(draws), C, atol=0.05)

    def test_transition_diagnostics_and_cap_noop(self):
        """max_iters=0 forces the cap: the move must be an exact no-op for
        chains whose very first proposal fails (others may accept)."""
        import jax.random as jr

        def ll(q):
            return -50.0 * jnp.sum(q**2, axis=0)  # sharp: most proposals fail

        q0 = jnp.full((2, 64), 0.05, jnp.float32)
        q1, iters = ess_transition_cols(
            ll, q0, jr.key(0), chol_prior=1.0, max_iters=0
        )
        iters = np.asarray(iters)
        assert iters.shape == (64,) and (iters == 0).all()
        moved = np.any(np.asarray(q1) != np.asarray(q0), axis=0)
        # any chain that moved must have accepted on the first proposal:
        # its new likelihood exceeds its (threshold ≤ current) likelihood
        # is not directly observable here, but no chain may move without
        # the done flag — verify no NaNs and shapes
        assert np.isfinite(np.asarray(q1)).all()
        assert moved.shape == (64,)


class TestGPLatents:
    def test_matches_gp_posterior(self):
        """Latent GP f ~ N(0, K), y = f + noise: the ESS posterior over f
        at the training inputs must match gp_posterior's closed form."""
        from genjax_tpu.models.gp import gp_posterior, sq_exp_kernel

        rng = np.random.RandomState(1)
        X = rng.randn(6, 1).astype(np.float32)
        AMP, LS, NOISE = 1.0, 1.2, 0.4
        K = np.asarray(sq_exp_kernel(X, X, AMP, LS)) + 1e-6 * np.eye(6)
        f_true = rng.multivariate_normal(np.zeros(6), K)
        y = (f_true + NOISE * rng.randn(6)).astype(np.float32)

        mean_exact, cov_exact = gp_posterior(
            X, y, X, AMP, LS, NOISE, jitter=1e-6
        )

        chol = jnp.asarray(np.linalg.cholesky(K))

        def ll(q):
            return (
                -0.5
                * jnp.sum((q - jnp.asarray(y)[:, None]) ** 2, axis=0)
                / NOISE**2
            )

        q0 = jnp.zeros((6, N_CHAINS), jnp.float32)
        q, _ = jax.jit(
            lambda: ess_sweep_cols(ll, q0, 2, n_steps=250, chol_prior=chol)
        )()
        draws = np.asarray(q)
        np.testing.assert_allclose(
            draws.mean(axis=1), np.asarray(mean_exact), atol=0.08
        )
        np.testing.assert_allclose(
            draws.std(axis=1),
            np.sqrt(np.diag(np.asarray(cov_exact))),
            rtol=0.15,
        )


class TestGaussianFastPath:
    """ess_*_gauss_cols: the trig-quadratic O(N)-shrink-loop fast path
    must be the SAME Markov chain as the generic kernel."""

    def test_trajectory_matches_generic(self):
        """Same keys, matching Gaussian likelihood: the fast path and the
        generic path must produce (near-)identical chains — the quadratic
        expansion is algebra, not approximation."""
        from genjax_tpu.kernels.elliptical import ess_sweep_gauss_cols

        rng = np.random.RandomState(3)
        D, s2 = 4, 0.3
        A = rng.randn(D, D)
        Sigma = (A @ A.T + D * np.eye(D)).astype(np.float32) / D
        chol = jnp.asarray(np.linalg.cholesky(Sigma))
        y = rng.randn(D).astype(np.float32)

        def ll(q):
            return (
                -0.5 * jnp.sum((q - jnp.asarray(y)[:, None]) ** 2, axis=0) / s2
            )

        q0 = jnp.asarray(rng.randn(D, 256), jnp.float32)
        q_gen, _ = jax.jit(
            lambda: ess_sweep_cols(ll, q0, 11, n_steps=30, chol_prior=chol)
        )()
        q_fast, _ = jax.jit(
            lambda: ess_sweep_gauss_cols(
                q0, 11, n_steps=30, chol_prior=chol, y=y, prec=1.0 / s2
            )
        )()
        # identical randomness stream -> identical accept/shrink decisions
        # up to float roundoff in the likelihood; a tiny fraction of
        # chains may flip a borderline accept, so compare by quantile
        diff = np.abs(np.asarray(q_gen) - np.asarray(q_fast))
        assert np.quantile(diff, 0.98) < 1e-3, (
            f"fast path diverged from generic: q98={np.quantile(diff, 0.98)}"
        )

    def test_posterior_moments_exact(self):
        from genjax_tpu.kernels.elliptical import ess_sweep_gauss_cols

        rng = np.random.RandomState(4)
        D, s2 = 3, 0.25
        A = rng.randn(D, D)
        Sigma = (A @ A.T + D * np.eye(D)).astype(np.float32) / D
        y = rng.randn(D).astype(np.float32)
        C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(D) / s2)
        m_post = C @ y / s2
        chol = jnp.asarray(np.linalg.cholesky(Sigma))

        q0 = jnp.zeros((D, N_CHAINS), jnp.float32)
        q, _ = jax.jit(
            lambda: ess_sweep_gauss_cols(
                q0, 0, n_steps=200, chol_prior=chol, y=y, prec=1.0 / s2
            )
        )()
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.06)
        np.testing.assert_allclose(np.cov(draws), C, atol=0.08)

    def test_heteroscedastic_and_nonzero_mean(self):
        """Per-dimension precisions + nonzero prior mean: posterior still
        conjugate diag-vs-full; checks the prec/mean broadcasting."""
        from genjax_tpu.kernels.elliptical import ess_sweep_gauss_cols

        mu = np.asarray([1.0, -2.0], np.float32)
        prec = np.asarray([4.0, 0.5], np.float32)  # 1/s2 per dim
        y = np.asarray([0.0, 1.0], np.float32)
        # prior N(mu, I) diag, lik prec diag: posterior precision 1 + prec
        v = 1.0 / (1.0 + prec)
        m_post = v * (mu + prec * y)

        q0 = jnp.tile(jnp.asarray(mu)[:, None], (1, N_CHAINS))
        q, _ = jax.jit(
            lambda: ess_sweep_gauss_cols(
                q0, 9, n_steps=150, chol_prior=1.0, y=y, prec=prec,
                mean=mu[:, None],
            )
        )()
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.05)
        np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.15)


class TestGaussianFastPathPriors:
    """``ess_sweep_gauss_cols`` with every prior-factor form it accepts,
    over chain batches of any size, against the conjugate closed form
    (prior N(0, diag(sd^2)), likelihood N(y | f, s2 I))."""

    @pytest.mark.parametrize(
        "prior", ["scalar_sd", "vector_sd", "diag_cholesky"]
    )
    def test_diagonal_prior_forms(self, prior):
        from genjax_tpu.kernels.elliptical import ess_sweep_gauss_cols

        s2 = 0.5
        sd = np.asarray([1.0, 1.0], np.float32)
        if prior == "vector_sd":
            sd = np.asarray([0.5, 2.0], np.float32)
        chol_prior = {
            "scalar_sd": 1.0,
            "vector_sd": sd,
            "diag_cholesky": np.diag(sd),
        }[prior]
        y = np.asarray([1.0, -1.0], np.float32)
        v = 1.0 / (1.0 / sd**2 + 1.0 / s2)
        m_post = v * y / s2

        q0 = jnp.zeros((2, 1024), jnp.float32)
        q, _ = ess_sweep_gauss_cols(
            q0, 3, n_steps=200, chol_prior=chol_prior, y=y, prec=1.0 / s2,
        )
        draws = np.asarray(q)
        np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.08)
        np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.2)

    @pytest.mark.parametrize("n_chains", [1, 777, 2 * 1024])
    def test_chain_blocks_of_any_size(self, n_chains):
        """No blocking constraint on the chain count; each column is an
        independent chain, so two halves of one batch are two
        independent samples (they differ)."""
        from genjax_tpu.kernels.elliptical import ess_sweep_gauss_cols

        y = np.asarray([0.5, -0.5, 1.0], np.float32)
        q0 = jnp.zeros((3, n_chains), jnp.float32)
        q, draws = ess_sweep_gauss_cols(
            q0, 5, n_steps=50, chol_prior=1.0, y=y, prec=2.0, collect=True,
        )
        assert q.shape == (3, n_chains)
        assert draws.shape == (50, 3, n_chains)
        assert bool(jnp.all(jnp.isfinite(q)))
        np.testing.assert_array_equal(np.asarray(draws[-1]), np.asarray(q))
        if n_chains >= 2 * 1024:
            half = n_chains // 2
            assert not np.allclose(q[:, :half], q[:, half:])
            v = 1.0 / (1.0 + 2.0)
            np.testing.assert_allclose(
                np.asarray(q).mean(axis=1), v * 2.0 * y, atol=0.06
            )
