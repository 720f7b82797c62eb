"""Model-family smoke + exactness tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_tpu as g
from genjax_tpu.models import (
    discrete_hmm_model,
    dp_mixture_model,
    gaussian_mixture_model,
    hierarchical_regression,
    linear_gaussian_ssm,
    linear_regression,
    stochastic_volatility,
)
from genjax_tpu.dists.discrete_hmm import DiscreteHMM, DiscreteHMMConfiguration

KEY = jax.random.key(0)


class TestRegression:
    def test_linear_regression_posterior_vs_exact(self):
        X = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
        model, exact_posterior = linear_regression(X)
        y = jnp.asarray(
            X @ np.array([1.0, -0.5, 0.2], np.float32)
            + 0.1 * np.random.default_rng(1).normal(size=12).astype(np.float32)
        )
        mean, cov = exact_posterior(y)
        from genjax_tpu.kernels import column_hmc

        q, acc, packer = column_hmc(
            model, g.C["y"].set(y), (), ["w"],
            n_chains=2048, n_steps=200, eps=0.05, L=5,
        )
        emp_mean = jnp.mean(q[:3, :], axis=1)
        assert jnp.allclose(emp_mean, mean, atol=0.1)
        emp_std = jnp.std(q[:3, :], axis=1)
        assert jnp.allclose(emp_std, jnp.sqrt(jnp.diag(cov)), atol=0.05)

    def test_hierarchical_regression_runs(self):
        X = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
        model = hierarchical_regression(X)
        tr = model.simulate(KEY, ())
        assert jnp.isfinite(tr.get_score())


class TestSSM:
    def test_lgss_pf_matches_kalman(self):
        from genjax_tpu.parallel import SSMParticleFilter

        kernel, exact = linear_gaussian_ssm()
        T = 15
        ys = jnp.sin(jnp.linspace(0, 3, T))
        pf = SSMParticleFilter(kernel, n_particles=4096)
        res = pf.run(KEY, 0.0, jnp.zeros(T), g.C[:, "y"].set(ys))
        assert res.log_marginal == pytest.approx(exact(ys), abs=0.1)

    def test_stochastic_volatility_pf(self):
        from genjax_tpu.parallel import SSMParticleFilter

        kernel = stochastic_volatility()
        T = 20
        sim = kernel.scan().simulate(KEY, (-1.0, jnp.zeros(T)))
        ys = jnp.asarray([sim.get_choices()[t, "y"] for t in range(T)])
        pf = SSMParticleFilter(kernel, n_particles=4096)
        res = pf.run(KEY, -1.0, jnp.zeros(T), g.C[:, "y"].set(ys))
        assert jnp.isfinite(res.log_marginal)
        assert float(res.ess_history[-1]) > 100


class TestMixtures:
    def test_gmm_simulates_and_assesses(self):
        model = gaussian_mixture_model(3)
        data = jnp.zeros(10)
        tr = model.simulate(KEY, (data,))
        score, _ = model.assess(tr.get_choices(), (data,))
        assert score == pytest.approx(float(tr.get_score()), rel=1e-5)

    def test_dp_mixture_matches_example_model(self):
        model = dp_mixture_model(6)
        data = jnp.array([-2.0, -2.1, 2.0, 2.2])
        tr, w = model.generate(KEY, g.C["obs", :, "x"].set(data), (data,))
        assert jnp.isfinite(w)


class TestHMM:
    def test_hmm_model_consistent_with_exact(self):
        config = DiscreteHMMConfiguration(4, 1, 1, 0.5, 0.5)
        chain, _ = discrete_hmm_model(config, 5)
        init = config.linear_grid_dim // 2
        tr = chain.simulate(KEY, (init, jnp.zeros(5)))
        xs = jnp.asarray([tr.get_choices()[t, "x"] for t in range(5)])
        logZ = DiscreteHMM.data_logpdf(config, xs)
        obs = g.C[:, "x"].set(xs)
        alg = g.ImportanceK(g.Target(chain, (init, jnp.zeros(5)), obs), k_particles=3000)
        est = jax.jit(alg.run_smc)(KEY).get_log_marginal_likelihood_estimate()
        assert est == pytest.approx(logZ, abs=0.15)


class TestLogisticRegression:
    @pytest.mark.slow
    def test_posterior_separates_classes(self):
        from genjax_tpu.models import logistic_regression
        from genjax_tpu.kernels import column_hmc

        rng = np.random.default_rng(0)
        X = rng.normal(size=(40, 2)).astype(np.float32)
        w_true = np.array([2.0, -1.5], np.float32)
        probs = 1.0 / (1.0 + np.exp(-(X @ w_true)))
        y = (rng.uniform(size=40) < probs).astype(np.int32)

        model = logistic_regression(X)
        obs = g.C["obs", :, "y"].set(jnp.asarray(y))
        q, acc, packer = column_hmc(
            model, obs, (), ["w"],
            n_chains=1024, n_steps=500, eps=0.08, L=5,
        )
        w_mean = jnp.mean(q[:2, :], axis=1)
        # posterior mean points in the direction of the true weights
        cos = jnp.dot(w_mean, w_true) / (
            jnp.linalg.norm(w_mean) * np.linalg.norm(w_true)
        )
        # direction recovery with finite-sample slack (0.947 observed with
        # the rbg PRNG stream; the bound guards sign/major-direction errors,
        # not Monte-Carlo wiggle)
        assert float(cos) > 0.9
        assert float(acc) > 0.5
