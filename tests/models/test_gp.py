"""GP regression model family: every check is against exact linear-algebra
closed forms (joint-Gaussian conditioning done independently in numpy)."""

import pytest

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax.scipy.stats import norm

import genjax_tpu as g
from genjax_tpu.models.gp import (
    gp_log_marginal,
    gp_posterior,
    gp_regression,
    sq_exp_kernel,
)

RNG = np.random.RandomState(0)
X = RNG.randn(12, 2).astype(np.float32)
XT = RNG.randn(5, 2).astype(np.float32)
AMP, LS, NOISE = 1.3, 0.9, 0.3
JITTER = 1e-5


def np_kernel(a, b):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return AMP**2 * np.exp(-0.5 * d2 / LS**2)


Y = RNG.multivariate_normal(
    np.zeros(len(X)), np_kernel(X, X) + NOISE**2 * np.eye(len(X))
).astype(np.float32)


class TestClosedForms:
    def test_kernel_matches_numpy(self):
        np.testing.assert_allclose(
            np.asarray(sq_exp_kernel(X, XT, AMP, LS)),
            np_kernel(X, XT),
            rtol=1e-4,
            atol=1e-5,
        )

    def test_log_marginal_matches_numpy_mvn(self):
        cov = np_kernel(X, X) + (NOISE**2 + JITTER) * np.eye(len(X))
        sign, logdet = np.linalg.slogdet(cov)
        expected = (
            -0.5 * Y @ np.linalg.solve(cov, Y)
            - 0.5 * logdet
            - 0.5 * len(X) * np.log(2 * np.pi)
        )
        got = gp_log_marginal(X, Y, AMP, LS, NOISE, jitter=JITTER)
        np.testing.assert_allclose(float(got), expected, rtol=1e-4)

    def test_posterior_matches_joint_conditioning(self):
        """Condition the joint [f*, y] Gaussian directly in numpy."""
        Kxx = np_kernel(X, X) + (NOISE**2 + JITTER) * np.eye(len(X))
        Ksx = np_kernel(XT, X)
        Kss = np_kernel(XT, XT)
        mean_np = Ksx @ np.linalg.solve(Kxx, Y)
        cov_np = Kss - Ksx @ np.linalg.solve(Kxx, Ksx.T)
        mean, cov = gp_posterior(X, Y, XT, AMP, LS, NOISE, jitter=JITTER)
        np.testing.assert_allclose(np.asarray(mean), mean_np, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(cov), cov_np, rtol=1e-3, atol=1e-4)

    def test_interpolates_training_data_at_low_noise(self):
        mean, _ = gp_posterior(X, Y, X, AMP, LS, 1e-3)
        np.testing.assert_allclose(np.asarray(mean), Y, atol=0.02)


class TestGenModel:
    def test_importance_weight_is_exact_marginal(self):
        """generate with y constrained: the weight must equal the exact GP
        log marginal at the sampled hyperparameters (the model marginalizes
        f analytically, so the y-address density IS gp_log_marginal)."""
        model = gp_regression(X, jitter=JITTER)
        tr, w = model.generate(jr.key(1), g.C["y"].set(Y), ())
        ch = tr.get_choices()
        amp = float(jnp.exp(ch["log_amp"]))
        ls = float(jnp.exp(ch["log_ls"]))
        noise = float(jnp.exp(ch["log_noise"]))
        expected = float(gp_log_marginal(X, Y, amp, ls, noise, jitter=JITTER))
        np.testing.assert_allclose(float(w), expected, rtol=1e-3)

    def test_score_decomposes_into_priors_plus_marginal(self):
        model = gp_regression(X, jitter=JITTER)
        tr = model.simulate(jr.key(2), ())
        ch = tr.get_choices()
        la, ll, ln = (
            float(ch["log_amp"]),
            float(ch["log_ls"]),
            float(ch["log_noise"]),
        )
        y = np.asarray(ch["y"])
        expected = (
            norm.logpdf(la)
            + norm.logpdf(ll)
            + norm.logpdf(ln)
            + gp_log_marginal(
                X, y, np.exp(la), np.exp(ll), np.exp(ln), jitter=JITTER
            )
        )
        np.testing.assert_allclose(
            float(tr.get_score()), float(expected), rtol=1e-3
        )

    @pytest.mark.slow
    def test_hyperparameter_posterior_via_column_hmc(self):
        """On data drawn at the true hyperparameters, the HMC posterior
        mass must sit in a sane band around them (log-scale, loose — the
        GP hyperposterior is broad at N=12) and the sampler must move."""
        from genjax_tpu.kernels import column_hmc

        model = gp_regression(X, jitter=JITTER)
        q, accept, packer = column_hmc(
            model,
            g.C["y"].set(Y),
            (),
            ["log_amp", "log_ls", "log_noise"],
            n_chains=64,
            n_steps=150,
            eps=0.05,
            L=8,
        )
        assert float(accept) > 0.5
        draws = np.asarray(q[:3])
        assert np.isfinite(draws).all()
        # truth: log(1.3)=0.26, log(0.9)=-0.11, log(0.3)=-1.20
        assert abs(draws[2].mean() - np.log(NOISE)) < 1.0
