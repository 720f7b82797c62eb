"""Data-axis sharding (`parallel/data.py`) on the 8-device CPU mesh:
exactness vs the dense computation, gradient agreement, and an end-to-end
conjugate posterior through the column HMC kernel."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
from jax.scipy.stats import norm

from genjax_tpu.parallel import (
    data_sharded_logdensity,
    make_mesh_2d,
    minibatch_logdensity,
    shard_data,
)

# Synthetic logistic-regression problem: q columns are (D, N) chain
# positions of the weight vector, data rows are (x, y).
D_REAL = 3
M_DATA = 64
rng = np.random.RandomState(0)
X = rng.randn(M_DATA, D_REAL).astype(np.float32)
W_TRUE = np.asarray([1.0, -2.0, 0.5], np.float32)
Y = (rng.rand(M_DATA) < 1.0 / (1.0 + np.exp(-(X @ W_TRUE)))).astype(
    np.float32
)


def log_prior(q):
    # standard normal over every (possibly padded) dimension, per column
    return -0.5 * jnp.sum(q**2, axis=0)


def log_lik(q, shard):
    x, y = shard
    logits = x @ q[:D_REAL]  # (m_local, N)
    # Bernoulli log-lik summed over the shard's rows
    return jnp.sum(
        y[:, None] * jax.nn.log_sigmoid(logits)
        + (1.0 - y[:, None]) * jax.nn.log_sigmoid(-logits),
        axis=0,
    )


def dense_logdensity(q):
    return log_prior(q) + log_lik(q, (jnp.asarray(X), jnp.asarray(Y)))


class TestDataShardedLogdensity:
    def test_matches_dense(self):
        mesh = make_mesh_2d((2, 4))
        data = shard_data((jnp.asarray(X), jnp.asarray(Y)), mesh)
        ld = data_sharded_logdensity(log_prior, log_lik, data, mesh)
        q = jnp.asarray(rng.randn(8, 16), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(jax.jit(ld)(q)),
            np.asarray(dense_logdensity(q)),
            rtol=1e-5,
        )

    def test_grad_matches_dense(self):
        mesh = make_mesh_2d((1, 8))
        data = shard_data((jnp.asarray(X), jnp.asarray(Y)), mesh)
        ld = data_sharded_logdensity(
            log_prior, log_lik, data, mesh, chain_axis=None
        )
        q = jnp.asarray(rng.randn(8, 16), jnp.float32)

        def total(f, qq):
            return jnp.sum(f(qq))

        g_sharded = jax.jit(jax.grad(lambda qq: total(ld, qq)))(q)
        g_dense = jax.grad(lambda qq: total(dense_logdensity, qq))(q)
        np.testing.assert_allclose(
            np.asarray(g_sharded), np.asarray(g_dense), rtol=1e-4, atol=1e-6
        )

    def test_indivisible_data_raises(self):
        mesh = make_mesh_2d((1, 8))
        bad = (jnp.zeros((13, D_REAL)), jnp.zeros((13,)))
        with pytest.raises(ValueError, match="divisible"):
            data_sharded_logdensity(log_prior, log_lik, bad, mesh)

    def test_conjugate_posterior_through_column_hmc(self):
        """Gaussian mean with data sharded 4-way and chains 2-way: the HMC
        posterior over the sharded log-density must match the closed-form
        conjugate posterior N(m_post, v_post)."""
        from genjax_tpu.kernels.hmc import pallas_hmc

        mesh = make_mesh_2d((2, 4))
        obs = np.asarray(rng.randn(40) * 0.7 + 1.3, np.float32)
        sigma = 0.7
        v_post = 1.0 / (1.0 + len(obs) / sigma**2)
        m_post = v_post * obs.sum() / sigma**2

        def lp(q):
            return -0.5 * jnp.sum(q**2, axis=0)

        def ll(q, shard):
            (ys,) = shard
            return jnp.sum(norm.logpdf(ys[:, None], q[0], sigma), axis=0)

        data = shard_data((jnp.asarray(obs),), mesh)
        ld = data_sharded_logdensity(lp, ll, data, mesh)
        q0 = jnp.asarray(rng.randn(8, 512), jnp.float32)
        q, accept = jax.jit(
            lambda: pallas_hmc(
                ld, q0, 7, n_steps=300, eps=0.15, L=8
            )
        )()
        draws = np.asarray(q[0])
        assert float(accept) > 0.6
        np.testing.assert_allclose(draws.mean(), m_post, atol=0.03)
        np.testing.assert_allclose(
            draws.var(), v_post, rtol=0.25, atol=5e-3
        )


class TestDistributedULA:
    def test_sgld_on_sharded_gradient_matches_stationary_law(self):
        """SGLD with the EXACT data-sharded gradient == distributed ULA:
        on the conjugate Gaussian-mean posterior N(m, v) its stationary
        variance has the closed form v / (1 - eps/(4 v))."""
        from genjax_tpu.kernels import full_grad_cols, sgld_sweep_cols

        mesh = make_mesh_2d((1, 8))
        obs = np.asarray(
            np.random.RandomState(4).randn(48) * 0.6 + 0.9, np.float32
        )
        sigma = 0.6
        v_post = 1.0 / (1.0 + len(obs) / sigma**2)
        m_post = v_post * obs.sum() / sigma**2

        def lp(q):
            return -0.5 * jnp.sum(q**2, axis=0)

        def ll(q, shard):
            (ys,) = shard
            return -0.5 * jnp.sum(
                (ys[:, None] - q[0]) ** 2, axis=0
            ) / sigma**2

        data = shard_data((jnp.asarray(obs),), mesh)
        ld = data_sharded_logdensity(lp, ll, data, mesh, chain_axis=None)
        grad = full_grad_cols(ld)
        eps = 0.2 * v_post  # well inside stability (eps < 2 v)
        q0 = jnp.full((1, 4096), float(m_post), jnp.float32)
        q, _ = jax.jit(
            lambda: sgld_sweep_cols(grad, q0, 3, n_steps=400, eps=eps)
        )()
        draws = np.asarray(q[0])
        v_exact = v_post / (1.0 - eps / (4.0 * v_post))
        np.testing.assert_allclose(draws.mean(), m_post, atol=0.01)
        np.testing.assert_allclose(draws.var(), v_exact, rtol=0.08)


class TestMinibatch:
    def test_partition_mean_gradient_is_exact(self):
        """Averaging the scaled minibatch gradient over a disjoint partition
        of the data reproduces the full-data gradient exactly — the
        unbiasedness identity SGLD relies on."""
        q = jnp.asarray(rng.randn(8, 4), jnp.float32)
        full = jax.grad(lambda qq: jnp.sum(dense_logdensity(qq)))(q)
        grads = []
        for i in range(0, M_DATA, 16):
            batch = (jnp.asarray(X[i : i + 16]), jnp.asarray(Y[i : i + 16]))
            ld = minibatch_logdensity(log_prior, log_lik, batch, M_DATA)
            grads.append(jax.grad(lambda qq: jnp.sum(ld(qq)))(q))
        # the prior term is counted once per batch: mean of scaled-lik
        # gradients + one prior gradient == full gradient
        mean_g = sum(np.asarray(g) for g in grads) / len(grads)
        np.testing.assert_allclose(mean_g, np.asarray(full), rtol=1e-4)
