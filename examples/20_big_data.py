"""Big-data Bayesian inference: data sharding and stochastic gradients.

Two regimes the single-chip reference cannot touch:

1. **Exact, data-sharded**: the dataset lives sharded across a mesh axis;
   the log-likelihood (and its gradient) is computed shard-locally and
   `psum`-reduced across devices. The result is an ordinary column log-density —
   full-batch HMC/NUTS run on it unchanged, and the posterior is exact.
2. **Stochastic-gradient**: SGLD steps on unbiased minibatch gradients —
   O(batch) per step instead of O(dataset), with the standard O(eps)
   stationary bias.

Both are validated here against the closed-form conjugate posterior of
Bayesian linear regression with known noise.
"""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_tpu.kernels import minibatch_grad_cols, pallas_hmc, sgld_sweep_cols
from genjax_tpu.parallel import (
    data_sharded_logdensity,
    make_mesh_2d,
    shard_data,
)

D, M = 4, 256
SIGMA = 0.5


def make_dataset():
    rng = np.random.RandomState(7)
    X = rng.randn(M, D).astype(np.float32)
    w_true = rng.randn(D).astype(np.float32)
    y = (X @ w_true + SIGMA * rng.randn(M)).astype(np.float32)
    return X, y


def exact_posterior(X, y):
    """w ~ N(0, I), y | w ~ N(Xw, sigma^2 I): posterior N(mu, Sigma) with
    Sigma = (I + X'X/sigma^2)^-1, mu = Sigma X'y / sigma^2."""
    prec = np.eye(D) + X.T @ X / SIGMA**2
    cov = np.linalg.inv(prec)
    mu = cov @ (X.T @ y) / SIGMA**2
    return mu, cov


def log_prior(q):
    return -0.5 * jnp.sum(q**2, axis=0)


def log_lik(q, shard):
    x, y = shard
    resid = y[:, None] - x @ q[:D]
    return -0.5 * jnp.sum(resid**2, axis=0) / SIGMA**2


def main():
    X, y = make_dataset()
    mu_post, cov_post = exact_posterior(X, y)

    # ---- regime 1: exact inference over a chains×data mesh -------------
    n_dev = len(jax.devices())
    shape = (2, n_dev // 2) if n_dev % 2 == 0 and n_dev > 1 else (1, n_dev)
    mesh = make_mesh_2d(shape)
    print(f"2-D mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    data = shard_data((jnp.asarray(X), jnp.asarray(y)), mesh)
    ld = data_sharded_logdensity(log_prior, log_lik, data, mesh)

    n_chains = 512
    q0 = jnp.asarray(np.random.RandomState(1).randn(8, n_chains), jnp.float32)
    q, accept = jax.jit(
        lambda: pallas_hmc(
            ld, q0, 11, n_steps=400, eps=0.04, L=10
        )
    )()
    draws = np.asarray(q[:D])
    err = np.abs(draws.mean(axis=1) - mu_post).max()
    print(f"sharded HMC: accept={float(accept):.2f}, max|mean err|={err:.3f}")
    assert float(accept) > 0.5
    assert err < 0.05, (draws.mean(axis=1), mu_post)
    # marginal sds too — the geometry survived the sharding
    np.testing.assert_allclose(
        draws.std(axis=1), np.sqrt(np.diag(cov_post)), rtol=0.35
    )

    # ---- regime 2: SGLD on minibatches of 32 of the 256 rows -----------
    grad = minibatch_grad_cols(
        log_prior, log_lik, (jnp.asarray(X), jnp.asarray(y)), batch_size=32
    )
    q0 = jnp.tile(
        jnp.pad(jnp.asarray(mu_post, jnp.float32), (0, 8 - D))[:, None],
        (1, n_chains),
    )
    q, _ = jax.jit(
        lambda: sgld_sweep_cols(grad, q0, 5, n_steps=1200, eps=4e-5)
    )()
    draws = np.asarray(q[:D])
    err = np.abs(draws.mean(axis=1) - mu_post).max()
    print(f"minibatch SGLD: max|mean err|={err:.3f}")
    assert err < 0.06, (draws.mean(axis=1), mu_post)


if __name__ == "__main__":
    main()
