"""Gaussian-process regression end-to-end.

One GP dataset worked through the whole stack:

1. **Hyperparameters** — the `models.gp_regression` ``@gen`` model
   marginalizes the function values analytically, so MCMC over
   (log_amp, log_ls, log_noise) targets the exact hyperposterior; run it
   through the fused column HMC kernel.
2. **Prediction** — closed-form `gp_posterior` at the posterior-mean
   hyperparameters, with calibration checked against held-out truth.
3. **Latent sampling** — elliptical slice sampling (`kernels.elliptical`)
   draws function values f | y exactly; its moments must match the
   closed form.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

import genjax_tpu as g
from genjax_tpu.kernels import column_hmc, ess_sweep_cols, ess_sweep_gauss_cols
from genjax_tpu.models import gp_posterior, gp_regression, sq_exp_kernel

AMP, LS, NOISE = 1.2, 0.8, 0.25
N_TRAIN, N_TEST = 24, 8


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(-3, 3, size=(N_TRAIN + N_TEST, 1)), axis=0)
    K = np.asarray(sq_exp_kernel(X, X, AMP, LS)) + 1e-6 * np.eye(len(X))
    f = rng.multivariate_normal(np.zeros(len(X)), K)
    idx = rng.permutation(len(X))
    tr_i, te_i = idx[:N_TRAIN], idx[N_TRAIN:]
    y_train = (f[tr_i] + NOISE * rng.randn(N_TRAIN)).astype(np.float32)
    return (
        X[tr_i].astype(np.float32),
        y_train,
        X[te_i].astype(np.float32),
        f[te_i],
    )


def main():
    X, y, X_test, f_test = make_data()

    # ---- 1. hyperparameter posterior through the column kernel ---------
    model = gp_regression(X)
    q, accept, packer = column_hmc(
        model,
        g.C["y"].set(jnp.asarray(y)),
        (),
        ["log_amp", "log_ls", "log_noise"],
        n_chains=64,
        n_steps=300,
        eps=0.05,
        L=8,
    )
    draws = np.asarray(q[:3])  # (3, chains)
    la, ll_, ln = draws.mean(axis=1)
    print(
        f"hyperposterior means: amp={np.exp(la):.2f} (true {AMP}), "
        f"ls={np.exp(ll_):.2f} (true {LS}), "
        f"noise={np.exp(ln):.2f} (true {NOISE}); accept={float(accept):.2f}"
    )
    assert float(accept) > 0.5
    assert abs(ln - np.log(NOISE)) < 1.0  # N=24 → broad but centered

    # ---- 2. closed-form prediction at the posterior mean ---------------
    mean, cov = gp_posterior(
        X, y, X_test, np.exp(la), np.exp(ll_), np.exp(ln)
    )
    sd = np.sqrt(np.diag(np.asarray(cov)))
    z = np.abs(np.asarray(mean) - f_test) / (sd + 1e-6)
    print(f"held-out |z|-scores: max={z.max():.2f}")
    assert (z < 4.0).all(), z  # calibrated predictive

    # ---- 3. exact latent draws via elliptical slice sampling -----------
    K = np.asarray(
        sq_exp_kernel(X, X, np.exp(la), np.exp(ll_))
    ) + 1e-5 * np.eye(N_TRAIN)
    # HOST numpy: the trace converts it for free
    chol = np.linalg.cholesky(K).astype(np.float32)
    noise2 = float(np.exp(2 * ln))

    def log_lik(f_cols):
        resid = jnp.asarray(y)[:, None] - f_cols
        return -0.5 * jnp.sum(resid**2, axis=0) / noise2

    f_cols, _ = jax.jit(
        lambda: ess_sweep_cols(
            log_lik,
            jnp.zeros((N_TRAIN, 1024), jnp.float32),
            3,
            n_steps=200,
            chol_prior=chol,
        )
    )()
    mean_exact, _ = gp_posterior(
        X, y, X, np.exp(la), np.exp(ll_), np.exp(ln), jitter=1e-5
    )
    err = np.abs(np.asarray(f_cols).mean(axis=1) - np.asarray(mean_exact))
    print(f"ESS latent means vs closed form: max err={err.max():.3f}")
    assert err.max() < 0.1

    # Gaussian observation noise? Use the FAST PATH: ll(theta) along the
    # ellipse is a six-coefficient trig quadratic, so the shrink loop is
    # O(chains) instead of O(D x chains) per iteration — same Markov
    # chain (kernels/elliptical.py).
    f_fast, _ = jax.jit(
        lambda: ess_sweep_gauss_cols(
            jnp.zeros((N_TRAIN, 1024), jnp.float32),
            3,
            n_steps=200,
            chol_prior=chol,
            y=jnp.asarray(y),
            prec=1.0 / noise2,
        )
    )()
    err_fast = np.abs(
        np.asarray(f_fast).mean(axis=1) - np.asarray(mean_exact)
    )
    print(f"fast-path latent means vs closed form: max err={err_fast.max():.3f}")
    assert err_fast.max() < 0.1


if __name__ == "__main__":
    main()
