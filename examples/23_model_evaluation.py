"""Model evaluation: information criteria and calibration.

The production loop after fitting: (1) score candidate models on
held-out-equivalent predictive density with WAIC and PSIS-LOO (checking
the Pareto k̂ reliability diagnostics), (2) `compare` them, and (3) audit
the whole pipeline's calibration with simulation-based calibration.

Ground truth here: data comes from a quadratic curve, so the quadratic
regression model must beat the linear one by more than the comparison's
standard error — and the exact conjugate sampler must pass SBC.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax.scipy.stats import norm as jnorm

import genjax_tpu as g
from genjax_tpu.inference import (
    compare,
    psis_loo,
    sample_posterior,
    sbc_ranks,
    sbc_uniformity,
    waic,
)
from genjax_tpu.dists import mv_normal_diag

N, SIGMA = 40, 0.3
rng = np.random.RandomState(0)
XS = np.sort(rng.uniform(-2, 2, N)).astype(np.float32)
YS = (0.5 * XS**2 - 0.4 * XS + SIGMA * rng.randn(N)).astype(np.float32)


def make_model(degree):
    # HOST numpy: traces convert host arrays for free
    feats = np.stack([XS**p for p in range(degree + 1)], 1).astype(
        np.float32
    )

    @g.gen
    def model():
        w = mv_normal_diag(jnp.zeros(degree + 1), jnp.ones(degree + 1)) @ "w"
        mv_normal_diag(feats @ w, SIGMA * jnp.ones(N)) @ "y"

    return model, feats


def pointwise_loglik(model, feats, n_draws=600):
    """Fit, then build the (S, N) pointwise log-lik matrix from the
    posterior draws of w — one vmapped density evaluation."""
    res = sample_posterior(
        jr.key(0), model, g.C["y"].set(jnp.asarray(YS)), (), g.S["w"],
        n_chains=8, n_warmup=200, n_samples=n_draws // 8, algorithm="hmc",
        eps0=0.1,
    )
    ws = jnp.asarray(res.positions[("w",)]).reshape(-1, feats.shape[1])
    mus = ws @ feats.T  # (S, N)
    return jnorm.logpdf(jnp.asarray(YS)[None, :], mus, SIGMA)


def main():
    # ---- 1 & 2: information criteria + comparison ----------------------
    results = {}
    for name, degree in (("linear", 1), ("quadratic", 2)):
        model, feats = make_model(degree)
        ll = pointwise_loglik(model, feats)
        res = psis_loo(ll)
        results[name] = res
        k_max = float(np.asarray(res.pareto_k).max())
        print(
            f"{name:10s}: LOO elpd={float(res.elpd):7.1f} "
            f"(p_eff={float(res.p_eff):.1f}, max k-hat={k_max:.2f}); "
            f"WAIC elpd={float(waic(ll).elpd):7.1f}"
        )
        assert k_max < 0.7  # reliable estimates

    rows = compare(results)
    print("ranking:", [(r[0], round(r[2], 1)) for r in rows])
    assert rows[0][0] == "quadratic"
    d_elpd, d_se = rows[1][2], rows[1][3]
    assert d_elpd < -d_se, (d_elpd, d_se)  # decisively worse

    # ---- 3: calibration audit of the pipeline --------------------------
    @g.gen
    def small():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 0.5) @ "y"

    def exact_sampler(key, constraint):
        y = constraint.get_submap("y").get_value()
        v = 1.0 / (1.0 + 1.0 / 0.25)
        return (v * y / 0.25 + jnp.sqrt(v) * jr.normal(key, (99,)))[:, None]

    res = jax.jit(
        lambda k: sbc_ranks(k, small, (), g.S["mu"], exact_sampler, n_sims=300)
    )(jr.key(1))
    pvals, _ = sbc_uniformity(res, n_bins=20)
    print(f"SBC uniformity p-value: {float(pvals[0]):.3f}")
    assert float(pvals[0]) > 0.01


if __name__ == "__main__":
    main()
