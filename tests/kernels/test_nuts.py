"""NUTS correctness: posterior moments vs closed forms and adaptive
trajectory behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_tpu as g
from genjax_tpu.kernels import column_nuts
from genjax_tpu.kernels.nuts import nuts_sweep_cols


class TestNUTSCore:
    def test_standard_normal(self):
        def ld(q):
            return jnp.sum(-0.5 * q * q, axis=0)

        qf, acc, leaps = jax.jit(
            lambda q: nuts_sweep_cols(ld, q, 0, n_steps=60, eps=0.4, max_depth=6)
        )(jnp.full((5, 512), 3.0))
        assert float(acc) > 0.8
        assert jnp.mean(qf) == pytest.approx(0.0, abs=0.1)
        assert jnp.std(qf) == pytest.approx(1.0, abs=0.1)

    def test_adaptive_trajectories(self):
        """Wider targets need longer trajectories — NUTS adapts them."""

        def narrow(q):
            return jnp.sum(-0.5 * (q / 0.3) ** 2, axis=0)

        def wide(q):
            return jnp.sum(-0.5 * (q / 3.0) ** 2, axis=0)

        _, _, leaps_narrow = nuts_sweep_cols(
            narrow, jnp.zeros((2, 128)), 0, n_steps=20, eps=0.1, max_depth=8
        )
        _, _, leaps_wide = nuts_sweep_cols(
            wide, jnp.zeros((2, 128)), 0, n_steps=20, eps=0.1, max_depth=8
        )
        assert float(leaps_wide) > 2.0 * float(leaps_narrow)

    def test_correlated_gaussian(self):
        cov = jnp.array([[1.0, 0.9], [0.9, 1.0]])
        prec = jnp.linalg.inv(cov)

        def ld(q):
            return -0.5 * jnp.sum(q * (prec @ q), axis=0)

        qf, acc, _ = jax.jit(
            lambda q: nuts_sweep_cols(ld, q, 2, n_steps=100, eps=0.2, max_depth=7)
        )(jnp.zeros((2, 1024)))
        emp = jnp.cov(qf)
        assert jnp.allclose(emp, cov, atol=0.12)


class TestBatchedColsEquivalence:
    """The explicitly batched transition (scalar loop conditions,
    collective early exit) must sample the same distribution as the
    vmapped single-chain transition — different PRNG streams, same
    posterior moments and trajectory statistics."""

    @pytest.mark.slow
    def test_moment_and_statistic_agreement(self):
        cov = jnp.array([[1.0, 0.9], [0.9, 1.0]])
        prec = jnp.linalg.inv(cov)

        def ld(q):
            return -0.5 * jnp.sum(q * (prec @ q), axis=0)

        out = {}
        for batched in (False, True):
            qf, acc, leaps = jax.jit(
                lambda q, b=batched: nuts_sweep_cols(
                    ld, q, 7, n_steps=150, eps=0.2, max_depth=7, batched=b
                )
            )(jnp.zeros((2, 4096)))
            out[batched] = (jnp.cov(qf), float(acc), float(leaps))
        cov_v, acc_v, leaps_v = out[False]
        cov_b, acc_b, leaps_b = out[True]
        assert jnp.allclose(cov_v, cov, atol=0.08)
        assert jnp.allclose(cov_b, cov, atol=0.08)
        assert acc_b == pytest.approx(acc_v, abs=0.05)
        assert leaps_b == pytest.approx(leaps_v, rel=0.15)

    def test_divergence_rates_agree_on_funnel(self):
        """Regression: flags raised by the masked-out leaf budget AFTER a
        chain terminated must not leak into info.diverged — pre-fix the
        vmapped transition reported ~6x the true divergence rate on
        Neal's funnel (0.0170 vs 0.0029 at eps=0.3, depth 7)."""
        from jax import lax
        from genjax_tpu.kernels.nuts import nuts_transition, nuts_transition_cols

        def ld_cols(q):
            v, x = q[0], q[1:]
            return (
                -0.5 * (v / 3.0) ** 2
                - 0.5 * jnp.sum(x * x * jnp.exp(-v), axis=0)
                - 1.5 * v
            )

        def ld_one(z):
            return ld_cols(z[:, None])[0]

        n, steps, eps = 512, 30, 0.3
        q0 = jnp.zeros((4, n), jnp.float32)

        def sweep_vmap(q0):
            def step(q, key):
                keys = jax.random.split(key, n)
                z, info = jax.vmap(
                    lambda k, zz: nuts_transition(ld_one, zz, k, eps, max_depth=7),
                    in_axes=(0, 1), out_axes=(1, 0),
                )(keys, q)
                return z, jnp.mean(info.diverged.astype(jnp.float32))
            return lax.scan(step, q0, jax.random.split(jax.random.key(0), steps))

        def sweep_cols(q0):
            def step(q, key):
                z, info = nuts_transition_cols(ld_cols, q, key, eps, max_depth=7)
                return z, jnp.mean(info.diverged.astype(jnp.float32))
            return lax.scan(step, q0, jax.random.split(jax.random.key(0), steps))

        _, dv = jax.jit(sweep_vmap)(q0)
        _, dc = jax.jit(sweep_cols)(q0)
        rate_v, rate_c = float(jnp.mean(dv)), float(jnp.mean(dc))
        assert rate_v < 0.008, rate_v
        assert rate_c < 0.008, rate_c
        assert abs(rate_v - rate_c) < 0.005, (rate_v, rate_c)

    def test_batched_inv_mass(self):
        def ld(q):
            return jnp.sum(-0.5 * (q / jnp.array([[0.5], [2.0]])) ** 2, axis=0)

        qf, acc, _ = jax.jit(
            lambda q: nuts_sweep_cols(
                ld, q, 3, n_steps=60, eps=0.3, max_depth=6,
                inv_mass=jnp.array([0.25, 4.0]), batched=True,
            )
        )(jnp.zeros((2, 1024)))
        assert float(acc) > 0.7
        assert jnp.std(qf[0]) == pytest.approx(0.5, abs=0.08)
        assert jnp.std(qf[1]) == pytest.approx(2.0, abs=0.3)


class TestColumnNUTS:
    def test_conjugate_posterior(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        obs = g.C["y"].set(2.0)
        q, acc, leaps, packer = column_nuts(
            model, obs, (), ["mu"],
            n_chains=1024, n_steps=80, eps=0.3, max_depth=6,
        )
        mus = q[0, :]
        assert float(acc) > 0.8
        assert jnp.mean(mus) == pytest.approx(1.0, abs=0.1)
        assert jnp.std(mus) == pytest.approx(1 / np.sqrt(2.0), abs=0.1)

    @pytest.mark.parametrize("mass", ["identity", "inv_mass", "warmup"])
    def test_anisotropic_exact_moments(self, mass):
        """Prior scales spanning 30x with a unit-noise observation per
        dimension: every marginal's mean and sd match the conjugate
        closed form, with the identity metric, a given diagonal
        ``inv_mass`` (the exact posterior variances), and the adapted
        one."""
        scales = np.asarray([0.1, 1.0, 3.0], np.float32)
        y = np.asarray([1.0, -2.0, 0.5], np.float32)

        @g.gen
        def model():
            w = g.mv_normal_diag(jnp.zeros(3), jnp.asarray(scales)) @ "w"
            _ = g.mv_normal_diag(w, jnp.ones(3)) @ "y"

        var = 1.0 / (1.0 / scales.astype(np.float64) ** 2 + 1.0)
        mean = var * y
        inv_mass = None
        if mass == "inv_mass":
            inv_mass = np.concatenate([var, np.ones(5)]).astype(np.float32)
        q, acc, _leaps, packer = column_nuts(
            model, g.C["y"].set(y), (), ["w"],
            n_chains=2048, n_steps=60, eps=0.05 if mass == "identity" else 0.5,
            max_depth=8, seed=3, inv_mass=inv_mass, warmup=mass == "warmup",
        )
        draws = np.asarray(q[:3], np.float64)
        assert float(acc) > 0.6
        err = np.abs(draws.mean(axis=1) - mean)
        assert np.all(err <= 4 * np.sqrt(var / 2048) + 0.01), err
        np.testing.assert_allclose(draws.std(axis=1), np.sqrt(var), rtol=0.1)


def test_unbatched_accepts_column_inv_mass_shape():
    """nuts_transition must take the same (D, 1) inv_mass contract as the
    batched nuts_transition_cols path."""
    import jax.random as jr

    from genjax_tpu.kernels.nuts import nuts_transition

    def ld(z):
        return -0.5 * jnp.sum(z * z)

    z0 = jnp.zeros((3,))
    z1, info = nuts_transition(ld, z0, jr.key(0), 0.5, inv_mass=jnp.ones((3, 1)))
    assert z1.shape == (3,)
    assert jnp.all(jnp.isfinite(z1))
