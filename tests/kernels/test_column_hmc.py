"""Fused column-layout HMC: correctness on CPU, through ``column_hmc`` and
directly on the column sweep ``kernels.hmc._reference_hmc``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_tpu as g
from genjax_tpu.kernels import ColumnPacker, column_hmc, column_logdensity, pallas_hmc
from genjax_tpu.kernels.hmc import _reference_hmc

KEY = jax.random.key(0)


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


class TestColumnHMC:
    def test_posterior_recovery(self):
        obs = g.C["y"].set(2.0)
        q, acc, packer = column_hmc(
            conjugate, obs, (), ["mu"],
            n_chains=2048, n_steps=300, eps=0.5, L=5,
        )
        mus = q[0, :]
        assert float(acc) > 0.6
        assert jnp.mean(mus) == pytest.approx(1.0, abs=0.1)
        assert jnp.std(mus) == pytest.approx(1.0 / np.sqrt(2.0), abs=0.1)

    def test_vector_address_packing(self):
        D = 3
        X = np.eye(3, dtype=np.float32)

        @g.gen
        def vec_model():
            w = g.mv_normal_diag(jnp.zeros(D), jnp.ones(D)) @ "w"
            _ = g.mv_normal_diag(X @ w, 0.5 * jnp.ones(D)) @ "y"

        y = np.asarray([1.0, -1.0, 0.5], np.float32)
        obs = g.C["y"].set(jnp.asarray(y))
        q, acc, packer = column_hmc(
            vec_model, obs, (), ["w"],
            n_chains=1024, n_steps=300, eps=0.3, L=5,
        )
        # posterior per-dim precision 1 + 1/0.25 = 5; mean = 4*y_i/5
        post_mean = (y / 0.25) / 5.0
        w_means = jnp.mean(q[:3, :], axis=1)
        assert jnp.allclose(w_means, post_mean, atol=0.1)
        assert float(acc) > 0.5

    def test_packer_roundtrip(self):
        obs = g.C["y"].set(2.0)
        packer = ColumnPacker(conjugate, obs, (), ["mu"])
        tr = conjugate.simulate(KEY, ())
        qv = packer.pack(tr.get_choices())
        assert qv.shape == (8,)  # padded to sublane tile
        chm = packer.unpack(qv)
        assert chm["mu"] == pytest.approx(float(tr.get_choices()["mu"]))

    def test_default_path_end_to_end(self):
        """column_hmc with every option at its default recovers the
        conjugate posterior."""
        obs = g.C["y"].set(2.0)
        q, acc, _packer = column_hmc(
            conjugate, obs, (), ["mu"],
            n_chains=1024, n_steps=200, eps=0.5, L=5,
        )
        assert float(acc) > 0.6
        assert jnp.mean(q[0, :]) == pytest.approx(1.0, abs=0.15)

    def test_logdensity_matches_assess(self):
        obs = g.C["y"].set(2.0)
        packer = ColumnPacker(conjugate, obs, (), ["mu"])
        ld = column_logdensity(conjugate, obs, (), packer)
        q = jnp.zeros((8, 4)).at[0, :].set(jnp.array([0.0, 0.5, 1.0, -1.0]))
        scores = ld(q)
        for i, mu in enumerate([0.0, 0.5, 1.0, -1.0]):
            expected, _ = conjugate.assess(g.C.d({"mu": mu, "y": 2.0}), ())
            assert scores[i] == pytest.approx(float(expected), rel=1e-5)


class TestReferenceSweep:
    """The column sweep itself (``kernels.hmc._reference_hmc``, which the
    public ``pallas_hmc`` runs)."""

    def test_sweep_posterior_recovery(self):
        def ld(q):
            return -0.5 * jnp.sum(q * q, axis=0)

        q0 = jnp.full((8, 256), 3.0, jnp.float32)
        q, acc = _reference_hmc(ld, q0, 7, n_steps=200, eps=0.5, L=5)
        assert 0.3 < float(acc) <= 1.0
        assert jnp.mean(q) == pytest.approx(0.0, abs=0.1)
        assert jnp.std(q) == pytest.approx(1.0, abs=0.1)

    def test_distinct_seeds_give_distinct_streams(self):
        def ld(q):
            return -0.5 * jnp.sum(q * q, axis=0)

        q0 = jnp.zeros((8, 128), jnp.float32)
        q_a, _ = _reference_hmc(ld, q0, 3, n_steps=20, eps=0.5, L=3)
        q_b, _ = _reference_hmc(ld, q0, 4, n_steps=20, eps=0.5, L=3)
        q_a2, _ = _reference_hmc(ld, q0, 3, n_steps=20, eps=0.5, L=3)
        # same seed reproduces; adjacent seeds decorrelate, and so do the
        # chains within one sweep (they started identically)
        assert jnp.array_equal(q_a, q_a2)
        assert not jnp.allclose(q_a, q_b)
        assert not jnp.allclose(q_a[:, :64], q_a[:, 64:])

    def test_sweep_inv_mass(self):
        var = jnp.array([4.0, 0.25] * 4)

        def ld(q):
            return -0.5 * jnp.sum(q * q / var[:, None], axis=0)

        q0 = jnp.zeros((8, 512), jnp.float32)
        q, acc = _reference_hmc(
            ld, q0, 11, n_steps=300, eps=0.6, L=6, inv_mass=var,
        )
        assert 0.3 < float(acc) <= 1.0
        assert jnp.allclose(
            jnp.std(q, axis=1), jnp.sqrt(var), rtol=0.15
        )

    def test_captured_numpy_constants(self):
        # a log-density closing over host-numpy constants: the sweep
        # recovers the exact Gaussian posterior they define
        X = np.asarray([[1.0, 0.5], [0.0, 1.0]], np.float32)
        y = np.asarray([1.0, -1.0], np.float32)

        def ld(q):
            resid = X @ q[:2, :] - y[:, None]
            return -0.5 * jnp.sum(resid * resid, axis=0) - 0.5 * jnp.sum(
                q * q, axis=0
            )

        prec = np.eye(2) + X.T.astype(np.float64) @ X
        mean = np.linalg.solve(prec, X.T.astype(np.float64) @ y)
        q0 = jnp.zeros((8, 512), jnp.float32)
        q, acc = _reference_hmc(ld, q0, 5, n_steps=300, eps=0.3, L=5)
        assert 0.3 < float(acc) <= 1.0
        np.testing.assert_allclose(
            np.asarray(jnp.mean(q[:2], axis=1)), mean, atol=0.1
        )

    def test_public_name_runs_the_reference_sweep(self):
        def ld(q):
            return -0.5 * jnp.sum(q * q, axis=0)

        q0 = jnp.ones((8, 64), jnp.float32)
        q_pub, acc_pub = pallas_hmc(ld, q0, 9, n_steps=5, eps=0.4, L=3)
        q_ref, acc_ref = _reference_hmc(ld, q0, 9, n_steps=5, eps=0.4, L=3)
        assert jnp.array_equal(q_pub, q_ref)
        assert float(acc_pub) == float(acc_ref)


class TestMassAdaptation:
    def test_warmup_recovers_scales_and_speeds_nuts(self):
        from genjax_tpu.kernels.hmc import warmup_column
        from genjax_tpu.kernels.nuts import nuts_sweep_cols

        scales = jnp.array([0.05, 0.2, 1.0, 3.0, 5.0])

        def ld(q):
            return jnp.sum(-0.5 * (q / scales[:, None]) ** 2, axis=0)

        q0 = jnp.zeros((5, 1024))
        q, eps, inv_mass = warmup_column(
            ld, q0, 7, n_phases=6, steps_per_phase=25, eps0=0.05, L=10
        )
        # inv_mass approximates the posterior variances
        assert jnp.allclose(
            inv_mass / scales**2, 1.0, rtol=0.5
        ), inv_mass
        # adapted HMC recovers every scale
        q_ad, acc = pallas_hmc(
            ld, q, 2, n_steps=150, eps=eps, L=10,
            inv_mass=inv_mass,
        )
        assert float(acc) > 0.8
        assert jnp.allclose(jnp.std(q_ad, axis=1), scales, rtol=0.15)
        # adapted NUTS needs far fewer leapfrogs than unit-mass NUTS
        _, _, leaps_ad = nuts_sweep_cols(
            ld, q, 3, n_steps=20, eps=eps, max_depth=8, inv_mass=inv_mass
        )
        _, _, leaps_unit = nuts_sweep_cols(
            ld, q, 3, n_steps=20, eps=0.05, max_depth=8
        )
        assert float(leaps_ad) < 0.3 * float(leaps_unit)

    def test_column_hmc_warmup_flag(self):
        obs = g.C["y"].set(2.0)
        q, acc, packer = column_hmc(
            conjugate, obs, (), ["mu"],
            n_chains=1024, n_steps=150, eps=0.05, L=5, warmup=True,
        )
        mus = q[0, :]
        assert float(acc) > 0.6
        assert jnp.mean(mus) == pytest.approx(1.0, abs=0.1)
        assert jnp.std(mus) == pytest.approx(1.0 / np.sqrt(2.0), abs=0.1)


class TestEntryContracts:
    def test_none_constraint_is_unconstrained_prior(self):
        # None advertises pure-prior sweeps; must not crash in generate.
        # All addresses must be packed (assess needs a full assignment).
        q, acc, packer = column_hmc(
            conjugate, None, (), ["mu", "y"],
            n_chains=256, n_steps=100, eps=0.5, L=5,
        )
        mus = q[0, :]
        assert float(acc) > 0.5
        # unconstrained target = the prior N(0, 1)
        assert abs(float(jnp.mean(mus))) < 0.15
        assert float(jnp.std(mus)) == pytest.approx(1.0, abs=0.12)
