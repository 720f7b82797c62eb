"""MCMC edit-request correctness.

Modeled on reference /root/reference/tests/inference/test_requests.py —
regenerate/rejuvenate convergence (:120, :168) and HMC against the exact
HMM posterior (:258). Here the exact checks use conjugate normal-normal
posteriors (closed form) and the DiscreteHMM testbed.
"""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g
from genjax_tpu.inference.requests import HMC, Rejuvenate, mh_accept

KEY = jax.random.key(42)


@g.gen
def normal_normal():
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, 1.0) @ "y"
    return y


def exact_posterior(y_obs):
    # mu | y ~ N(y/2, 1/sqrt(2))
    return y_obs / 2.0, 1.0 / jnp.sqrt(2.0)


class TestHMC:
    def test_alpha_is_mh_ratio_structurally(self):
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(1.0), ())
        new_tr, alpha, _rd, bwd = tr.edit(KEY, HMC(g.S["mu"], 0.1, L=5))
        assert jnp.isfinite(alpha)
        assert isinstance(bwd, HMC)
        # y stays constrained
        assert new_tr.get_choices()["y"] == pytest.approx(1.0)
        assert new_tr.get_choices()["mu"] != tr.get_choices()["mu"]

    def test_posterior_moments_single_chain(self):
        y_obs = 1.0
        mean, std = exact_posterior(y_obs)
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(y_obs), ())

        def step(carry, k):
            tr = carry
            k1, k2 = jax.random.split(k)
            new_tr, alpha, _, _ = tr.edit(k1, HMC(g.S["mu"], 0.3, L=10))
            tr, accept = mh_accept(k2, tr, new_tr, alpha)
            return tr, (tr.get_choices()["mu"], accept)

        keys = jax.random.split(KEY, 600)
        _, (mus, accepts) = jax.lax.scan(step, tr, keys)
        mus = mus[100:]  # burn-in
        assert jnp.mean(accepts) > 0.5
        assert jnp.mean(mus) == pytest.approx(mean, abs=0.15)
        assert jnp.std(mus) == pytest.approx(std, abs=0.15)

    def test_many_chains_vmapped(self):
        """The batch shape: thousands of chains as a vmapped batch."""
        y_obs = 2.0
        mean, std = exact_posterior(y_obs)
        n_chains = 512

        def chain(key):
            k0, k1 = jax.random.split(key)
            tr, _ = normal_normal.generate(k0, g.C["y"].set(y_obs), ())

            def step(tr, k):
                ka, kb = jax.random.split(k)
                new_tr, alpha, _, _ = tr.edit(ka, HMC(g.S["mu"], 0.3, L=10))
                tr, _ = mh_accept(kb, tr, new_tr, alpha)
                return tr, None

            tr, _ = jax.lax.scan(step, tr, jax.random.split(k1, 50))
            return tr.get_choices()["mu"]

        mus = jax.jit(jax.vmap(chain))(jax.random.split(KEY, n_chains))
        assert jnp.mean(mus) == pytest.approx(mean, abs=0.1)
        assert jnp.std(mus) == pytest.approx(std, abs=0.1)


class TestRejuvenate:
    def test_random_walk_weight_is_symmetric_ratio(self):
        """For a symmetric random-walk proposal the MH log-ratio reduces to
        the model score difference."""
        rw_scale = 0.5

        @g.gen
        def rw_proposal(chm):
            old = chm["mu"]
            old = old.unmask() if isinstance(old, g.Mask) else old
            _ = g.normal(old, rw_scale) @ "mu"
            return None

        tr, _ = normal_normal.generate(KEY, g.C["y"].set(1.0), ())
        req = Rejuvenate(rw_proposal, lambda chm: (chm,))
        new_tr, w, _rd, _bwd = tr.edit(KEY, req)
        expected = new_tr.get_score() - tr.get_score()
        assert w == pytest.approx(expected, abs=1e-4)

    def test_random_walk_converges(self):
        y_obs = 1.0
        mean, std = exact_posterior(y_obs)

        @g.gen
        def rw_proposal(chm):
            old = chm["mu"]
            old = old.unmask() if isinstance(old, g.Mask) else old
            _ = g.normal(old, 0.8) @ "mu"
            return None

        req = Rejuvenate(rw_proposal, lambda chm: (chm,))
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(y_obs), ())

        def step(tr, k):
            k1, k2 = jax.random.split(k)
            new_tr, w, _, _ = tr.edit(k1, req)
            tr, _ = mh_accept(k2, tr, new_tr, w)
            return tr, tr.get_choices()["mu"]

        _, mus = jax.lax.scan(step, tr, jax.random.split(KEY, 3000))
        mus = mus[500:]
        assert jnp.mean(mus) == pytest.approx(mean, abs=0.1)
        assert jnp.std(mus) == pytest.approx(std, abs=0.1)


class TestRegenerate:
    def test_regenerate_weight_identity(self):
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(1.0), ())
        new_tr, w, _rd, bwd = tr.edit(KEY, g.Regenerate(g.S["mu"]))
        # regenerating mu from the prior: w = new joint - old joint
        #   (mu resampled from prior: weight = score' - score)
        assert new_tr.get_score() == pytest.approx(tr.get_score() + w, rel=1e-4)

    def test_regenerate_mh_converges(self):
        """The `mh` driver converts the Regenerate joint-ratio weight to the
        MH (likelihood-ratio) alpha — chain must match the exact posterior."""
        y_obs = 1.0
        mean, std = exact_posterior(y_obs)
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(y_obs), ())

        res = g.run_chain(
            KEY, tr, g.S["mu"], 4000, record=lambda t: t.get_choices()["mu"]
        )
        mus = res.history[500:]
        assert jnp.mean(mus) == pytest.approx(mean, abs=0.1)
        assert jnp.std(mus) == pytest.approx(std, abs=0.1)

    def test_run_chains_vmapped(self):
        y_obs = 1.0
        mean, std = exact_posterior(y_obs)

        def make_trace(k):
            tr, _ = normal_normal.generate(k, g.C["y"].set(y_obs), ())
            return tr

        res = jax.jit(
            lambda k: g.run_chains(
                k,
                make_trace,
                g.S["mu"],
                n_steps=200,
                n_chains=256,
                record=lambda t: t.get_choices()["mu"],
            )
        )(KEY)
        final_mus = res.history[:, -1]
        assert jnp.mean(final_mus) == pytest.approx(mean, abs=0.1)
        assert jnp.std(final_mus) == pytest.approx(std, abs=0.1)


class TestHMCOnHMMStructure:
    def test_hmc_on_continuous_ssm(self):
        """HMC over the latent path of a linear-Gaussian SSM; check the edit
        round-trips and the posterior pulls latents toward observations."""

        @g.gen
        def ssm_step(c, y_obs):
            z = g.normal(c, 1.0) @ "z"
            _ = g.normal(z, 0.3) @ "y"
            return (z, z)

        ssm = ssm_step.scan()
        T = 10
        ys = jnp.ones(T) * 2.0
        constraint = g.C[:, "y"].set(ys)
        tr, _ = ssm.generate(KEY, constraint, (0.0, jnp.zeros(T)))

        sel = g.S[..., "z"]

        def step(tr, k):
            k1, k2 = jax.random.split(k)
            new_tr, alpha, _, _ = tr.edit(k1, HMC(sel, 0.05, L=10))
            tr, _ = mh_accept(k2, tr, new_tr, alpha)
            return tr, None

        tr, _ = jax.lax.scan(step, tr, jax.random.split(KEY, 100))
        zs = jnp.asarray([tr.get_choices()[t, "z"] for t in range(T)])
        # with obs noise 0.3 << prior walk noise, latents track observations
        assert jnp.mean(jnp.abs(zs[3:] - 2.0)) < 0.6


class TestMALA:
    def test_mala_converges_to_posterior(self):
        from genjax_tpu.inference.requests import MALA

        y_obs = 1.0
        mean, std = exact_posterior(y_obs)
        tr, _ = normal_normal.generate(KEY, g.C["y"].set(y_obs), ())
        res = g.run_chain(
            KEY, tr, MALA(g.S["mu"], 0.5), 4000,
            record=lambda t: t.get_choices()["mu"],
        )
        mus = res.history[500:]
        assert float(res.accept_rate) > 0.4
        assert jnp.mean(mus) == pytest.approx(mean, abs=0.1)
        assert jnp.std(mus) == pytest.approx(std, abs=0.1)

    def test_mala_alpha_finite_vector_address(self):
        from genjax_tpu.inference.requests import MALA

        @g.gen
        def vec_model():
            w = g.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "w"
            _ = g.mv_normal_diag(w, 0.5 * jnp.ones(3)) @ "y"

        tr, _ = vec_model.generate(KEY, g.C["y"].set(jnp.ones(3)), ())
        new_tr, alpha, _, _ = tr.edit(KEY, MALA(g.S["w"], 0.1))
        assert jnp.isfinite(alpha)
        assert not jnp.allclose(
            new_tr.get_choices()["w"], tr.get_choices()["w"]
        )


class TestMALADetailedBalance:
    """Regression: the forward proposal density must be computed from
    trace-readback residuals, not the raw noise — otherwise every inert
    leaf riding in the lazily-filtered values tree (observations,
    unselected latents) contributes +||noise||^2/2 to alpha. Pre-fix,
    with 20 observed scalars this accepted 99.9% of proposals and
    overdispersed the posterior std by 66% (0.363 vs exact 0.218)."""

    def test_exact_posterior_with_many_inert_dims(self):
        from genjax_tpu.inference.mcmc import mh
        from genjax_tpu.inference.requests import MALA

        n_obs = 20

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            for i in range(n_obs):
                _ = g.normal(mu, 1.0) @ f"y{i}"

        obs = g.C.kw(**{f"y{i}": 1.0 for i in range(n_obs)})
        exact_mean = n_obs / (n_obs + 1)
        exact_std = float(jnp.sqrt(1.0 / (n_obs + 1)))

        def chain(key, n=400, eps=0.35):
            tr, _ = model.generate(key, obs, ())
            req = MALA(g.S["mu"], eps)

            def step(tr, k):
                tr, acc = mh(k, tr, req)
                return tr, (tr.get_choices()["mu"], acc)

            _, (mus, accs) = jax.lax.scan(
                step, tr, jax.random.split(jax.random.fold_in(key, 1), n)
            )
            return mus[100:], jnp.mean(accs.astype(jnp.float32))

        keys = jax.random.split(KEY, 256)
        mus, accs = jax.jit(jax.vmap(chain))(keys)
        assert float(jnp.mean(accs)) < 0.95  # pre-fix: 0.999
        assert float(jnp.mean(mus)) == pytest.approx(exact_mean, abs=0.02)
        assert float(jnp.std(mus)) == pytest.approx(exact_std, abs=0.015)

    def test_discrete_selected_leaf_stays_fixed(self):
        from genjax_tpu.inference.requests import MALA

        @g.gen
        def mixed():
            b = g.flip(0.5) @ "b"
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        tr, _ = mixed.generate(KEY, g.C["y"].set(1.0), ())
        new_tr, alpha, _, _ = tr.edit(
            KEY, MALA(g.S["b"] | g.S["mu"], 0.3)
        )
        assert jnp.isfinite(alpha)
        # the Bernoulli choice must remain on-support (untouched)
        assert new_tr.get_choices()["b"] == tr.get_choices()["b"]
        assert not jnp.allclose(
            new_tr.get_choices()["mu"], tr.get_choices()["mu"]
        )
