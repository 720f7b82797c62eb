"""Involutive MCMC validated against closed forms.

Checks (CLAUDE.md convention): Jacobian log-determinants against
hand-derived formulas (deterministic, 1e-5), acceptance ratios against
hand-computed densities, and chain stationarity against conjugate
posteriors."""

import pytest

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax.scipy.stats import norm

import genjax_tpu as g
from genjax_tpu import gen, normal
from genjax_tpu.inference.gibbs import gibbs_sweep
from genjax_tpu.generative.choice_map import ChoiceMap as _CM


def ChoiceMapEmpty():
    return _CM.empty()


from genjax_tpu.inference.involutive import (
    InvolutiveInfo,
    involutive_mh,
    involutive_move,
)

# Conjugate target: mu ~ N(0,1), x ~ N(mu, 1), observe x.
X_OBS = 1.2
POST_MEAN, POST_STD = X_OBS / 2.0, np.sqrt(0.5)


@gen
def conj_model():
    mu = normal(0.0, 1.0) @ "mu"
    x = normal(mu, 1.0) @ "x"
    return x


@gen
def rw_aux():
    eps = normal(0.0, 0.6) @ "eps"
    return eps


def rw_involution(t, u):
    mu, eps = t["mu"], u["eps"]
    t_new = g.C["mu"].set(mu + eps) | g.C["x"].set(t["x"])
    return t_new, g.C["eps"].set(-eps)


def _conj_trace(key):
    tr, _ = conj_model.generate(key, g.C["x"].set(X_OBS), ())
    return tr


class TestRandomWalk:
    def test_logdet_zero_and_involution_exact(self):
        tr = _conj_trace(jr.PRNGKey(0))
        _, info = involutive_mh(
            jr.PRNGKey(1), tr, rw_aux, rw_involution, check=True
        )
        np.testing.assert_allclose(float(info.logdet), 0.0, atol=1e-5)
        np.testing.assert_allclose(
            float(info.involution_error), 0.0, atol=1e-6
        )

    def test_alpha_matches_hand_computed(self):
        """Symmetric RW: α must be the posterior density ratio at
        mu' = mu + eps (the aux scores cancel by symmetry of N(0, σ))."""
        tr = _conj_trace(jr.PRNGKey(0))
        mu = float(tr.get_choices()["mu"])
        key = jr.PRNGKey(7)
        _, info = involutive_mh(key, tr, rw_aux, rw_involution)
        # Recover the proposed eps deterministically: same key split as
        # inside involutive_mh.
        k_aux, _, _ = jr.split(key, 3)
        eps = float(rw_aux.simulate(k_aux, ()).get_choices()["eps"])
        lp = lambda m: norm.logpdf(m, 0.0, 1.0) + norm.logpdf(X_OBS, m, 1.0)
        expected = float(lp(mu + eps) - lp(mu))
        np.testing.assert_allclose(float(info.alpha), expected, atol=1e-4)

    def test_chain_hits_conjugate_posterior(self):
        tr = _conj_trace(jr.PRNGKey(0))
        move = involutive_move(rw_aux, rw_involution)
        res = gibbs_sweep(
            jr.PRNGKey(1),
            tr,
            [move],
            n_sweeps=4000,
            record=lambda t: t.get_choices()["mu"],
        )
        mus = np.asarray(res.history)[500:]
        np.testing.assert_allclose(mus.mean(), POST_MEAN, atol=0.06)
        np.testing.assert_allclose(mus.std(), POST_STD, atol=0.06)


@gen
def scale_aux():
    u = normal(0.0, 0.4) @ "u"
    return u


def scale_involution(t, u):
    s, du = t["sigma"], u["u"]
    return g.C["sigma"].set(s * jnp.exp(du)), g.C["u"].set(-du)


@gen
def lognormal_model():
    sigma = g.log_normal(0.0, 1.0) @ "sigma"
    return sigma


class TestScaleMove:
    def test_logdet_exact(self):
        """x' = x·e^u, u' = -u ⇒ J = [[e^u, x e^u], [0, -1]],
        log|det J| = u."""
        tr = lognormal_model.simulate(jr.PRNGKey(0), ())
        key = jr.PRNGKey(3)
        _, info = involutive_mh(
            key, tr, scale_aux, scale_involution, check=True
        )
        k_aux, _, _ = jr.split(key, 3)
        u = float(scale_aux.simulate(k_aux, ()).get_choices()["u"])
        np.testing.assert_allclose(float(info.logdet), u, atol=1e-5)
        np.testing.assert_allclose(
            float(info.involution_error), 0.0, atol=1e-6
        )

    def test_chain_preserves_lognormal_prior(self):
        """With no observations the stationary law is the prior: log(sigma)
        must come out N(0, 1)."""
        tr = lognormal_model.simulate(jr.PRNGKey(0), ())
        move = involutive_move(scale_aux, scale_involution)
        res = gibbs_sweep(
            jr.PRNGKey(1),
            tr,
            [move],
            n_sweeps=6000,
            record=lambda t: jnp.log(t.get_choices()["sigma"]),
        )
        ls = np.asarray(res.history)[500:]
        np.testing.assert_allclose(ls.mean(), 0.0, atol=0.12)
        np.testing.assert_allclose(ls.std(), 1.0, atol=0.12)


class TestChecks:
    def test_non_involution_flagged(self):
        def broken(t, u):
            t_new = g.C["mu"].set(t["mu"] + 1.0) | g.C["x"].set(t["x"])
            return t_new, g.C["eps"].set(-u["eps"])

        tr = _conj_trace(jr.PRNGKey(0))
        _, info = involutive_mh(jr.PRNGKey(1), tr, rw_aux, broken, check=True)
        assert float(info.involution_error) > 0.5

    def test_dimension_imbalance_raises(self):
        def drops_u(t, u):
            # Emits only part of the state: continuous dims 3 in, 2 out.
            t_new = g.C["mu"].set(t["mu"]) | g.C["x"].set(t["x"])
            return t_new, ChoiceMapEmpty()

        tr = _conj_trace(jr.PRNGKey(0))
        try:
            involutive_mh(jr.PRNGKey(1), tr, rw_aux, drops_u)
            raise AssertionError("expected dimension-balance ValueError")
        except ValueError as e:
            assert "dimension-balanced" in str(e)

    def test_jacobian_zero_mode(self):
        tr = _conj_trace(jr.PRNGKey(0))
        _, info = involutive_mh(
            jr.PRNGKey(1), tr, rw_aux, rw_involution, jacobian="zero"
        )
        np.testing.assert_allclose(float(info.logdet), 0.0)


# ---------------------------------------------------------------------
# Reversible jump, saturated-space formulation (Brooks, Giudici &
# Roberts 2003): every block is always sampled (fixed shapes — the
# jit-native representation), the likelihood selects by `k`, dormant
# blocks sit at their pseudo-prior. All coordinates are scored, so the
# involutive acceptance is exact with no trans-dimensional bookkeeping.
# ---------------------------------------------------------------------

YS = jnp.asarray([-0.8, -0.5, 0.4, 0.7])  # exact p(k=1 | ys) ≈ 0.517


@gen
def sat_model():
    k = g.flip(0.5) @ "k"
    theta = normal(0.0, 2.0) @ "theta"  # 1-component location
    a = normal(0.0, 2.0) @ "a"  # 2-component locations
    b = normal(0.0, 2.0) @ "b"
    mus = jnp.where(k, jnp.stack([a, a, b, b]), jnp.full(4, theta))
    _ = normal.vmap(in_axes=(0, None))(mus, 0.8) @ "ys"
    return k


@gen
def jump_aux():
    du = normal(0.0, 1.2) @ "du"
    return du


def jump_involution(t, u):
    """k-independent bijection: (theta, du) <-> (a, b) by split/merge.

    a' = theta − du, b' = theta + du (det 2); theta' = (a+b)/2,
    du' = (b−a)/2 (det 1/2); net log|det| = 0. Applying twice restores
    everything, for either k."""
    theta, a, b, du = t["theta"], t["a"], t["b"], u["du"]
    t_new = (
        g.C["k"].set(jnp.logical_not(t["k"]))
        | g.C["theta"].set((a + b) / 2.0)
        | g.C["a"].set(theta - du)
        | g.C["b"].set(theta + du)
        | g.C["ys", :].set(t["ys", :])
    )
    return t_new, g.C["du"].set((b - a) / 2.0)


@gen
def refresh_aux():
    u1 = normal(0.0, 2.0) @ "u1"
    u2 = normal(0.0, 2.0) @ "u2"
    return u1 + u2


def refresh_involution(t, u):
    """Swap the dormant block with fresh pseudo-prior draws — a perfect
    Gibbs refresh (α = 0 exactly since q equals the pseudo-prior), and a
    traced-k-dependent permutation (log|det| = 0)."""
    k = t["k"]
    theta, a, b = t["theta"], t["a"], t["b"]
    u1, u2 = u["u1"], u["u2"]
    t_new = (
        g.C["k"].set(k)
        | g.C["theta"].set(jnp.where(k, u1, theta))
        | g.C["a"].set(jnp.where(k, a, u1))
        | g.C["b"].set(jnp.where(k, b, u2))
        | g.C["ys", :].set(t["ys", :])
    )
    u_new = g.C["u1"].set(jnp.where(k, theta, a)) | g.C["u2"].set(
        jnp.where(k, u2, b)
    )
    return t_new, u_new


def sat_rw_involution(t, u):
    """Random walk on the LIVE block only (where-selected by traced k)."""
    k = t["k"]
    eps = u["eps"]
    t_new = (
        g.C["k"].set(k)
        | g.C["theta"].set(t["theta"] + jnp.where(k, 0.0, eps))
        | g.C["a"].set(t["a"] + jnp.where(k, eps, 0.0))
        | g.C["b"].set(t["b"] - jnp.where(k, eps, 0.0))
        | g.C["ys", :].set(t["ys", :])
    )
    return t_new, g.C["eps"].set(-eps)


class TestReversibleJump:
    def _trace(self, key):
        cm = g.C["k"].set(False) | g.C["ys", :].set(YS)
        tr, _ = sat_model.generate(key, cm, ())
        return tr

    def test_jump_involution_exact_and_volume_preserving(self):
        tr = self._trace(jr.PRNGKey(0))
        _, info = involutive_mh(
            jr.PRNGKey(1), tr, jump_aux, jump_involution, check=True
        )
        assert np.isfinite(float(info.alpha))
        np.testing.assert_allclose(float(info.logdet), 0.0, atol=1e-5)
        np.testing.assert_allclose(
            float(info.involution_error), 0.0, atol=1e-5
        )

    def test_refresh_always_accepts(self):
        """q == pseudo-prior ⇒ α = 0 exactly."""
        tr = self._trace(jr.PRNGKey(0))
        _, info = involutive_mh(
            jr.PRNGKey(5), tr, refresh_aux, refresh_involution, check=True
        )
        np.testing.assert_allclose(float(info.alpha), 0.0, atol=1e-4)
        np.testing.assert_allclose(
            float(info.involution_error), 0.0, atol=1e-5
        )

    @pytest.mark.slow
    def test_rj_chain_matches_enumerated_posterior(self):
        """Exact check: p(k | ys) by conjugate marginalization (both
        structures are linear-Gaussian; pseudo-priors integrate out)."""

        def branch_logml(design):
            # ys = design @ z + noise, z ~ N(0, 2² I): marginal
            # ys ~ N(0, 4·design·designᵀ + 0.64 I).
            cov = 4.0 * design @ design.T + 0.64 * np.eye(4)
            y = np.asarray(YS)
            _s, ld = np.linalg.slogdet(2 * np.pi * cov)
            return -0.5 * (ld + y @ np.linalg.solve(cov, y))

        lm0 = branch_logml(np.ones((4, 1)))
        lm1 = branch_logml(np.array([[1.0, 0], [1, 0], [0, 1], [0, 1]]))
        p_k1 = 1.0 / (1.0 + np.exp(lm0 - lm1))

        tr = self._trace(jr.PRNGKey(0))
        moves = [
            involutive_move(jump_aux, jump_involution),
            involutive_move(rw_aux, sat_rw_involution),
            involutive_move(refresh_aux, refresh_involution),
        ]
        res = gibbs_sweep(
            jr.PRNGKey(2),
            tr,
            moves,
            n_sweeps=8000,
            record=lambda t: t.get_choices()["k"],
        )
        ks = np.asarray(res.history)[1000:]
        np.testing.assert_allclose(ks.mean(), p_k1, atol=0.06)
