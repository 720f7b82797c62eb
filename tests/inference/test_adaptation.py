"""Unified warmup adaptation (inference/adaptation.py): shared by the
column kernels and the trace-based sharded drivers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_tpu.inference.adaptation import (
    StepSizeAdaptState,
    adapt_window,
    cross_chain_inv_mass,
    dual_averaging_update,
    multiplicative_nudge,
    rescale_for_metric,
    windowed_warmup,
)


def test_dual_averaging_converges_to_target():
    # accept-rate model: p(accept) = exp(-eps) (monotone in eps); dual
    # averaging should find eps with accept ~ target
    target = 0.65
    state = StepSizeAdaptState.init(0.05)
    for _ in range(200):
        eps = jnp.exp(state.log_eps)
        acc = jnp.exp(-eps)
        state = dual_averaging_update(state, acc, target_accept=target)
    eps_final = jnp.exp(state.log_eps_bar)
    assert jnp.allclose(jnp.exp(-eps_final), target, atol=0.05)


def test_multiplicative_nudge_direction():
    eps = jnp.asarray(0.1)
    assert multiplicative_nudge(eps, 0.95, target_accept=0.8) > eps
    assert multiplicative_nudge(eps, 0.5, target_accept=0.8) < eps


@pytest.mark.parametrize(
    "old, new, factor",
    [
        # every dimension 10^4 x narrower: eps follows the scale (x100)
        ([1.0, 1.0, 1.0], [1e-4, 1e-4, 1e-4], 100.0),
        # every dimension 400 x wider: eps shrinks by 20
        ([1e-4, 1e-4], [4e-2, 4e-2], 0.05),
        # a refinement within 10x is the nudge's job
        ([1.0, 1.0], [0.2, 0.3], 1.0),
        # mixed directions (a correlated or padded metric): unchanged
        ([1.0, 1.0], [1e-4, 1.0], 1.0),
    ],
)
def test_rescale_for_metric(old, new, factor):
    eps = 0.01
    out = rescale_for_metric(eps, jnp.asarray(old), jnp.asarray(new))
    np.testing.assert_allclose(float(out), eps * factor, rtol=1e-5)


def test_adapt_window_carries_eps_across_the_metric():
    # chains that collapsed 10^4 x in every dimension: the nudge, then the
    # rescale (x100), and the new metric
    q = 0.01 * jax.random.normal(jax.random.key(0), (3, 4096))
    eps, im = adapt_window(0.01, jnp.ones(3), 0.8, q)
    np.testing.assert_allclose(np.asarray(im), 1e-4, rtol=0.1)
    np.testing.assert_allclose(float(eps), 0.01 * 100.0, rtol=0.1)


def test_windowed_warmup_reaches_a_narrow_posterior():
    # prior-scale chains (sd 1) and a target 300 x narrower, from the
    # default-sized eps0: once the chains collapse, the step size follows
    # the metric instead of crawling up by the nudge alone
    from genjax_tpu.kernels.hmc import _reference_hmc

    sd = 0.003

    def sweep(q, idx, eps, inv_mass):
        return _reference_hmc(
            lambda q: -0.5 * jnp.sum((q / sd) ** 2, axis=0), q, idx,
            n_steps=50, eps=eps, L=5, inv_mass=inv_mass,
        )

    q0 = jax.random.normal(jax.random.key(1), (4, 512))
    _q, eps, im, accs = jax.jit(
        lambda q0: windowed_warmup(sweep, q0, n_windows=6, eps0=0.1)
    )(q0)
    assert 0.3 < float(eps) < 3.0  # whitened units: O(1) for a Gaussian
    np.testing.assert_allclose(np.asarray(im) / sd**2, 1.0, atol=0.3)
    assert float(accs[-1]) > 0.6


def test_cross_chain_inv_mass_floor():
    q = jnp.zeros((3, 100)).at[0].set(jnp.linspace(-1, 1, 100))
    im = cross_chain_inv_mass(q)
    assert im.shape == (3,)
    assert im[1] == 1e-6  # padding dims floored
    assert im[0] > 0.1


def test_windowed_warmup_is_one_compiled_program():
    # the schedule must be traceable end-to-end (single lax.scan, no host
    # sync inside)
    scales = jnp.array([0.1, 1.0, 4.0])

    def sweep(q, idx, eps, inv_mass):
        # fake sweep: move q toward the target scales, report an
        # eps-dependent accept rate
        k = jax.random.fold_in(jax.random.key(0), idx)
        q = 0.5 * q + scales[:, None] * jax.random.normal(k, q.shape)
        return q, jnp.exp(-eps)

    run = jax.jit(
        lambda q0: windowed_warmup(sweep, q0, n_windows=5, eps0=0.3)
    )
    q, eps, inv_mass, accs = run(jnp.zeros((3, 512)))
    assert accs.shape == (5,)
    assert inv_mass.shape == (3,)
    # inv_mass tracks the cross-chain variances, ordered like the scales
    assert inv_mass[0] < inv_mass[1] < inv_mass[2]
