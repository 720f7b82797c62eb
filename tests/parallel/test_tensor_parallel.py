"""Tensor-parallel (parameter-sharded) log-density: exactness against the
unsharded twin, gradient correctness through the psum, and an end-to-end
sharded column-HMC sweep. Runs on the conftest 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from genjax_tpu.kernels import pallas_hmc
from genjax_tpu.parallel import (
    bnn_logdensity_reference,
    bnn_param_count,
    make_mesh_2d,
    shard_params,
    tensor_parallel_logdensity,
    tp_bnn_logdensity,
)

D_IN, HIDDEN, M, N = 3, 16, 24, 16


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(M, D_IN)).astype(np.float32)
    y = rng.normal(size=(M,)).astype(np.float32)
    return X, y


def _positions(rng_seed=1):
    d = bnn_param_count(D_IN, HIDDEN)
    rng = np.random.default_rng(rng_seed)
    return rng.normal(size=(d, N)).astype(np.float32) * 0.3


class TestTPBNN:
    @pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
    def test_matches_unsharded_value(self, shape):
        X, y = _data()
        mesh = make_mesh_2d(shape, axes=("model", "batch"))
        ld_tp = tp_bnn_logdensity(X, y, HIDDEN, mesh)
        ld_ref = bnn_logdensity_reference(X, y, HIDDEN)
        q = _positions()
        got = jax.jit(ld_tp)(shard_params(jnp.asarray(q), mesh))
        want = ld_ref(jnp.asarray(q))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5
        )

    def test_gradient_matches_unsharded(self):
        X, y = _data()
        mesh = make_mesh_2d((4, 2), axes=("model", "batch"))
        ld_tp = tp_bnn_logdensity(X, y, HIDDEN, mesh)
        ld_ref = bnn_logdensity_reference(X, y, HIDDEN)
        q = jnp.asarray(_positions())

        def sum_tp(q):
            return jnp.sum(ld_tp(q))

        def sum_ref(q):
            return jnp.sum(ld_ref(q))

        g_tp = jax.jit(jax.grad(sum_tp))(shard_params(q, mesh))
        g_ref = jax.grad(sum_ref)(q)
        np.testing.assert_allclose(
            np.asarray(g_tp), np.asarray(g_ref), rtol=5e-5, atol=5e-5
        )

    def test_output_stays_sharded(self):
        """The per-chain log-density comes back sharded over the chain
        axis — no silent full replication of intermediate state."""
        X, y = _data()
        mesh = make_mesh_2d((2, 4), axes=("model", "batch"))
        ld_tp = tp_bnn_logdensity(X, y, HIDDEN, mesh)
        q = shard_params(jnp.asarray(_positions()), mesh)
        out = jax.jit(ld_tp)(q)
        assert out.sharding.is_equivalent_to(
            NamedSharding(mesh, P("batch")), out.ndim
        )

    def test_hmc_sweep_matches_unsharded(self):
        """Two HMC sweeps through the sharded density reproduce the
        unsharded run: same seed -> same accept decisions and positions up
        to psum reassociation."""
        X, y = _data()
        mesh = make_mesh_2d((4, 2), axes=("model", "batch"))
        ld_tp = tp_bnn_logdensity(X, y, HIDDEN, mesh)
        ld_ref = bnn_logdensity_reference(X, y, HIDDEN)
        q0 = jnp.asarray(_positions())

        def run(ld, q):
            return pallas_hmc(
                ld, q, 11, n_steps=3, eps=0.01, L=3
            )

        q_tp, acc_tp = jax.jit(lambda q: run(ld_tp, q))(
            shard_params(q0, mesh)
        )
        q_ref, acc_ref = jax.jit(lambda q: run(ld_ref, q))(q0)
        assert float(acc_ref) > 0.0
        np.testing.assert_allclose(float(acc_tp), float(acc_ref), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(q_tp), np.asarray(q_ref), rtol=1e-4, atol=1e-4
        )

    def test_posterior_moves_toward_data(self):
        """From a far-out-of-typical-set start (4 prior sds), a longer
        sweep raises the posterior log-density (sanity: the sharded
        gradient actually points uphill)."""
        X, y = _data()
        mesh = make_mesh_2d((2, 4), axes=("model", "batch"))
        ld_tp = tp_bnn_logdensity(X, y, HIDDEN, mesh)
        q0 = shard_params(jnp.asarray(_positions(5)) * 13.0, mesh)
        lp0 = jnp.mean(jax.jit(ld_tp)(q0))
        q1, acc = jax.jit(
            lambda q: pallas_hmc(
                ld_tp, q, 3, n_steps=25, eps=0.02, L=5
            )
        )(q0)
        lp1 = jnp.mean(jax.jit(ld_tp)(q1))
        assert float(acc) > 0.2
        assert float(lp1) > float(lp0)

    def test_hidden_not_divisible_raises(self):
        X, y = _data()
        mesh = make_mesh_2d((8, 1), axes=("model", "batch"))
        with pytest.raises(ValueError, match="divisible"):
            tp_bnn_logdensity(X, y, 12, mesh)


class TestGenericTP:
    def test_quadratic_partial_sums(self):
        """tensor_parallel_logdensity on a plain factorized quadratic:
        shard partials psum to the full -0.5||q||^2 regardless of mesh
        shape."""
        mesh = make_mesh_2d((4, 2), axes=("model", "batch"))
        ld = tensor_parallel_logdensity(
            lambda qb: {"ss": jnp.sum(qb * qb, axis=0)},
            lambda s: -0.5 * s["ss"],
            mesh,
        )
        q = jnp.asarray(
            np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
        )
        got = jax.jit(ld)(shard_params(q, mesh))
        np.testing.assert_allclose(
            np.asarray(got), -0.5 * np.sum(np.asarray(q) ** 2, axis=0),
            rtol=1e-5, atol=1e-5,
        )
