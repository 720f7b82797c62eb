"""Multi-device tests on a simulated 8-device CPU mesh (conftest forces
``xla_force_host_platform_device_count=8``) — the test strategy addition
SURVEY.md §4 calls for beyond the reference's single-process suite."""

import jax
import jax.numpy as jnp
import pytest

import genjax_tpu as g
from genjax_tpu.parallel import (
    SSMParticleFilter,
    make_mesh,
    run_chains_sharded,
    sharded_importance,
    systematic_indices,
    stratified_indices,
    multinomial_indices,
    residual_indices,
    effective_sample_size,
    warmup_adapt_step_size,
)

KEY = jax.random.key(314159)


@g.gen
def ssm_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def exact_lgss_logZ(ys, trans_sd=1.0, obs_sd=0.5):
    """Kalman-filter log-marginal for the linear-Gaussian SSM z_t ~ N(z_{t-1},
    q); y_t ~ N(z_t, r); z_0 prior N(0, q)."""
    q, r = trans_sd**2, obs_sd**2
    mean, var = 0.0, q
    logZ = 0.0
    for y in ys:
        s = var + r
        logZ += -0.5 * (jnp.log(2 * jnp.pi * s) + (y - mean) ** 2 / s)
        kgain = var / s
        mean = mean + kgain * (y - mean)
        var = var * (1 - kgain) + q
    return logZ


class TestResamplingIndices:
    @pytest.mark.slow
    def test_all_methods_preserve_distribution(self):
        lw = jnp.log(jnp.array([0.1, 0.2, 0.3, 0.4]))
        for fn in [
            systematic_indices,
            stratified_indices,
            multinomial_indices,
            residual_indices,
        ]:
            idx = jax.vmap(lambda k: fn(k, lw, 4))(jax.random.split(KEY, 4000))
            freqs = jnp.bincount(idx.reshape(-1), length=4) / idx.size
            assert jnp.allclose(
                freqs, jnp.array([0.1, 0.2, 0.3, 0.4]), atol=0.02
            ), fn.__name__

    def test_ess(self):
        assert effective_sample_size(jnp.zeros(10)) == pytest.approx(10.0)
        degenerate = jnp.log(jnp.array([1.0, 1e-20, 1e-20]))
        assert effective_sample_size(degenerate) == pytest.approx(1.0, abs=1e-3)


class TestParticleFilter:
    def test_single_device_matches_kalman(self):
        T = 10
        ys = jnp.sin(jnp.linspace(0, 2, T))
        pf = SSMParticleFilter(ssm_kernel, n_particles=4096)
        res = pf.run(KEY, 0.0, jnp.zeros(T), g.C[:, "y"].set(ys))
        exact = exact_lgss_logZ(ys)
        assert res.log_marginal == pytest.approx(exact, abs=0.1)

    def test_sharded_matches_kalman_local_mode(self):
        T = 10
        ys = jnp.sin(jnp.linspace(0, 2, T))
        mesh = make_mesh()
        pf = SSMParticleFilter(ssm_kernel, n_particles=4096)
        res = pf.run_sharded(
            KEY, 0.0, jnp.zeros(T), g.C[:, "y"].set(ys), mesh
        )
        exact = exact_lgss_logZ(ys)
        assert res.log_marginal == pytest.approx(exact, abs=0.1)
        # particle axis is actually sharded
        assert len(res.carries.sharding.device_set) == len(jax.devices())

    def test_sharded_all_gather_mode(self):
        T = 6
        ys = jnp.ones(T)
        mesh = make_mesh()
        pf = SSMParticleFilter(ssm_kernel, n_particles=1024)
        res = pf.run_sharded(
            KEY,
            0.0,
            jnp.zeros(T),
            g.C[:, "y"].set(ys),
            mesh,
            resample_mode="all_gather",
        )
        exact = exact_lgss_logZ(ys)
        assert res.log_marginal == pytest.approx(exact, abs=0.15)

    def test_sharded_matches_unsharded_statistically(self):
        T = 5
        ys = jnp.zeros(T)
        mesh = make_mesh()
        pf = SSMParticleFilter(ssm_kernel, n_particles=2048)
        r1 = pf.run(KEY, 0.0, jnp.zeros(T), g.C[:, "y"].set(ys))
        r2 = pf.run_sharded(KEY, 0.0, jnp.zeros(T), g.C[:, "y"].set(ys), mesh)
        assert r1.log_marginal == pytest.approx(r2.log_marginal, abs=0.1)


class TestShardedImportance:
    def test_logZ(self):
        @g.gen
        def flip_model():
            p = g.beta(2.0, 2.0) @ "p"
            v = g.flip(p) @ "v"

        obs = g.C["v"].set(True)
        mesh = make_mesh()
        trs, ws, logZ = sharded_importance(
            lambda k: flip_model.importance(k, obs, ()),
            KEY,
            4096,
            mesh,
        )
        assert logZ == pytest.approx(jnp.log(0.5), abs=0.05)


class TestShardedChains:
    def test_chains_match_posterior(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        obs = g.C["y"].set(2.0)

        def make_trace(k):
            tr, _ = model.generate(k, obs, ())
            return tr

        mesh = make_mesh()
        res = run_chains_sharded(
            KEY,
            make_trace,
            g.HMC(g.S["mu"], 0.3, L=10),
            n_steps=60,
            n_chains=1024,
            mesh=mesh,
            record=lambda t: t.get_choices()["mu"],
        )
        finals = res.history[:, -1]
        assert jnp.mean(finals) == pytest.approx(1.0, abs=0.1)
        assert jnp.std(finals) == pytest.approx(1.0 / jnp.sqrt(2.0), abs=0.1)


class TestResamplingPrimitives:
    def test_counts_sum_to_n_and_match_indices(self):
        from genjax_tpu.parallel import (
            redistribute,
            stratified_counts,
            systematic_counts,
        )

        lw = jnp.log(jnp.array([0.05, 0.15, 0.3, 0.5]))
        for counts_fn in (systematic_counts, stratified_counts):
            counts = counts_fn(KEY, lw, 8)
            assert int(jnp.sum(counts)) == 8
            # redistribute = monotone repeat of sources by counts
            out = redistribute(jnp.arange(4.0), counts, 8)
            expected = jnp.repeat(
                jnp.arange(4.0), counts, total_repeat_length=8
            )
            assert jnp.array_equal(out, expected)

    def test_resample_particles_pytree(self):
        from genjax_tpu.parallel import resample_particles

        particles = {"a": jnp.arange(4.0), "b": jnp.arange(8.0).reshape(4, 2)}
        lw = jnp.log(jnp.array([1e-9, 1e-9, 1.0, 1e-9]))
        for method in ("systematic", "stratified", "multinomial", "residual"):
            out = resample_particles(KEY, particles, lw, 4, method)
            # the dominant particle (index 2) wins every slot
            assert jnp.allclose(out["a"], 2.0), method
            assert jnp.allclose(out["b"], particles["b"][2]), method


class TestMeshHelpers:
    def test_shard_batch_places_leading_axis(self):
        from genjax_tpu.parallel import make_mesh, shard_batch

        mesh = make_mesh()
        n_dev = len(jax.devices())
        tree = {"x": jnp.zeros((n_dev * 4, 3)), "s": jnp.asarray(1.0)}
        placed = shard_batch(tree, mesh)
        assert len(placed["x"].sharding.device_set) == n_dev
        # scalar leaves replicate
        assert placed["s"].sharding.is_fully_replicated

    def test_host_local_mesh_single_process(self):
        from genjax_tpu.parallel import host_local_mesh

        mesh = host_local_mesh()
        assert mesh.devices.size == len(jax.local_devices())


class TestCollectiveResample:
    def _run(self, mode):
        import inspect

        from jax.sharding import PartitionSpec as P

        from genjax_tpu.parallel import (
            collective_resample,
            make_mesh,
            shard_map_compat,
        )

        mesh = make_mesh()
        n_dev = len(jax.devices())
        k = 64 * n_dev

        def prog(key, particles, lw):
            return collective_resample(
                key, particles, lw, "batch", mode=mode
            )

        f = shard_map_compat(
            prog,
            mesh=mesh,
            in_specs=(P(), P("batch"), P("batch")),
            out_specs=(P("batch"), P("batch"), P()),
        )
        particles = jnp.arange(float(k))
        # weight mass concentrated on particle 7
        lw = jnp.where(jnp.arange(k) == 7, 5.0, -5.0)
        return jax.jit(f)(KEY, particles, lw), particles, lw

    def test_all_gather_mode_exact(self):
        (new_p, new_lw, inc), particles, lw = self._run("all_gather")
        # nearly all slots resample to the dominant particle
        frac = jnp.mean(new_p == 7.0)
        assert float(frac) > 0.9
        assert jnp.allclose(new_lw, 0.0)
        # increment equals the global mean-weight normalizer
        from jax.scipy.special import logsumexp

        expected = logsumexp(lw) - jnp.log(lw.shape[0])
        assert float(inc) == pytest.approx(float(expected), abs=1e-4)

    def test_local_mode_keeps_global_weighting(self):
        (new_p, new_lw, inc), particles, lw = self._run("local")
        from jax.scipy.special import logsumexp

        expected = logsumexp(lw) - jnp.log(lw.shape[0])
        assert float(inc) == pytest.approx(float(expected), abs=1e-4)
        # local mode: post-resampling weights are per-shard constants whose
        # global logsumexp reproduces total mass (proper weighting)
        total = logsumexp(new_lw) - jnp.log(new_lw.shape[0])
        assert float(total) == pytest.approx(0.0, abs=1e-4)


class TestStepSizeAdaptation:
    def test_dual_averaging_reaches_target_accept(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        obs = g.C["y"].set(1.0)

        def make_trace(k):
            tr, _ = model.generate(k, obs, ())
            return tr

        traces = jax.vmap(make_trace)(jax.random.split(KEY, 256))
        traces, eps = warmup_adapt_step_size(
            KEY,
            traces,
            lambda e: g.HMC(g.S["mu"], e, L=5),
            n_warmup=100,
            eps0=2.0,  # deliberately far too large
        )
        assert 0.05 < float(eps) < 1.5
        # verify the adapted step size achieves a reasonable accept rate
        def one(k, tr):
            new_tr, alpha, _, _ = tr.edit(k, g.HMC(g.S["mu"], eps, L=5))
            return jnp.minimum(1.0, jnp.exp(alpha))

        accs = jax.vmap(one)(jax.random.split(KEY, 256), traces)
        assert 0.6 < float(jnp.mean(accs)) <= 1.0


class TestShardedColumnSweeps:
    """The fused column kernels advertise chain-axis sharding for
    multi-chip runs (`kernels/hmc.py`, `kernels/nuts.py` docstrings); pin
    that the sweeps compile and recover the posterior with the chain
    (lane) axis sharded over the mesh under GSPMD."""

    def _sharded_q0(self, d, n, fill):
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh()
        q0 = jnp.full((d, n), fill, jnp.float32)
        return jax.device_put(q0, NamedSharding(mesh, P(None, "batch")))

    def test_nuts_sweep_sharded_chain_axis(self):
        from genjax_tpu.kernels.nuts import nuts_sweep_cols

        def ld(q):
            return jnp.sum(-0.5 * q * q, axis=0)

        q0 = self._sharded_q0(3, 1024, 2.0)
        qf, acc, _leaps = jax.jit(
            lambda q: nuts_sweep_cols(
                ld, q, 5, n_steps=40, eps=0.4, max_depth=6, batched=True
            )
        )(q0)
        assert float(acc) > 0.8
        assert float(jnp.mean(qf)) == pytest.approx(0.0, abs=0.12)
        assert float(jnp.std(qf)) == pytest.approx(1.0, abs=0.12)

    def test_column_hmc_sharded_chain_axis(self):
        from genjax_tpu.kernels.hmc import pallas_hmc

        def ld(q):
            return jnp.sum(-0.5 * q * q, axis=0)

        q0 = self._sharded_q0(4, 1024, 2.0)
        qf, acc = jax.jit(
            lambda q: pallas_hmc(
                ld, q, 9, n_steps=60, eps=0.4, L=5
            )
        )(q0)
        assert float(acc) > 0.7
        assert float(jnp.std(qf)) == pytest.approx(1.0, abs=0.12)


class TestCompileCaching:
    def test_run_chains_sharded_reuses_compiled_program(self):
        """Repeat calls with the same callables/shapes must hit the jit
        cache (per-call closures re-traced + re-compiled the full
        multi-chip program every call)."""
        import genjax_tpu as g
        from genjax_tpu.parallel import make_mesh
        from genjax_tpu.parallel.mcmc import _run_chains_jit, run_chains_sharded

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        def make_trace(k):
            tr, _ = model.generate(k, g.C["y"].set(1.0), ())
            return tr

        mesh = make_mesh()
        req = g.HMC(g.S["mu"], 0.2, L=3)
        before = _run_chains_jit._cache_size()
        run_chains_sharded(jax.random.key(0), make_trace, req, 5, 16, mesh)
        after_first = _run_chains_jit._cache_size()
        run_chains_sharded(jax.random.key(1), make_trace, req, 5, 16, mesh)
        assert _run_chains_jit._cache_size() == after_first > before


def _make_shard_map(prog, in_specs, out_specs):
    from genjax_tpu.parallel import shard_map_compat

    return shard_map_compat(
        prog, mesh=make_mesh(), in_specs=in_specs, out_specs=out_specs
    )


class TestCollectiveWeightStats:
    """The fused per-step reduction (one pmax + one stacked psum) that
    serves BOTH the adaptive-resampling ESS decision and the logZ
    normalizer (parallel/resampling.py collective_weight_stats)."""

    def test_matches_unsharded_ess_and_normalizer(self):
        from jax.scipy.special import logsumexp
        from jax.sharding import PartitionSpec as P

        from genjax_tpu.parallel import collective_weight_stats

        n_dev = len(jax.devices())
        k = 64 * n_dev
        lw = jax.random.normal(KEY, (k,)) * 3.0

        f = _make_shard_map(
            lambda lw: collective_weight_stats(lw, "batch"),
            in_specs=(P("batch"),),
            out_specs=(P(), P()),
        )
        ess, log_norm = jax.jit(f)(lw)

        w = jnp.exp(lw - jnp.max(lw))
        ess_true = jnp.sum(w) ** 2 / jnp.sum(w * w)
        log_norm_true = logsumexp(lw) - jnp.log(float(k))
        assert float(ess) == pytest.approx(float(ess_true), rel=1e-5)
        assert float(log_norm) == pytest.approx(
            float(log_norm_true), rel=1e-5
        )

    def test_resample_log_z_inc_passthrough(self):
        """collective_resample with a precomputed normalizer must produce
        exactly the outputs of the self-computing path (same key), so the
        fused-stats caller saves collectives without changing semantics."""
        from jax.sharding import PartitionSpec as P

        from genjax_tpu.parallel import (
            collective_resample,
            collective_weight_stats,
        )

        n_dev = len(jax.devices())
        k = 64 * n_dev
        particles = jnp.arange(float(k))
        lw = jax.random.normal(jax.random.key(5), (k,))

        def prog(key, particles, lw, precompute):
            def with_inc(_):
                _, inc = collective_weight_stats(lw, "batch")
                return collective_resample(
                    key, particles, lw, "batch", mode="local", log_z_inc=inc
                )

            def without(_):
                return collective_resample(
                    key, particles, lw, "batch", mode="local"
                )

            return jax.lax.cond(precompute, with_inc, without, None)

        f = jax.jit(
            _make_shard_map(
                prog,
                in_specs=(P(), P("batch"), P("batch"), P()),
                out_specs=(P("batch"), P("batch"), P()),
            )
        )
        out_pre = f(KEY, particles, lw, jnp.asarray(True))
        out_self = f(KEY, particles, lw, jnp.asarray(False))
        for a, b in zip(out_pre, out_self):
            assert jnp.allclose(a, b, rtol=1e-5), (a, b)
