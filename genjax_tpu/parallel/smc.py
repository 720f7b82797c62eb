"""Sharded SMC drivers: sequential importance resampling over state-space
models with particles sharded across a device mesh.

No reference counterpart (the reference's SMC is single-shard ``vmap``,
smc.py:298-315) — this is the BASELINE.json north-star driver: the particle
axis shards over the mesh; per-step weighting is embarrassingly parallel; ESS,
log-normalizers, and resampling use XLA collectives inside one jitted
``shard_map`` program.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from .resampling import (
    collective_resample,
    collective_weight_stats,
    effective_sample_size,
    resample_particles,
)


@Pytree.dataclass
class ParticleFilterResult(Pytree):
    """Final carries/weights plus the log-marginal-likelihood estimate."""

    carries: Any
    log_weights: Any
    log_marginal: Any
    ess_history: Any


@Pytree.dataclass
class SSMParticleFilter(Pytree):
    """Sequential importance resampling for a scanned kernel
    ``(carry, x) -> (carry, y)`` whose per-step observations are constrained.

    Per step ``t``: each particle extends via ``kernel.generate`` under the
    observation submap at ``t``; weights accumulate; when ESS drops below
    ``ess_threshold * K`` the collection resamples (adaptive, inside
    ``lax.cond`` — fixed shapes, no host sync).
    """

    kernel: GenerativeFunction
    n_particles: int = Pytree.static()
    ess_threshold: float = Pytree.static(default=0.5)
    method: str = Pytree.static(default="systematic")

    # ------------------------------------------------------------------
    # single-device (vmapped) driver
    # ------------------------------------------------------------------

    def run(
        self,
        key: PRNGKey,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        *,
        n_steps: int | None = None,
    ) -> ParticleFilterResult:
        k = self.n_particles
        leaves = jtu.tree_leaves(xs)
        t_count = leaves[0].shape[0] if leaves else n_steps
        if t_count is None:
            raise ValueError(
                "SSMParticleFilter.run: xs is None/empty — pass n_steps."
            )

        def broadcast(c):
            return jtu.tree_map(
                lambda v: jnp.broadcast_to(jnp.asarray(v), (k,) + jnp.shape(v)),
                c,
            )

        def step(state, inp):
            carries, log_w, log_z = state
            t, x = inp
            # Split once per step so the resampling key cannot alias any
            # particle key: with fold_in(k, i) == split(k, n)[i] in this
            # JAX version, fold_in(step_key, C) would equal pkeys[C] for
            # large particle counts (advisor round-1 finding).
            extend_key, resample_key = jr.split(jr.fold_in(key, t))

            def extend(pkey, c):
                submap = constraint.get_submap(t)
                tr, w = self.kernel.generate(pkey, submap, (c, x))
                c_new, _y = tr.get_retval()
                return c_new, w

            pkeys = jr.split(extend_key, k)
            carries, ws = jax.vmap(extend)(pkeys, carries)
            log_w = log_w + ws

            ess = effective_sample_size(log_w)

            def do_resample(args):
                carries, log_w, log_z = args
                inc = logsumexp(log_w) - jnp.log(k)
                carries = resample_particles(
                    resample_key, carries, log_w, k, self.method
                )
                return carries, jnp.zeros((k,)), log_z + inc

            def skip(args):
                return args

            carries, log_w, log_z = lax.cond(
                ess < self.ess_threshold * k,
                do_resample,
                skip,
                (carries, log_w, log_z),
            )
            return (carries, log_w, log_z), ess

        init = (broadcast(init_carry), jnp.zeros((k,)), jnp.asarray(0.0))
        (carries, log_w, log_z), ess_hist = lax.scan(
            step, init, (jnp.arange(t_count), xs)
        )
        log_marginal = log_z + logsumexp(log_w) - jnp.log(k)
        return ParticleFilterResult(carries, log_w, log_marginal, ess_hist)

    # ------------------------------------------------------------------
    # sharded driver (shard_map over the particle axis)
    # ------------------------------------------------------------------

    def run_sharded(
        self,
        key: PRNGKey,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        mesh: Mesh,
        *,
        axis: str = "batch",
        resample_mode: str = "local",
        n_steps: int | None = None,
    ) -> ParticleFilterResult:
        """The multi-chip path: one jitted ``shard_map`` program; particles
        stay resident on their chip; ESS/normalizer/resampling are
        collectives."""
        n_shards = mesh.shape[axis]
        assert self.n_particles % n_shards == 0, (
            f"n_particles={self.n_particles} must divide over {n_shards} shards"
        )
        carries, log_w, log_marginal, ess_hist = _pf_run_sharded(
            self, key, init_carry, xs, constraint,
            mesh=mesh, axis=axis, resample_mode=resample_mode,
            n_steps=n_steps,
        )
        return ParticleFilterResult(carries, log_w, log_marginal, ess_hist)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "resample_mode", "n_steps"),
)
def _pf_run_sharded(
    pf, key, init_carry, xs, constraint, *, mesh, axis, resample_mode, n_steps
):
    # Module-level jit, with the filter riding along as a pytree argument
    # (its static fields and kernel land in the treedef cache key) — NOT a
    # per-call closure, so repeat calls with the same model/shapes reuse
    # the compiled program instead of paying the 10-400 s remote
    # re-compile each time (CLAUDE.md).
    n_shards = mesh.shape[axis]
    k = pf.n_particles
    k_local = k // n_shards

    def shard_program(key, init_carry, xs, constraint):
        shard = lax.axis_index(axis)
        xs_leaves = jtu.tree_leaves(xs)
        t_count = xs_leaves[0].shape[0] if xs_leaves else n_steps
        if t_count is None:
            raise ValueError(
                "run_sharded: xs is None/empty — pass n_steps."
            )

        def broadcast(c):
            return jtu.tree_map(
                lambda v: jnp.broadcast_to(
                    jnp.asarray(v), (k_local,) + jnp.shape(v)
                ),
                c,
            )

        def step(state, inp):
            carries, log_w, log_z = state
            t, x = inp
            # Same aliasing fix as ``run``: distinct parents for
            # particle-extension keys and the resampling key.
            extend_key, resample_key = jr.split(jr.fold_in(key, t))

            def extend(pkey, c):
                submap = constraint.get_submap(t)
                tr, w = pf.kernel.generate(pkey, submap, (c, x))
                c_new, _y = tr.get_retval()
                return c_new, w

            pkeys = jr.split(jr.fold_in(extend_key, shard), k_local)
            carries, ws = jax.vmap(extend)(pkeys, carries)
            log_w = log_w + ws

            # ONE fused collective pair per step: global ESS for the
            # adaptive-resampling decision AND the normalizer the resample
            # branch needs — so resampling adds no further reductions in
            # "local" mode (all_gather mode still pays its gathers)
            ess, log_z_inc = collective_weight_stats(log_w, axis)

            def do_resample(args):
                carries, log_w, log_z = args
                new_c, new_lw, inc = collective_resample(
                    resample_key,
                    carries,
                    log_w,
                    axis,
                    method=pf.method,
                    mode=resample_mode,
                    log_z_inc=log_z_inc,
                )
                return new_c, new_lw, log_z + inc

            carries, log_w, log_z = lax.cond(
                ess < pf.ess_threshold * k,
                do_resample,
                lambda a: a,
                (carries, log_w, log_z),
            )
            return (carries, log_w, log_z), ess

        init = (broadcast(init_carry), jnp.zeros((k_local,)), jnp.asarray(0.0))
        (carries, log_w, log_z), ess_hist = lax.scan(
            step, init, (jnp.arange(t_count), xs)
        )
        # final global normalizer
        g_max = lax.pmax(jnp.max(log_w), axis)
        total = lax.psum(jnp.sum(jnp.exp(log_w - g_max)), axis)
        log_marginal = log_z + g_max + jnp.log(total) - jnp.log(k)
        return carries, log_w, log_marginal, ess_hist

    from .mesh import shard_map_compat

    program = shard_map_compat(
        shard_program,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(), P()),
    )
    return program(key, init_carry, xs, constraint)


def sharded_importance(
    target_importance,
    key: PRNGKey,
    k_particles: int,
    mesh: Mesh,
    *,
    axis: str = "batch",
):
    """Embarrassingly-parallel importance sampling over a mesh: the key batch
    is sharded; XLA partitions the vmapped program and inserts the logsumexp
    collectives for the final normalizer.

    ``target_importance(key) -> (trace, log_weight)``.
    """
    keys = jr.split(key, k_particles)
    keys = jax.device_put(keys, NamedSharding(mesh, P(axis)))
    return _sharded_importance_jit(keys, target_importance)


@functools.partial(jax.jit, static_argnames=("target_importance",))
def _sharded_importance_jit(keys, target_importance):
    # module-level jit: repeat calls with the same callable reuse the
    # compiled program (see _pf_run_sharded)
    trs, ws = jax.vmap(target_importance)(keys)
    log_z = logsumexp(ws) - jnp.log(keys.shape[0])
    return trs, ws, log_z
