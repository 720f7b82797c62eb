"""Hierarchical island particle filter over a 2-level device mesh.

No reference counterpart (the reference's SMC is single-shard ``vmap``,
`/root/reference/src/genjax/_src/inference/smc.py:298-315`). This is the
multi-slice scaling story for SMC on multi-host clusters: interconnect
bandwidth is two-tier — ICI within a slice (fast, every-step collectives are
fine) and DCN across slices (orders slower; traffic must be rare and
scheduled). The island particle model (Vergé, Dubarry, Del Moral, Moulines
2015) maps onto that hierarchy exactly:

* the particle population splits into **islands**, one island per
  DCN-connected slice (mesh axis ``"island"``);
* within an island, particles shard over the slice's chips (mesh axis
  ``"batch"``) and every-step weight statistics + adaptive resampling ride
  **ICI only** — certified by the HLO audit in the tests: no per-step
  collective spans more than the ``batch`` axis;
* islands interact only at **scheduled exchange points** (every
  ``exchange_every`` steps): each island folds its local weights into a
  scalar island log-weight via an exact within-island resample, islands
  are systematically resampled by those scalars, and winning islands'
  states are copied across the ``island`` axis — the only DCN traffic in
  the program, and the scalar part of it is I floats.

The logZ estimate is the standard double-resampling island estimator:
island-level increments ``log (1/I) Σ_i exp(G_i)`` accrue at exchange
points, within-island increments accrue into each ``G_i`` between them.
Validated against exact Kalman log-marginals in
``tests/parallel/test_islands.py``.
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
from jax.sharding import Mesh, PartitionSpec as P

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from .resampling import (
    collective_resample,
    collective_weight_stats,
    resample_indices,
)


@Pytree.dataclass
class IslandFilterResult(Pytree):
    """Final particles (flat leading axis over islands x within-island
    particles), per-island log-weights, the island-estimator logZ, and
    per-island ESS history ``(T, n_islands)``."""

    carries: Any
    log_weights: Any
    island_log_weights: Any
    log_marginal: Any
    ess_history: Any
    n_exchanges: Any


@Pytree.dataclass
class IslandParticleFilter(Pytree):
    """Island SMC for a scanned kernel ``(carry, x) -> (carry, y)`` with
    per-step constrained observations (same kernel contract as
    ``SSMParticleFilter``).

    ``n_particles`` is the per-island population; the total population is
    ``n_islands * n_particles`` where ``n_islands`` is the mesh's
    ``island``-axis size. Within-island adaptive resampling triggers on
    island ESS < ``ess_threshold * n_particles`` (ICI collectives);
    island exchange happens every ``exchange_every`` steps (DCN).
    """

    kernel: GenerativeFunction
    n_particles: int = Pytree.static()
    ess_threshold: float = Pytree.static(default=0.5)
    exchange_every: int = Pytree.static(default=16)
    method: str = Pytree.static(default="systematic")

    def run_sharded(
        self,
        key: PRNGKey,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        mesh: Mesh,
        *,
        island_axis: str = "island",
        particle_axis: str = "batch",
        n_steps: int | None = None,
    ) -> IslandFilterResult:
        if island_axis not in mesh.shape or particle_axis not in mesh.shape:
            raise ValueError(
                f"mesh must carry axes {island_axis!r} and {particle_axis!r}"
                f" (got {tuple(mesh.shape)}); build one with "
                "parallel.make_hier_mesh(n_islands, n_shards)"
            )
        n_shards = mesh.shape[particle_axis]
        if self.n_particles % n_shards:
            raise ValueError(
                f"n_particles={self.n_particles} must divide over the "
                f"{n_shards}-shard {particle_axis!r} axis"
            )
        carries, log_w, g, log_z, ess_hist, n_ex = _island_run_sharded(
            self, key, init_carry, xs, constraint,
            mesh=mesh, island_axis=island_axis, particle_axis=particle_axis,
            n_steps=n_steps,
        )
        return IslandFilterResult(
            carries, log_w, g, log_z, ess_hist, n_ex
        )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "island_axis", "particle_axis", "n_steps"),
)
def _island_run_sharded(
    pf, key, init_carry, xs, constraint, *,
    mesh, island_axis, particle_axis, n_steps,
):
    # module-level jit with the filter as a pytree argument: repeat calls
    # with the same model/shapes reuse the compiled program (CLAUDE.md:
    # remote re-compiles cost 10-400 s)
    n_islands = mesh.shape[island_axis]
    n_shards = mesh.shape[particle_axis]
    k_island = pf.n_particles
    k_local = k_island // n_shards

    def shard_program(key, init_carry, xs, constraint):
        island = lax.axis_index(island_axis)
        shard = lax.axis_index(particle_axis)
        xs_leaves = jtu.tree_leaves(xs)
        t_count = xs_leaves[0].shape[0] if xs_leaves else n_steps
        if t_count is None:
            raise ValueError("run_sharded: xs is None/empty — pass n_steps.")

        def broadcast(c):
            return jtu.tree_map(
                lambda v: jnp.broadcast_to(
                    jnp.asarray(v), (k_local,) + jnp.shape(v)
                ),
                c,
            )

        def step(state, inp):
            carries, log_w, g, log_z, n_ex = state
            t, x = inp
            extend_key, resample_key, exchange_key = jr.split(
                jr.fold_in(key, t), 3
            )

            def extend(pkey, c):
                submap = constraint.get_submap(t)
                tr, w = pf.kernel.generate(pkey, submap, (c, x))
                c_new, _y = tr.get_retval()
                return c_new, w

            pkeys = jr.split(
                jr.fold_in(jr.fold_in(extend_key, island), shard), k_local
            )
            carries, ws = jax.vmap(extend)(pkeys, carries)
            log_w = log_w + ws

            # ---- within-island statistics: ICI collectives only ----
            ess, log_z_inc = collective_weight_stats(log_w, particle_axis)

            def do_resample(args):
                carries, log_w, g = args
                new_c, new_lw, inc = collective_resample(
                    jr.fold_in(resample_key, island),
                    carries,
                    log_w,
                    particle_axis,
                    method=pf.method,
                    mode="local",
                    log_z_inc=log_z_inc,
                )
                return new_c, new_lw, g + inc

            carries, log_w, g = lax.cond(
                ess < pf.ess_threshold * k_island,
                do_resample,
                lambda a: a,
                (carries, log_w, g),
            )

            # ---- scheduled island exchange: the only DCN traffic ----
            def do_exchange(args):
                carries, log_w, g, log_z, n_ex = args
                # 1. fold residual local weights into the island weight by
                #    an EXACT within-island resample (weights become
                #    uniform, so nothing is double counted) — ICI traffic
                l_max = lax.pmax(jnp.max(log_w), particle_axis)
                l_tot = lax.psum(
                    jnp.sum(jnp.exp(log_w - l_max)), particle_axis
                )
                local_norm = l_max + jnp.log(l_tot) - jnp.log(k_island)
                carries, _, _ = collective_resample(
                    jr.fold_in(exchange_key, island),
                    carries,
                    log_w,
                    particle_axis,
                    mode="all_gather",
                    method=pf.method,
                    log_z_inc=local_norm,
                )
                G = g + local_norm
                # 2. island-level normalizer: log (1/I) sum_i exp(G_i)
                #    (scalar DCN all-reduce pair)
                g_max = lax.pmax(G, island_axis)
                g_tot = lax.psum(jnp.exp(G - g_max), island_axis)
                inc = g_max + jnp.log(g_tot) - jnp.log(n_islands)
                # 3. systematic island selection from the shared key: every
                #    device computes the same ancestor vector from the
                #    gathered island weights (I floats over DCN)
                all_G = lax.all_gather(G, island_axis)
                anc = resample_indices(
                    exchange_key, all_G, n_islands, pf.method
                )
                my_anc = anc[island]
                # 4. copy the winning island's particle block across the
                #    island axis (the heavy, scheduled DCN transfer)
                carries = jtu.tree_map(
                    lambda v: lax.all_gather(v, island_axis)[my_anc],
                    carries,
                )
                return (
                    carries,
                    jnp.zeros((k_local,)),
                    jnp.zeros(()),
                    log_z + inc,
                    n_ex + 1,
                )

            carries, log_w, g, log_z, n_ex = lax.cond(
                (t + 1) % pf.exchange_every == 0,
                do_exchange,
                lambda a: a,
                (carries, log_w, g, log_z, n_ex),
            )
            return (carries, log_w, g, log_z, n_ex), ess[None]

        init = (
            broadcast(init_carry),
            jnp.zeros((k_local,)),
            jnp.zeros(()),
            jnp.zeros(()),
            jnp.zeros((), jnp.int32),
        )
        (carries, log_w, g, log_z, n_ex), ess_hist = lax.scan(
            step, init, (jnp.arange(t_count), xs)
        )
        # final island-estimator normalizer: fold residual local weights
        # into G_i, then average islands
        l_max = lax.pmax(jnp.max(log_w), particle_axis)
        l_tot = lax.psum(jnp.sum(jnp.exp(log_w - l_max)), particle_axis)
        G = g + l_max + jnp.log(l_tot) - jnp.log(k_island)
        g_max = lax.pmax(G, island_axis)
        g_tot = lax.psum(jnp.exp(G - g_max), island_axis)
        log_marginal = log_z + g_max + jnp.log(g_tot) - jnp.log(n_islands)
        return carries, log_w, G[None], log_marginal, ess_hist, n_ex

    from .mesh import shard_map_compat

    program = shard_map_compat(
        shard_program,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(
            P((island_axis, particle_axis)),  # carries: flat particle axis
            P((island_axis, particle_axis)),  # log_weights
            P(island_axis),                   # island log-weights (I,)
            P(),                              # log_marginal (replicated)
            P(None, island_axis),             # ess history (T, I)
            P(),                              # exchange count
        ),
    )
    return program(key, init_carry, xs, constraint)
