"""SMC² — online joint parameter-and-state inference (Chopin, Jacob &
Papaspiliopoulos 2013).

No reference counterpart (its SMC stops at `ImportanceK`/`ChangeTarget` —
`/root/reference/src/genjax/_src/inference/smc.py`; parameters must be
fixed). SMC² runs N_θ parameter particles, each carrying its own N_x-particle
bootstrap filter: at every observation the inner filters advance one step
and their incremental evidence multiplies the outer weights; when the
parameter ESS collapses, parameters resample and rejuvenate through a PMMH
exchange move (a fresh full-history particle filter per proposal — the
Andrieu-Doucet-Holenstein acceptance keeps the θ-posterior exact at every
time despite the evidence being estimated).

Structure: everything is ONE jitted scan over time. θ-particles and
their inner state particles are dense (N_θ,) / (N_θ, N_x) leading axes —
two nested vmaps over the same ``kernel.generate`` the single-θ particle
filter uses (`parallel/smc.py`). The rejuvenation's from-scratch filter is
a masked scan over the full horizon (steps beyond the current time are
no-ops), so the whole sampler is a single fixed-shape program: the
compiled cost is O(T²) in the worst case but there is no host round trip
and no recompilation, and the O(T) common path dominates when ESS stays
healthy.

Inner filters resample EVERY step (bootstrap): under the outer θ-vmap an
adaptive ``lax.cond`` would lower to ``select`` and pay both branches
anyway, so the unconditional form is both simpler and no slower.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..parallel.resampling import effective_sample_size, systematic_indices


@Pytree.dataclass
class SMC2Result(Pytree):
    """Final parameter particles (+ their normalized log weights), the
    running log-evidence estimate, the per-step θ-ESS trace, and the mean
    rejuvenation acceptance rate."""

    thetas: Any
    log_weights: Any
    log_evidence: Any
    ess_history: Any
    rejuv_accept_rate: Any


def _take(tree, idx):
    return jtu.tree_map(lambda v: v[idx], tree)


def smc2(
    key: PRNGKey,
    kernel: GenerativeFunction,
    theta_sample: Callable,
    theta_logprior: Callable,
    init_carry: Any,
    xs: Any,
    constraint: ChoiceMap,
    *,
    n_theta: int,
    n_x: int,
    ess_threshold: float = 0.5,
    rw_scales: Any = 0.1,
    n_rejuv: int = 1,
    n_steps: int | None = None,
    mesh=None,
    axis: str = "batch",
) -> SMC2Result:
    """Run SMC² over a scanned SSM kernel.

    Args:
        kernel: ``@gen`` step ``((theta, z), x) -> ((theta, z'), y)`` with
            the per-step observation at address ``"y"`` — the single-θ
            `SSMParticleFilter` convention with θ riding in the carry.
        theta_sample: ``key -> theta pytree`` (prior draw).
        theta_logprior: ``theta -> scalar`` log prior density.
        init_carry: initial ``z`` (θ-independent; broadcast per particle).
        xs: per-step inputs, leaves with leading time axis (or ``None``
            leaves broadcast by the kernel).
        constraint: dense observation choice map — ``C[:, "y"].set(ys)``.
        n_theta / n_x: parameter / state particle counts.
        ess_threshold: θ-resample trigger as a fraction of ``n_theta``.
        rw_scales: Gaussian random-walk scales for the PMMH rejuvenation
            (scalar or pytree matching θ).
        n_rejuv: PMMH exchange moves per rejuvenation.
        n_steps: horizon when ``xs`` has no array leaves (e.g. ``None``
            for kernels that ignore the per-step input).
        mesh: optional ``jax.sharding.Mesh`` — the θ-particle axis (and
            every per-θ inner-filter leaf) shards over ``axis``; XLA
            partitions the whole scan and inserts collectives for the
            θ-resampling gathers and weight reductions. Placement only:
            results are bit-identical to the unsharded run.
    """
    t_leaves = jtu.tree_leaves(xs)
    if t_leaves:
        T = t_leaves[0].shape[0]
    elif n_steps is not None:
        T = n_steps
    else:
        raise ValueError("smc2: xs is None/empty — pass n_steps.")
    k_init, k_loop = jr.split(jr.fold_in(key, 0x53C2))

    thetas0 = jax.vmap(theta_sample)(jr.split(k_init, n_theta))
    try:
        scales = jtu.tree_map(
            lambda v, s: jnp.broadcast_to(
                jnp.asarray(s, jnp.result_type(v, float)), jnp.shape(v)[1:]
            ),
            thetas0,
            rw_scales,
        )
    except ValueError:  # scalar rw_scales shared across every leaf
        scales = jtu.tree_map(
            lambda v: jnp.broadcast_to(
                jnp.asarray(rw_scales, jnp.result_type(v, float)),
                jnp.shape(v)[1:],
            ),
            thetas0,
        )

    def broadcast_z(c):
        return jtu.tree_map(
            lambda v: jnp.broadcast_to(
                jnp.asarray(v), (n_theta, n_x) + jnp.shape(v)
            ),
            c,
        )

    def pf_step(pkey, theta, zs, t, x):
        """One bootstrap-filter step for ONE θ: extend all n_x particles
        under the observation at t, return (resampled zs, log-evidence
        increment). ``t`` is traced; the submap lookup is dynamic."""
        submap = constraint.get_submap(t)
        extend_key, resample_key = jr.split(pkey)

        def extend(ek, z):
            tr, w = kernel.generate(ek, submap, ((theta, z), x))
            (_, z_new), _y = tr.get_retval()
            return z_new, w

        zs_new, ws = jax.vmap(extend)(jr.split(extend_key, n_x), zs)
        inc = logsumexp(ws) - jnp.log(n_x)
        idx = systematic_indices(resample_key, ws, n_x)
        return _take(zs_new, idx), inc

    def pf_full(pkey, theta, t_now):
        """From-scratch bootstrap filter for ONE θ over y_{0..t_now}
        (steps beyond t_now are masked no-ops). Returns (final zs,
        log p̂(y_{0..t_now} | θ))."""
        zs0 = jtu.tree_map(
            lambda v: jnp.broadcast_to(jnp.asarray(v), (n_x,) + jnp.shape(v)),
            init_carry,
        )

        def step(state, inp):
            zs, log_z = state
            s, x = inp
            active = s <= t_now
            zs_new, inc = pf_step(jr.fold_in(pkey, s), theta, zs, s, x)
            zs = jtu.tree_map(
                lambda a, b: jnp.where(active, a, b), zs_new, zs
            )
            return (zs, log_z + jnp.where(active, inc, 0.0)), None

        (zs, log_z), _ = lax.scan(
            step, (zs0, jnp.asarray(0.0)), (jnp.arange(T), xs)
        )
        return zs, log_z

    def rejuvenate(rkey, thetas, zss, log_zs, t_now):
        """n_rejuv PMMH exchange moves on every θ-particle, targeting
        p(θ | y_{0..t_now}). Accepted proposals take the fresh filter's
        particles and evidence (the 'exchange' that keeps the algorithm
        exact with estimated likelihoods)."""
        lps = jax.vmap(theta_logprior)(thetas)
        n_acc = jnp.asarray(0.0)
        for j in range(n_rejuv):
            kj = jr.fold_in(rkey, j)
            k_prop, k_pf, k_acc = jr.split(kj, 3)

            leaves, treedef = jtu.tree_flatten(thetas)
            noise_keys = jr.split(k_prop, len(leaves))
            prop_leaves = [
                v
                + s[None]
                * jr.normal(nk, jnp.shape(v), jnp.result_type(v, float))
                for v, s, nk in zip(
                    leaves, jtu.tree_leaves(scales), noise_keys
                )
            ]
            props = jtu.tree_unflatten(treedef, prop_leaves)
            lps_new = jax.vmap(theta_logprior)(props)
            zss_new, lzs_new = jax.vmap(
                lambda pk, th: pf_full(pk, th, t_now)
            )(jr.split(k_pf, n_theta), props)
            log_alpha = (lps_new + lzs_new) - (lps + log_zs)
            accept = (
                jnp.log(jr.uniform(k_acc, (n_theta,))) < log_alpha
            )
            thetas = jtu.tree_map(
                lambda a, b: jnp.where(
                    accept.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
                ),
                props,
                thetas,
            )
            zss = jtu.tree_map(
                lambda a, b: jnp.where(
                    accept.reshape((-1,) + (1,) * (a.ndim - 1)), a, b
                ),
                zss_new,
                zss,
            )
            log_zs = jnp.where(accept, lzs_new, log_zs)
            lps = jnp.where(accept, lps_new, lps)
            n_acc = n_acc + jnp.mean(accept)
        return thetas, zss, log_zs, n_acc / n_rejuv

    def step(state, inp):
        thetas, zss, omega, log_zs, log_ev, acc_sum, n_rejuvs = state
        t, x = inp
        k_t = jr.fold_in(k_loop, t)
        k_ext, k_res, k_rej = jr.split(k_t, 3)

        # advance every θ's inner filter one observation
        zss, incs = jax.vmap(
            lambda pk, th, zs: pf_step(pk, th, zs, t, x)
        )(jr.split(k_ext, n_theta), thetas, zss)
        omega = omega + incs
        log_zs = log_zs + incs
        ess = effective_sample_size(omega)

        def do_resample(args):
            thetas, zss, omega, log_zs, log_ev, acc_sum, n_rejuvs = args
            log_ev = log_ev + logsumexp(omega) - jnp.log(n_theta)
            idx = systematic_indices(k_res, omega, n_theta)
            thetas_r = _take(thetas, idx)
            zss_r = _take(zss, idx)
            log_zs_r = log_zs[idx]
            thetas_r, zss_r, log_zs_r, acc = rejuvenate(
                k_rej, thetas_r, zss_r, log_zs_r, t
            )
            return (
                thetas_r,
                zss_r,
                jnp.zeros(n_theta),
                log_zs_r,
                log_ev,
                acc_sum + acc,
                n_rejuvs + 1.0,
            )

        state = lax.cond(
            ess < ess_threshold * n_theta,
            do_resample,
            lambda a: a,
            (thetas, zss, omega, log_zs, log_ev, acc_sum, n_rejuvs),
        )
        return state, ess

    thetas0_p, zss0 = thetas0, broadcast_z(init_carry)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        theta_sharding = NamedSharding(mesh, P(axis))

        def place(leaf):
            return jax.device_put(leaf, theta_sharding)

        thetas0_p = jtu.tree_map(place, thetas0_p)
        zss0 = jtu.tree_map(place, zss0)

    init = (
        thetas0_p,
        zss0,
        jnp.zeros(n_theta),
        jnp.zeros(n_theta),
        jnp.asarray(0.0),
        jnp.asarray(0.0),
        jnp.asarray(0.0),
    )
    (thetas, _zss, omega, _log_zs, log_ev, acc_sum, n_rejuvs), ess_hist = (
        lax.scan(step, init, (jnp.arange(T), xs))
    )
    log_evidence = log_ev + logsumexp(omega) - jnp.log(n_theta)
    return SMC2Result(
        thetas=thetas,
        log_weights=omega - logsumexp(omega),
        log_evidence=log_evidence,
        ess_history=ess_hist,
        rejuv_accept_rate=acc_sum / jnp.maximum(n_rejuvs, 1.0),
    )
