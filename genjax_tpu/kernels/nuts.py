"""Vectorized No-U-Turn Sampler in the fused column layout.

No reference counterpart (the reference ships plain HMC only); NUTS at
1k–64k parallel chains is a BASELINE.json benchmark config. The sampler is
the **iterative** formulation (fixed shapes, no recursion — the published
accelerator-friendly scheme of Phan et al. 2019 / Hoffman & Gelman 2014
Alg. 3 semantics):

- multinomial progressive sampling within subtrees, biased progressive
  sampling across doublings (Betancourt 2017);
- U-turn detection inside a subtree via a **checkpoint stack**: the state
  at leaf ``i`` becomes the level-``k`` checkpoint whenever ``i % 2^(k+1)
  == 0``, and when ``(i+1) % 2^(k+1) == 0`` the subtree of size
  ``2^(k+1)`` ending at ``i`` is checked against its saved start — every
  balanced-tree U-turn check in O(max_depth) slots;
- everything is masked ``lax.fori_loop`` / ``lax.while_loop``-free code:
  one chain is a fixed ``2^max_depth``-leapfrog budget, vmapped over the
  chain batch; sharding the chain axis scales it across a mesh.

Per-chain state is a few ``(D,)`` vectors plus a ``(max_depth, 2D)``
checkpoint buffer — at 64k chains × D=16 × depth 8 that is ~70 MB of HBM.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax


class NUTSInfo(NamedTuple):
    accept_prob: jnp.ndarray
    num_leapfrogs: jnp.ndarray
    diverged: jnp.ndarray
    depth: jnp.ndarray


def _uturn(z_from, r_from, z_to, r_to, inv_mass=1.0):
    dz = z_to - z_from
    return jnp.logical_or(
        jnp.dot(dz, inv_mass * r_from) < 0.0, jnp.dot(dz, inv_mass * r_to) < 0.0
    )


def nuts_transition(
    logdensity: Callable,
    z0,
    key,
    eps,
    max_depth: int = 8,
    divergence_threshold: float = 1000.0,
    inv_mass=None,
):
    """One NUTS transition for a single chain (vmap over chains).

    Args:
        logdensity: ``(D,) -> scalar``; its gradient is taken internally
            with ``jax.value_and_grad`` so every leapfrog leaf costs ONE
            forward+backward evaluation (the density primal needed for the
            trajectory weight rides the gradient pass, and the gradient at
            each trajectory endpoint is carried instead of recomputed).
        z0: current position ``(D,)``.

    Returns ``(z_new, NUTSInfo)``.
    """
    d = z0.shape[0]
    if inv_mass is None:
        inv_mass = jnp.ones((d,), jnp.float32)
    else:
        # accept the (D, 1) column-layout shape the batched path takes
        inv_mass = jnp.reshape(jnp.asarray(inv_mass, jnp.float32), (d,))
    mom_std = 1.0 / jnp.sqrt(inv_mass)
    vg = jax.value_and_grad(logdensity)
    kr, kd, ku = jr.split(key, 3)
    r0 = mom_std * jr.normal(kr, (d,))

    def kinetic(r):
        return 0.5 * jnp.dot(inv_mass * r, r)

    ld0, g0 = vg(z0)
    energy0 = -ld0 + kinetic(r0)

    # trajectory state
    class T(NamedTuple):
        z_minus: jnp.ndarray
        r_minus: jnp.ndarray
        g_minus: jnp.ndarray  # cached gradient at the backward end
        z_plus: jnp.ndarray
        r_plus: jnp.ndarray
        g_plus: jnp.ndarray  # cached gradient at the forward end
        z_prop: jnp.ndarray
        lw_traj: jnp.ndarray  # log sum of exp(-energy) over trajectory
        turning: jnp.ndarray
        diverged: jnp.ndarray
        n_leap: jnp.ndarray
        sum_accept: jnp.ndarray  # for accept-prob statistic
        sum_count: jnp.ndarray
        depth: jnp.ndarray  # doublings completed before termination

    t0 = T(
        z0, r0, g0, z0, r0, g0, z0, -energy0,
        jnp.asarray(False), jnp.asarray(False), jnp.asarray(0),
        jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0),
    )

    def build_subtree(carry_key, t: T, depth: int, direction):
        """Build a subtree of 2^depth leaves off the trajectory's moving end
        in ``direction``. Fixed 2^max_depth leaf budget, masked by depth."""
        n_leaves = 1 << depth
        z_end = jnp.where(direction > 0, 1.0, 0.0)
        z_start = jnp.where(direction > 0, 0.0, 1.0)
        z_cur = t.z_plus * z_end + t.z_minus * z_start
        r_cur = t.r_plus * z_end + t.r_minus * z_start
        g_cur = t.g_plus * z_end + t.g_minus * z_start

        # Checkpoint STACK (Phan et al. 2019 iterative scheme): node i is
        # pushed at slot popcount(i); the openers of every balanced
        # subtree closing at leaf i are exactly the top ntz(i+1) stack
        # entries, slots [popcount(i)-ntz(i+1), popcount(i)-1]. One
        # dynamic row write + ~1 row read per leaf, instead of a masked
        # full-buffer update per level — the buffer traffic, not the
        # density evaluations, bounds NUTS throughput at 64k chains.
        # Row max_depth is a scratch slot for masked-out writes.
        ckpt_z = jnp.zeros((max_depth + 1, d))
        ckpt_r = jnp.zeros((max_depth + 1, d))

        class S(NamedTuple):
            z: jnp.ndarray
            r: jnp.ndarray
            g: jnp.ndarray  # gradient at z (cached from its evaluation)
            ckpt_z: jnp.ndarray
            ckpt_r: jnp.ndarray
            z_prop: jnp.ndarray
            lw_sub: jnp.ndarray
            turning: jnp.ndarray
            diverged: jnp.ndarray
            sum_accept: jnp.ndarray
            sum_count: jnp.ndarray

        def leaf_step(i, s: S):
            active = jnp.logical_and(
                i < n_leaves,
                jnp.logical_not(jnp.logical_or(s.turning, s.diverged)),
            )

            # leapfrog off the cached gradient: one value_and_grad per leaf
            e = eps * direction
            r_half = s.r + 0.5 * e * s.g
            z_new = s.z + e * inv_mass * r_half
            ld_new, g_new = vg(z_new)
            r_new = r_half + 0.5 * e * g_new

            # push the POST-leapfrog state (node i) at stack slot
            # popcount(i). The write is unconditional: the slot is uniform
            # across vmapped lanes (a function of the loop index only — a
            # per-lane slot would lower to an element-serial scatter), and
            # pushes from inactive/odd-i lanes are harmless — inactive
            # lanes never read again this subtree, and an odd node's
            # spurious push is overwritten before any read (nodes between
            # an opener and its close carry the opener's bits plus extra,
            # so their popcount exceeds the opener's slot).
            bc = lax.population_count(i)
            ckz = lax.dynamic_update_index_in_dim(s.ckpt_z, z_new, bc, 0)
            ckr = lax.dynamic_update_index_in_dim(s.ckpt_r, r_new, bc, 0)
            energy = -ld_new + kinetic(r_new)
            # an overflowed/NaN leapfrog state is a divergence, not a NaN
            # that poisons the accept statistic and trajectory weights
            energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
            lw_leaf = -energy
            diverged = jnp.logical_and(
                active, energy - energy0 > divergence_threshold
            )

            # progressive multinomial proposal within the subtree
            lw_new = jnp.where(active, jnp.logaddexp(s.lw_sub, lw_leaf), s.lw_sub)
            p_take = jnp.exp(lw_leaf - lw_new)
            u = jr.uniform(jr.fold_in(carry_key, i))
            take = jnp.logical_and(active, u < p_take)
            z_prop = jnp.where(take, z_new, s.z_prop)

            # accept-statistic accumulation (standard NUTS statistic)
            acc = jnp.minimum(1.0, jnp.exp(energy0 - energy))
            sum_accept = s.sum_accept + jnp.where(active, acc, 0.0)
            sum_count = s.sum_count + jnp.where(active, 1.0, 0.0)

            # U-turn checks against the top ntz(i+1) stack entries — the
            # openers of every subtree closing at i. Backward integration
            # produces forward-convention momenta, so only the displacement
            # is direction-sensitive.
            ip1 = i + 1
            ntz1 = lax.population_count((ip1 & -ip1) - 1)

            def check(j_off, turning):
                slot_j = bc - 1 - j_off
                cz = lax.dynamic_index_in_dim(ckz, slot_j, 0, keepdims=False)
                cr = lax.dynamic_index_in_dim(ckr, slot_j, 0, keepdims=False)
                dz = direction * (z_new - cz)
                ut = jnp.logical_or(
                    jnp.dot(dz, inv_mass * cr) < 0.0,
                    jnp.dot(dz, inv_mass * r_new) < 0.0,
                )
                return jnp.logical_or(turning, jnp.logical_and(active, ut))

            turning = lax.fori_loop(0, ntz1, check, s.turning)

            return S(
                jnp.where(active, z_new, s.z),
                jnp.where(active, r_new, s.r),
                jnp.where(active, g_new, s.g),
                ckz,
                ckr,
                z_prop,
                lw_new,
                turning,
                jnp.logical_or(s.diverged, diverged),
                sum_accept,
                sum_count,
            )

        s0 = S(
            z_cur, r_cur, g_cur, ckpt_z, ckpt_r, z_cur,
            -jnp.inf, jnp.asarray(False), jnp.asarray(False),
            t.sum_accept, t.sum_count,
        )
        # fixed-budget fori: the bounds stay uniform (a function of the
        # doubling index only), so under an outer vmap no per-lane
        # while-masking of the carry — including the checkpoint buffers —
        # is introduced. Early collective exit lives in the explicitly
        # batched ``nuts_transition_cols``.
        s = lax.fori_loop(0, n_leaves, leaf_step, s0)
        return s

    def doubling(j, carry):
        t, done = carry
        dir_key = jr.fold_in(kd, j)
        sub_key = jr.fold_in(ku, j)
        direction = jnp.where(jr.bernoulli(dir_key), 1.0, -1.0)

        s = build_subtree(sub_key, t, j, direction)
        sub_ok = jnp.logical_not(jnp.logical_or(s.turning, s.diverged))

        # biased progressive sampling across the doubling
        p_accept_sub = jnp.minimum(1.0, jnp.exp(s.lw_sub - t.lw_traj))
        u = jr.uniform(jr.fold_in(sub_key, 1 << 30))
        take = jnp.logical_and(
            jnp.logical_not(done), jnp.logical_and(sub_ok, u < p_accept_sub)
        )
        z_prop = jnp.where(take, s.z_prop, t.z_prop)
        lw_traj = jnp.where(
            jnp.logical_and(jnp.logical_not(done), sub_ok),
            jnp.logaddexp(t.lw_traj, s.lw_sub),
            t.lw_traj,
        )

        # update the moving end (with its cached gradient)
        fwd = direction > 0
        upd = jnp.logical_and(jnp.logical_not(done), sub_ok)
        upd_f = jnp.logical_and(upd, fwd)
        upd_b = jnp.logical_and(upd, jnp.logical_not(fwd))
        z_plus = jnp.where(upd_f, s.z, t.z_plus)
        r_plus = jnp.where(upd_f, s.r, t.r_plus)
        g_plus = jnp.where(upd_f, s.g, t.g_plus)
        z_minus = jnp.where(upd_b, s.z, t.z_minus)
        r_minus = jnp.where(upd_b, s.r, t.r_minus)
        g_minus = jnp.where(upd_b, s.g, t.g_minus)

        # global U-turn across the whole trajectory
        global_turn = _uturn(z_minus, r_minus, z_plus, r_plus, inv_mass)

        new_done = jnp.logical_or(
            done,
            jnp.logical_or(jnp.logical_not(sub_ok), global_turn),
        )
        n_leap = t.n_leap + jnp.where(done, 0, 1 << j)
        # flags from a subtree built AFTER the chain terminated are
        # artifacts of the masked-out budget (the fori still integrates
        # garbage from the frozen ends) — gate them so info.diverged
        # reports only real trajectory divergences
        live = jnp.logical_not(done)
        t_new = T(
            z_minus, r_minus, g_minus, z_plus, r_plus, g_plus, z_prop, lw_traj,
            jnp.logical_or(t.turning, jnp.logical_and(live, s.turning)),
            jnp.logical_or(t.diverged, jnp.logical_and(live, s.diverged)),
            n_leap,
            jnp.where(done, t.sum_accept, s.sum_accept),
            jnp.where(done, t.sum_count, s.sum_count),
            t.depth + jnp.where(done, 0, 1),
        )
        return (t_new, new_done)

    (t, done) = lax.fori_loop(0, max_depth, doubling, (t0, jnp.asarray(False)))

    info = NUTSInfo(
        accept_prob=t.sum_accept / jnp.maximum(t.sum_count, 1.0),
        num_leapfrogs=t.n_leap,
        diverged=t.diverged,
        depth=t.depth,
    )
    return t.z_prop, info


def nuts_transition_cols(
    logdensity_cols: Callable,
    q0,
    key,
    eps,
    max_depth: int = 8,
    divergence_threshold: float = 1000.0,
    inv_mass=None,
):
    """One NUTS transition over an EXPLICIT ``(D, N)`` chain batch.

    The batched twin of ``nuts_transition``: instead of vmapping the
    single-chain transition, the batch axis is threaded through every
    state array so the loop *conditions stay scalar* — ``while`` loops
    exit collectively when every chain has U-turned/diverged
    (``~all(done)``), without the per-lane carry masking a batched
    ``while`` would impose on the checkpoint buffers. Off saturated-depth
    targets this skips most of the fixed ``2^max_depth`` leaf budget the
    vmapped form always pays; per-lane masking uses the same ``active``
    flags either way. Bulk ``(D, N)`` draws also keep the RBG bit
    generator in its fast regime.

    Args:
        logdensity_cols: batched log-density ``(D, N) -> (N,)``.
        q0: positions ``(D, N)`` float32.
        inv_mass: optional diagonal inverse mass, shape ``(D,)``.

    Returns ``(z_new, NUTSInfo)`` with per-chain ``(N,)`` info fields.
    """
    d, n = q0.shape
    if inv_mass is None:
        inv_mass = jnp.ones((d, 1), jnp.float32)
    else:
        inv_mass = jnp.reshape(jnp.asarray(inv_mass, jnp.float32), (d, 1))
    mom_std = 1.0 / jnp.sqrt(inv_mass)
    kr, kd, ku = jr.split(key, 3)
    r0 = mom_std * jr.normal(kr, (d, n))

    def vg_cols(q):
        lp, pullback = jax.vjp(logdensity_cols, q)
        (g,) = pullback(jnp.ones_like(lp))
        return lp, g

    def kinetic(r):
        return 0.5 * jnp.sum(inv_mass * r * r, axis=0)  # (N,)

    ld0, g0 = vg_cols(q0)
    energy0 = -ld0 + kinetic(r0)  # (N,)
    fbool = jnp.zeros((n,), bool)
    fzero = jnp.zeros((n,), jnp.float32)
    izero = jnp.zeros((n,), jnp.int32)

    class T(NamedTuple):
        z_minus: jnp.ndarray
        r_minus: jnp.ndarray
        g_minus: jnp.ndarray
        z_plus: jnp.ndarray
        r_plus: jnp.ndarray
        g_plus: jnp.ndarray
        z_prop: jnp.ndarray
        lw_traj: jnp.ndarray
        turning: jnp.ndarray
        diverged: jnp.ndarray
        n_leap: jnp.ndarray
        sum_accept: jnp.ndarray
        sum_count: jnp.ndarray
        depth: jnp.ndarray

    t0 = T(
        q0, r0, g0, q0, r0, g0, q0, -energy0,
        fbool, fbool, izero, fzero, fzero, izero,
    )

    class S(NamedTuple):
        z: jnp.ndarray
        r: jnp.ndarray
        g: jnp.ndarray
        ckpt_z: jnp.ndarray
        ckpt_r: jnp.ndarray
        z_prop: jnp.ndarray
        lw_sub: jnp.ndarray
        turning: jnp.ndarray
        diverged: jnp.ndarray
        sum_accept: jnp.ndarray
        sum_count: jnp.ndarray

    def build_subtree(carry_key, t: T, depth, direction, done):
        n_leaves = 1 << depth
        fwd = direction > 0  # (N,)
        z_cur = jnp.where(fwd[None, :], t.z_plus, t.z_minus)
        r_cur = jnp.where(fwd[None, :], t.r_plus, t.r_minus)
        g_cur = jnp.where(fwd[None, :], t.g_plus, t.g_minus)
        e = (eps * direction)[None, :]  # (1, N)

        def leaf_step(i, s: S):
            active = jnp.logical_not(
                jnp.logical_or(jnp.logical_or(s.turning, s.diverged), done)
            )

            r_half = s.r + 0.5 * e * s.g
            z_new = s.z + e * inv_mass * r_half
            ld_new, g_new = vg_cols(z_new)
            r_new = r_half + 0.5 * e * g_new

            # checkpoint-stack push at slot popcount(i) (see
            # nuts_transition; the slot is uniform across chains)
            bc = lax.population_count(i)
            ckz = lax.dynamic_update_index_in_dim(s.ckpt_z, z_new, bc, 0)
            ckr = lax.dynamic_update_index_in_dim(s.ckpt_r, r_new, bc, 0)

            energy = -ld_new + kinetic(r_new)
            energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
            lw_leaf = -energy
            diverged = jnp.logical_and(
                active, energy - energy0 > divergence_threshold
            )

            lw_new = jnp.where(
                active, jnp.logaddexp(s.lw_sub, lw_leaf), s.lw_sub
            )
            p_take = jnp.exp(lw_leaf - lw_new)
            u = jr.uniform(jr.fold_in(carry_key, i), (n,))
            take = jnp.logical_and(active, u < p_take)
            z_prop = jnp.where(take[None, :], z_new, s.z_prop)

            acc = jnp.minimum(1.0, jnp.exp(energy0 - energy))
            sum_accept = s.sum_accept + jnp.where(active, acc, 0.0)
            sum_count = s.sum_count + jnp.where(active, 1.0, 0.0)

            ip1 = i + 1
            ntz1 = lax.population_count((ip1 & -ip1) - 1)

            def check(j_off, turning):
                slot_j = bc - 1 - j_off
                cz = lax.dynamic_index_in_dim(ckz, slot_j, 0, keepdims=False)
                cr = lax.dynamic_index_in_dim(ckr, slot_j, 0, keepdims=False)
                dz = direction[None, :] * (z_new - cz)
                ut = jnp.logical_or(
                    jnp.sum(dz * inv_mass * cr, axis=0) < 0.0,
                    jnp.sum(dz * inv_mass * r_new, axis=0) < 0.0,
                )
                return jnp.logical_or(turning, jnp.logical_and(active, ut))

            turning = lax.fori_loop(0, ntz1, check, s.turning)

            return S(
                jnp.where(active[None, :], z_new, s.z),
                jnp.where(active[None, :], r_new, s.r),
                jnp.where(active[None, :], g_new, s.g),
                ckz,
                ckr,
                z_prop,
                lw_new,
                turning,
                jnp.logical_or(s.diverged, diverged),
                sum_accept,
                sum_count,
            )

        s0 = S(
            z_cur, r_cur, g_cur,
            jnp.zeros((max_depth + 1, d, n)),
            jnp.zeros((max_depth + 1, d, n)),
            z_cur, jnp.full((n,), -jnp.inf),
            fbool, fbool, t.sum_accept, t.sum_count,
        )

        # collective early exit: the condition is SCALAR (any chain still
        # integrating), so no carry masking — per-lane freezing is the
        # body's own `active` logic
        def leaf_cond(carry):
            i, s = carry
            return jnp.logical_and(
                i < n_leaves,
                jnp.any(
                    jnp.logical_not(
                        jnp.logical_or(
                            jnp.logical_or(s.turning, s.diverged), done
                        )
                    )
                ),
            )

        def leaf_body(carry):
            i, s = carry
            return (i + 1, leaf_step(i, s))

        _, s = lax.while_loop(leaf_cond, leaf_body, (jnp.asarray(0), s0))
        return s

    def doubling(carry):
        j, t, done = carry
        dir_key = jr.fold_in(kd, j)
        sub_key = jr.fold_in(ku, j)
        direction = jnp.where(jr.bernoulli(dir_key, shape=(n,)), 1.0, -1.0)

        s = build_subtree(sub_key, t, j, direction, done)
        sub_ok = jnp.logical_not(jnp.logical_or(s.turning, s.diverged))

        p_accept_sub = jnp.minimum(1.0, jnp.exp(s.lw_sub - t.lw_traj))
        u = jr.uniform(jr.fold_in(sub_key, 1 << 30), (n,))
        live = jnp.logical_not(done)
        take = jnp.logical_and(
            live, jnp.logical_and(sub_ok, u < p_accept_sub)
        )
        z_prop = jnp.where(take[None, :], s.z_prop, t.z_prop)
        grow = jnp.logical_and(live, sub_ok)
        lw_traj = jnp.where(
            grow, jnp.logaddexp(t.lw_traj, s.lw_sub), t.lw_traj
        )

        fwd = direction > 0
        upd_f = jnp.logical_and(grow, fwd)[None, :]
        upd_b = jnp.logical_and(grow, jnp.logical_not(fwd))[None, :]
        z_plus = jnp.where(upd_f, s.z, t.z_plus)
        r_plus = jnp.where(upd_f, s.r, t.r_plus)
        g_plus = jnp.where(upd_f, s.g, t.g_plus)
        z_minus = jnp.where(upd_b, s.z, t.z_minus)
        r_minus = jnp.where(upd_b, s.r, t.r_minus)
        g_minus = jnp.where(upd_b, s.g, t.g_minus)

        dz = z_plus - z_minus
        global_turn = jnp.logical_or(
            jnp.sum(dz * inv_mass * r_minus, axis=0) < 0.0,
            jnp.sum(dz * inv_mass * r_plus, axis=0) < 0.0,
        )

        new_done = jnp.logical_or(
            done, jnp.logical_or(jnp.logical_not(sub_ok), global_turn)
        )
        n_leap = t.n_leap + jnp.where(done, 0, 1 << j)
        t_new = T(
            z_minus, r_minus, g_minus, z_plus, r_plus, g_plus,
            z_prop, lw_traj,
            jnp.logical_or(t.turning, s.turning),
            jnp.logical_or(t.diverged, s.diverged),
            n_leap,
            jnp.where(done, t.sum_accept, s.sum_accept),
            jnp.where(done, t.sum_count, s.sum_count),
            t.depth + jnp.where(done, 0, 1),
        )
        return (j + 1, t_new, new_done)

    def doubling_cond(carry):
        j, _t, done = carry
        return jnp.logical_and(j < max_depth, jnp.logical_not(jnp.all(done)))

    _, t, _done = lax.while_loop(
        doubling_cond, doubling, (jnp.asarray(0), t0, fbool)
    )

    info = NUTSInfo(
        accept_prob=t.sum_accept / jnp.maximum(t.sum_count, 1.0),
        num_leapfrogs=t.n_leap,
        diverged=t.diverged,
        depth=t.depth,
    )
    return t.z_prop, info


def warmup_column_nuts(
    logdensity_cols: Callable,
    q0,
    seed: int,
    *,
    n_phases: int = 10,
    steps_per_phase: int = 10,
    eps0: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
):
    """Windowed warmup driven by NUTS's OWN accept statistic (the unified
    adaptation interface, ``inference.adaptation``): per phase, run a short
    NUTS sweep, nudge the step size toward ``target_accept``, re-estimate
    the diagonal inverse mass from cross-chain variance. One compiled
    ``lax.scan``. HMC-driven warmup (``hmc.warmup_column``) over-shrinks
    eps for NUTS — its L-step accept rate saturates near 1 where NUTS's
    trajectory-averaged statistic sits at the target.

    Returns ``(q, eps, inv_mass)``.
    """
    from .adaptation import windowed_warmup

    def sweep(q, idx, eps, inv_mass):
        # disjoint phase-seed stream — see hmc.warmup_column: seed*1000+idx
        # collides with the main sweep's stream at the default seed=0
        q, acc, _leaps = nuts_sweep_cols(
            logdensity_cols, q, (seed + 1) * 1_000_003 + idx,
            n_steps=steps_per_phase, eps=eps, max_depth=max_depth,
            inv_mass=inv_mass,
        )
        return q, acc

    q, eps, inv_mass, _accs = jax.jit(
        lambda q0: windowed_warmup(
            sweep, q0.astype(jnp.float32),
            n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        )
    )(q0)
    return q, float(eps), inv_mass


def nuts_sweep_cols(
    logdensity_cols: Callable,
    q0,
    seed: int,
    *,
    n_steps: int,
    eps,
    max_depth: int = 8,
    inv_mass=None,
    rng_impl: str = "rbg",
    batched: bool = True,
    collect: bool = False,
):
    """``n_steps`` NUTS transitions over ``(D, N)`` column-layout chains as
    one jitted scan (shard the chain axis for multi-chip). ``rng_impl``
    defaults to the ``"rbg"`` bit generator for the bulk ``(D, N)`` draws
    (see ``hmc._reference_hmc``). ``batched=True`` (default) runs the
    explicitly batched ``nuts_transition_cols`` — scalar loop conditions,
    collective early exit, bulk ``(D, N)`` PRNG draws; ``batched=False``
    vmaps the single-chain ``nuts_transition`` (fixed ``2^max_depth`` leaf
    budget per doubling).

    With ``collect=True`` returns ``(q, accept_stat, mean_leapfrogs,
    draws, divergence_rate)`` where ``draws`` is every transition's
    positions ``(n_steps, D, N)`` (for the ``sample_posterior`` driver);
    without it, the usual ``(q, accept_stat, mean_leapfrogs)``."""
    d, n = q0.shape

    def ld_one(z):
        return logdensity_cols(z[:, None])[0]

    def step(q, key):
        if batched:
            z_new, info = nuts_transition_cols(
                logdensity_cols, q, key, eps, max_depth=max_depth,
                inv_mass=inv_mass,
            )
        else:
            keys = jr.split(key, n)

            def one(k, z):
                return nuts_transition(
                    ld_one, z, k, eps, max_depth=max_depth,
                    inv_mass=inv_mass,
                )

            z_new, info = jax.vmap(one, in_axes=(0, 1), out_axes=(1, 0))(
                keys, q
            )
        stats = (
            jnp.mean(info.accept_prob),
            jnp.mean(info.num_leapfrogs),
            jnp.mean(jnp.asarray(info.diverged, jnp.float32)),
        )
        return z_new, (stats, z_new if collect else None)

    qf, ((accs, leaps, divs), draws) = lax.scan(
        step,
        q0.astype(jnp.float32),
        jr.split(jr.key(seed, impl=rng_impl), n_steps),
    )
    if collect:
        return qf, jnp.mean(accs), jnp.mean(leaps), draws, jnp.mean(divs)
    return qf, jnp.mean(accs), jnp.mean(leaps)
