"""Bridge from ``@gen`` models to the fused column-layout kernels.

``column_hmc`` extracts a flat log-density from a model + constraint over a
set of continuous addresses, initializes chains from the prior, and runs the
column HMC sweep (``kernels.hmc``) — same model code as the trace-based
drivers, with the whole sweep compiled as one program over all chains.

Positions are packed **chains-last**: ``(D, N)`` with ``D`` the total
flattened dimension of the selected addresses padded to a multiple of 8.
Padding dimensions carry an independent STANDARD-NORMAL density (see
``column_logdensity``): flat padding directions random-walk, explode the
cross-chain mass estimate, and never U-turn — do not "simplify" them back
to zero density (that pinned NUTS trajectories at the depth budget).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from .hmc import pallas_hmc


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ColumnPacker:
    """Flatten/unflatten a set of addresses to/from a padded column vector."""

    def __init__(self, model, constraint, args, addresses: Sequence[Any]):
        self.addresses = list(addresses)
        template = model.simulate(jr.key(0), args)
        chm = template.get_choices()
        self.shapes = []
        offset = 0
        for addr in self.addresses:
            path_ = addr if isinstance(addr, tuple) else (addr,)
            if constraint is not None and not constraint.get_submap(
                *path_
            ).static_is_empty():
                raise ValueError(
                    f"address {addr!r} is constrained — packing it as a "
                    "latent would silently override the observation"
                )
            path = addr if isinstance(addr, tuple) else (addr,)
            v = chm.get_submap(*path).get_value()
            if isinstance(v, Mask):
                v = v.value
            shape = jnp.shape(v)
            size = int(np.prod(shape)) if shape else 1
            self.shapes.append((path, shape, offset, size))
            offset += size
        self.dim = offset
        self.padded_dim = max(_round_up(offset, 8), 8)

    def unpack(self, q):
        """(padded_dim,) -> ChoiceMap over the addresses."""
        chm = ChoiceMap.empty()
        for path, shape, offset, size in self.shapes:
            v = q[offset : offset + size]
            v = v.reshape(shape) if shape else v[0]
            chm |= ChoiceMap.entry(v, *path)
        return chm

    def pack(self, chm) -> Any:
        """ChoiceMap -> (padded_dim,) vector."""
        parts = []
        for path, shape, offset, size in self.shapes:
            v = chm.get_submap(*path).get_value()
            if isinstance(v, Mask):
                v = v.value
            parts.append(jnp.reshape(jnp.asarray(v, jnp.float32), (size,)))
        flat = jnp.concatenate(parts) if parts else jnp.zeros((0,))
        pad = self.padded_dim - self.dim
        return jnp.pad(flat, (0, pad))


def column_logdensity(model, constraint, args, packer: ColumnPacker):
    """The model's log-joint as a batched column function
    ``(D, N) -> (N,)`` in pure jnp.

    The tile-padding dimensions (``packer.dim .. padded_dim``) carry an
    independent standard-normal density. Leaving them FLAT breaks every
    geometry-sensitive consumer: their random-walk variance explodes the
    cross-chain mass estimate, and a flat direction never U-turns, so
    NUTS trajectories max out the depth budget (measured: 252 mean
    leapfrogs at depth 8 on the 9-real-dim flagship model — padding
    pinned every trajectory at 2^depth; 22 after the fix). An
    independent product factor leaves the marginal over the real
    dimensions exactly unchanged."""
    n_pad = packer.padded_dim - packer.dim

    def one(q):
        latents = packer.unpack(q)
        score, _ = model.assess(latents | constraint, args)
        if n_pad:
            score = score - 0.5 * jnp.sum(q[packer.dim :] ** 2)
        return score

    return jax.vmap(one, in_axes=1)


def column_hmc(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_steps: int,
    eps: float,
    L: int = 5,
    seed: int = 0,
    warmup: bool = False,
    inv_mass=None,
    mass: str = "diag",
):
    """Prior-initialized, MH-adjusted HMC over ``addresses`` in the fused
    column layout. With ``warmup=True``, a windowed warmup adapts the step
    size and a diagonal mass matrix from cross-chain variance before the
    main sweep (``eps`` then seeds the adaptation). Returns ``(positions,
    accept_rate, packer)``; decode single chains with
    ``packer.unpack(positions[:, i])``.

    ``mass="dense"`` (requires ``warmup=True``) adapts a FULL covariance
    metric from the cross-chain spread instead
    (``kernels.dense_mass.warmup_column_dense``) and runs the dense-metric
    sweep — the right tool for correlated posteriors, where a diagonal
    metric caps the step size at the smallest conditional scale.

    >>> import jax
    >>> import jax.numpy as jnp
    >>> import genjax_tpu as g
    >>> from genjax_tpu.kernels import column_hmc
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> q, accept, packer = column_hmc(
    ...     model, g.C["y"].set(2.0), (), ["mu"],
    ...     n_chains=256, n_steps=100, eps=0.5, L=5, seed=1,
    ... )
    >>> q.shape   # (packed dims padded to the sublane multiple, chains)
    (8, 256)
    >>> bool(abs(jnp.mean(q[0]) - 1.0) < 0.3)   # posterior mean = 1
    True
    """
    if constraint is None:
        # unconstrained use (pure prior sweeps) is advertised: normalize
        # here so generate/assess downstream see a real ChoiceMap
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)

    def init_one(k):
        tr, _ = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())

    # distinct PRNG root from the sweep's jr.key(seed) stream (with the same
    # root, chain i's init key can equal step i's sweep key bit-for-bit)
    q0 = jax.vmap(init_one, out_axes=1)(
        jr.split(jr.fold_in(jr.key(seed), 0xC0FFEE), n_chains)
    )
    if mass == "dense":
        if not warmup:
            raise ValueError(
                "mass='dense' requires warmup=True (the dense metric is "
                "estimated from the cross-chain spread during warmup)"
            )
        if inv_mass is not None:
            raise ValueError(
                "mass='dense' adapts its own full-covariance metric; "
                "inv_mass (a diagonal) cannot be combined with it"
            )
        from .dense_mass import hmc_sweep_dense_cols, warmup_column_dense

        q0, eps_d, cov_chol = warmup_column_dense(
            logdensity_cols, q0, seed, eps0=eps, L=L
        )
        # eps_d/cov_chol ride as traced jit ARGUMENTS so the lowered HLO
        # is identical across calls with different adapted values — the
        # in-process jit cache still misses (the lambda is fresh per
        # call), but the persistent compilation cache dedupes the
        # identical HLO
        q, accept = jax.jit(
            lambda q0, cov_chol, eps_d: hmc_sweep_dense_cols(
                logdensity_cols, q0, seed, n_steps=n_steps,
                eps=eps_d, L=L, cov_chol=cov_chol,
            )
        )(q0, cov_chol, eps_d)
        return q, accept, packer
    if warmup:
        from .hmc import warmup_column

        q0, eps, inv_mass = warmup_column(
            logdensity_cols, q0, seed, eps0=eps, L=L
        )
    q, accept = pallas_hmc(
        logdensity_cols,
        q0,
        seed,
        n_steps=n_steps,
        eps=eps,
        L=L,
        inv_mass=inv_mass,
    )
    return q, accept, packer


def column_nuts(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_steps: int,
    eps: float,
    max_depth: int = 8,
    seed: int = 0,
    warmup: bool = False,
    inv_mass=None,
):
    """Prior-initialized No-U-Turn sampling over ``addresses`` in the fused
    column layout. Returns ``(positions, accept_stat, mean_leapfrogs,
    packer)``."""
    from .nuts import nuts_sweep_cols

    if constraint is None:
        # unconstrained use (pure prior sweeps) is advertised: normalize
        # here so generate/assess downstream see a real ChoiceMap
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)

    def init_one(k):
        tr, _ = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())

    q0 = jax.vmap(init_one, out_axes=1)(
        jr.split(jr.fold_in(jr.key(seed), 0xC0FFEE), n_chains)
    )
    if warmup:
        from .nuts import warmup_column_nuts

        q0, eps, inv_mass = warmup_column_nuts(
            logdensity_cols, q0, seed, eps0=eps, max_depth=max_depth
        )
    q, accept, leaps = nuts_sweep_cols(
        logdensity_cols, q0, seed, n_steps=n_steps, eps=eps,
        max_depth=max_depth, inv_mass=inv_mass,
    )
    return q, accept, leaps, packer


def column_chees(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps: float = 0.05,
    seed: int = 0,
    collect: bool = False,
    **chees_kwargs,
):
    """Prior-initialized ChEES-adaptive HMC over ``addresses`` in the fused
    column layout (kernels/chees.py): step size, diagonal mass, AND
    trajectory length adapt jointly from cross-chain statistics — the
    turn-key alternative to picking ``L`` for ``column_hmc`` or paying
    NUTS's tree overhead. Returns ``(positions, info, packer)``."""
    from .chees import chees_hmc

    if constraint is None:
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)

    def init_one(k):
        tr, _ = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())

    q0 = jax.vmap(init_one, out_axes=1)(
        jr.split(jr.fold_in(jr.key(seed), 0xC0FFEE), n_chains)
    )
    q, info = chees_hmc(
        logdensity_cols, q0, seed,
        n_warmup=n_warmup, n_steps=n_steps, eps0=eps, collect=collect,
        **chees_kwargs,
    )
    return q, info, packer


def column_svgd(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_particles: int,
    n_steps: int,
    step_size: float = 0.15,
    seed: int = 0,
    **svgd_kwargs,
):
    """Prior-initialized SVGD over ``addresses``: a deterministic particle
    flow to the posterior (kernels/svgd.py). Unlike the samplers, SVGD runs
    on the REAL dimensions only — tile-padding dims are pinned at zero and
    sliced out of the kernel distance, because inert padding directions
    inflate the RBF metric and weaken the repulsion term (measured: the
    posterior sd collapsed 2× with padding included). Returns
    ``(positions (dim, n_particles), packer)``."""
    from .svgd import svgd

    if constraint is None:
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    ld = column_logdensity(model, constraint, args, packer)
    pad = packer.padded_dim - packer.dim

    def ld_real(qr):
        z = jnp.zeros((pad, qr.shape[1]), qr.dtype)
        return ld(jnp.concatenate([qr, z], axis=0))

    def init_one(k):
        tr, _ = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())[: packer.dim]

    q0 = jax.vmap(init_one, out_axes=1)(
        jr.split(jr.fold_in(jr.key(seed), 0xC0FFEE), n_particles)
    )
    q = svgd(ld_real, q0, n_steps=n_steps, step_size=step_size, **svgd_kwargs)
    return q, packer


def column_pt(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_rungs: int = 6,
    betas=None,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps: float = 0.05,
    L: int = 8,
    seed: int = 0,
    collect: bool = False,
    **pt_kwargs,
):
    """Prior-initialized parallel-tempering HMC over ``addresses`` in the
    fused column layout (kernels/pt.py): a geometric inverse-temperature
    ladder with even-odd replica exchange — the turn-key path for
    MULTIMODAL posteriors, where ``column_hmc``/``column_chees`` chains
    stay trapped in the mode they initialize in. Per-rung step sizes and
    masses adapt from cross-chain statistics. Returns
    ``(cold_positions, info, packer)``."""
    from .pt import geometric_ladder, pt_hmc

    if constraint is None:
        constraint = ChoiceMap.empty()
    if betas is None:
        betas = geometric_ladder(n_rungs)
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)

    def init_one(k):
        tr, _ = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())

    q0 = jax.vmap(init_one, out_axes=1)(
        jr.split(jr.fold_in(jr.key(seed), 0xC0FFEE), n_chains)
    )
    q, info = pt_hmc(
        logdensity_cols, q0, seed, betas=betas,
        n_warmup=n_warmup, n_steps=n_steps, eps0=eps, L=L,
        collect=collect, **pt_kwargs,
    )
    return q, info, packer
