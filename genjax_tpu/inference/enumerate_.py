"""Exact inference by enumeration over discrete supports.

No reference counterpart: the reference's only exact machinery is the
special-cased ``DiscreteHMM`` testbed
(``/root/reference/src/genjax/_src/inference/exact_testbed.py:45-91``).
This module generalizes it to *any* model whose unobserved addresses are
discrete with known finite supports: the full joint table is one vmapped
``assess`` over the cartesian product of supports — exact posteriors,
marginals, and log-evidence with no sampling error.

Design notes: the product enumeration is a single flat ``jax.vmap``
(one compiled program; the table is laid out as one (∏Kᵢ,) batch that XLA
tiles freely), not a Python loop over combinations. Enumeration is
exponential in the number of sites — that is inherent; the table size is
validated eagerly so a mistake fails at trace time, not in a 2⁶⁴-lane
launch.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..generative.choice_map import C, ChoiceMap
from ..generative.gfi import GenerativeFunction

_MAX_TABLE = 1 << 22  # 4M joint states: ~16 MB of f32 — plenty for exactness


@Pytree.dataclass
class EnumerationResult(Pytree):
    """Exact enumeration output.

    ``log_joint``: unnormalized log p(sites = combo, observations), shaped
    ``(K₁, …, Kₙ)`` in the order the sites were given. ``log_evidence``:
    log p(observations) = logsumexp over the table. ``log_posterior``: the
    normalized table. ``supports``: the candidate values per site (in axis
    order)."""

    log_joint: Any
    log_evidence: Any
    log_posterior: Any
    supports: tuple

    def marginal(self, axis: int):
        """Exact marginal posterior over one site (log-space)."""
        axes = tuple(i for i in range(self.log_posterior.ndim) if i != axis)
        return logsumexp(self.log_posterior, axis=axes)


def _set_path(path, value) -> ChoiceMap:
    path = path if isinstance(path, tuple) else (path,)
    return C[path].set(value)


def enumerate_posterior(
    model: GenerativeFunction,
    args: tuple,
    observations: ChoiceMap,
    sites: dict,
) -> EnumerationResult:
    """Exact posterior over ``sites`` given ``observations``.

    ``sites`` maps each unobserved address (str or tuple path) to its
    support array. Every unobserved address of the model must appear —
    ``assess`` raises ``MissingAddress`` otherwise, which is the intended
    error path for a forgotten site.
    """
    names = list(sites.keys())
    supports = tuple(jnp.asarray(sites[n]) for n in names)
    sizes = tuple(int(s.shape[0]) for s in supports)
    total = 1
    for k in sizes:
        total *= k
    if total > _MAX_TABLE:
        raise ValueError(
            f"enumeration table has {total} joint states "
            f"(> {_MAX_TABLE}); marginalize sites or use sampling inference"
        )

    # Flat cartesian product of support indices, shape (total, n_sites).
    grids = jnp.meshgrid(
        *[jnp.arange(k) for k in sizes], indexing="ij", sparse=False
    ) if sizes else []
    flat_idx = (
        jnp.stack([gr.reshape(-1) for gr in grids], axis=-1)
        if sizes
        else jnp.zeros((1, 0), dtype=jnp.int32)
    )

    def log_joint_of(idx_row):
        cm = observations
        for j, name in enumerate(names):
            cm = cm | _set_path(name, supports[j][idx_row[j]])
        score, _ = model.assess(cm, args)
        return score

    flat = jax.vmap(log_joint_of)(flat_idx)
    log_joint = flat.reshape(sizes) if sizes else flat[0]
    log_evidence = logsumexp(log_joint)
    return EnumerationResult(
        log_joint=log_joint,
        log_evidence=log_evidence,
        log_posterior=log_joint - log_evidence,
        supports=supports,
    )
