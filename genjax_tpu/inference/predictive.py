"""Posterior-predictive sampling from fitted draws.

No reference counterpart (the reference ships GFI pieces; replaying
posterior draws through the model is left to user code). This driver
closes the practitioner loop: ``sample_posterior`` (or any dict of draws)
→ ``posterior_predictive`` → predictive arrays for unconstrained
addresses.

Design notes: one vmapped ``generate`` over the draw batch — a single
compiled program; the draw axis is a leading batch axis that shards over
a mesh like any other chain/particle axis.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr

from ..core.typing_ import PRNGKey
from ..generative.choice_map import C, ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from .sample import PosteriorSamples


def _draws_dict(samples) -> dict:
    """Normalize a draws container to {path: (n_draws, *event)}."""
    if isinstance(samples, PosteriorSamples):
        out = {}

        def walk(chm, prefix=()):
            v = chm.get_value()
            if v is not None:
                if isinstance(v, Mask):
                    v = v.value
                # (chains, samples, *event) -> (chains*samples, *event)
                out[prefix if len(prefix) > 1 else prefix[0]] = v.reshape(
                    (-1,) + v.shape[2:]
                )
                return
            for a in chm.static_addresses():
                walk(chm.get_submap(a), prefix + (a,))

        walk(samples.positions)
        return out
    return {k: jnp.asarray(v) for k, v in dict(samples).items()}


def posterior_predictive(
    key: PRNGKey,
    model: GenerativeFunction,
    args: tuple,
    samples,
    *,
    n_draws: int | None = None,
) -> Any:
    """Replay posterior draws through ``model``: every address present in
    ``samples`` is constrained to a draw, everything else (the predictive
    sites) is sampled fresh. Returns the batched choices of the predictive
    traces (leading axis = draws) — read sites with ``out[addr]`` /
    ``out[addr, :]``.

    ``samples``: a ``PosteriorSamples`` (chains × samples are flattened
    into one draw axis) or a dict ``{address path: (n, *event)}``.
    ``n_draws``: evenly-spaced subsample of the draw axis (default: all).
    """
    draws = _draws_dict(samples)
    if not draws:
        raise ValueError("posterior_predictive needs at least one site")
    sizes = {k: int(jnp.shape(v)[0]) for k, v in draws.items()}
    n = min(sizes.values())
    if len(set(sizes.values())) != 1:
        raise ValueError(f"sites disagree on the draw count: {sizes}")
    if n_draws is not None and n_draws < n:
        idx = jnp.linspace(0, n - 1, n_draws).astype(jnp.int32)
        draws = {k: v[idx] for k, v in draws.items()}
        n = n_draws

    paths = list(draws.keys())

    def one(k, row):
        cm = ChoiceMap.empty()
        for p, v in zip(paths, row):
            path = p if isinstance(p, tuple) else (p,)
            cm = cm | C[path].set(v)
        tr, _ = model.generate(k, cm, args)
        return tr.get_choices()

    rows = tuple(draws[p] for p in paths)
    return jax.vmap(one, in_axes=(0, 0))(jr.split(key, n), rows)
