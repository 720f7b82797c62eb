"""Enumerative Gibbs moves for discrete addresses, plus a cyclic sweep
driver for composing Gibbs-within-MH kernels.

No reference counterpart: the reference's discrete-site story stops at
``Regenerate`` (prior proposals, MH-corrected) — see
``/root/reference/src/genjax/_src/core/generative/requests.py:64`` — and
its ADEV enumeration primitives handle *gradients*, not posterior moves.
Exact full-conditional sampling over an enumerable support is the classic
missing move (Gen.jl provides it as user-space enumeration); here it is a
framework driver built on the ``Update`` edit weight.

Semantics: the ``Update`` weight for a fully-determined constraint at a
discrete address is the joint-density ratio
``log p(c, rest) − log p(cur, rest)`` (distribution.py:179-244 convention),
so a categorical draw over the enumerated weights *is* the exact full
conditional p(addr = c | rest) — a Gibbs move, accepted with probability 1.

Design notes: the support enumeration is one ``jax.vmap`` over
candidates (a single compiled program, K lanes); the per-lane
variant vmaps (lane × candidate) ``IndexRequest`` slice edits — valid
*block* Gibbs because ``Vmap``-combinator lanes are conditionally
independent given everything outside the combinator. A whole sweep chain is
one ``lax.scan`` (no host round trips).

Caveat (documented, checked nowhere): if changing the discrete value flips
a ``Switch`` branch so that *new* addresses are sampled, the Update weight
includes proposal terms and the move is no longer an exact conditional —
use ``mh_move`` (accept-corrected) for structure-changing supports.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import C, ChoiceMap
from ..generative.concepts import EditRequest, IndexRequest, Update
from ..generative.trace import Trace


@Pytree.dataclass
class GibbsInfo(Pytree):
    """Diagnostics from one enumerative move: the sampled support index
    (per lane for the vmap variant) and the enumerated conditional
    log-weights (normalized: log full-conditional probabilities)."""

    index: Any
    log_probs: Any


def _set_path(path: tuple, value) -> ChoiceMap:
    """Builder sugar: C[*path].set(value), with the empty path meaning a
    bare distribution constraint."""
    if len(path) == 0:
        return ChoiceMap.choice(value)
    return C[path].set(value)


def _request_for(site, value) -> EditRequest:
    if callable(site):
        return site(value)
    path = site if isinstance(site, tuple) else (site,)
    return Update(_set_path(path, value))


def enumerative_gibbs(
    key: PRNGKey,
    trace: Trace,
    site,
    support,
) -> tuple[Trace, GibbsInfo]:
    """Exact Gibbs at one discrete address: enumerate ``support``, sample
    the full conditional, apply the chosen value.

    ``site`` is an address (str or tuple path) or a callable
    ``value -> EditRequest`` for non-Update moves. ``support`` is an array
    (or pytree with a leading candidate axis) of concrete candidate values.
    """
    support = jtu.tree_map(jnp.asarray, support)
    k_enum, k_cat, k_apply = jr.split(key, 3)

    def weight_of(c):
        _, w, _, _ = trace.edit(k_enum, _request_for(site, c))
        return w

    log_w = jax.vmap(weight_of)(support)
    idx = jr.categorical(k_cat, log_w)
    chosen = jtu.tree_map(lambda s: s[idx], support)
    new_trace, _, _, _ = trace.edit(k_apply, _request_for(site, chosen))
    log_probs = jax.nn.log_softmax(log_w)
    return new_trace, GibbsInfo(index=idx, log_probs=log_probs)


def enumerative_gibbs_vmap(
    key: PRNGKey,
    trace: Trace,
    site: tuple,
    support,
    n_lanes: int | None = None,
    lane_batch: int | None = None,
) -> tuple[Trace, GibbsInfo]:
    """Block Gibbs over every lane of a ``Vmap``-combinator site.

    ``site`` is the address path to the per-lane choice with exactly one
    ``None`` marking the lane axis, e.g. ``("assign", None, "z")`` for a
    model with ``kernel.vmap() @ "assign"`` whose kernel samples ``"z"``
    (or ``(None,)`` when the trace's own gen fn is the Vmap of a bare
    distribution). All lanes' full conditionals are enumerated against the
    *same* base trace — valid block Gibbs because vmap lanes cannot depend
    on one another — then every lane's draw is applied in one ``Update``.

    Cost: (n_lanes × K) slice edits in one vmapped program; transient
    memory is n_lanes × K trace copies. ``lane_batch`` bounds that: lanes
    are processed ``lane_batch`` at a time under a sequential ``lax.map``
    (peak memory lane_batch × K copies), identical draws to the fully
    vmapped path.
    """
    if site.count(None) != 1:
        raise ValueError(
            "site must contain exactly one None marking the lane axis; "
            f"got {site!r}"
        )
    lane_pos = site.index(None)
    prefix, postfix = site[:lane_pos], site[lane_pos + 1 :]
    support = jtu.tree_map(jnp.asarray, support)

    if n_lanes is None:
        cur = trace.get_choices()
        for a in prefix:
            cur = cur.get_submap(a)
        probe = cur[(slice(None),) + postfix] if postfix else cur[:]
        leaf = jtu.tree_leaves(probe)[0]
        n_lanes = int(leaf.shape[0])

    def lane_request(i, c) -> EditRequest:
        req: EditRequest = IndexRequest(i, Update(_set_path(postfix, c)))
        from ..lang.static_lang import StaticRequest

        for a in reversed(prefix):
            req = StaticRequest.d({a: req})
        return req

    k_enum, k_cat, k_apply = jr.split(key, 3)
    lanes = jnp.arange(n_lanes)

    def weight_of(i, c):
        _, w, _, _ = trace.edit(k_enum, lane_request(i, c))
        return w

    def lane_weights(i):
        return jax.vmap(lambda c: weight_of(i, c))(support)

    # (n_lanes, K) conditional log-weights.
    if lane_batch is None or lane_batch >= n_lanes:
        log_w = jax.vmap(lane_weights)(lanes)
    else:
        n_support = jtu.tree_leaves(support)[0].shape[0]
        pad = (-n_lanes) % lane_batch
        padded = (
            jnp.concatenate([lanes, jnp.zeros(pad, lanes.dtype)])
            if pad
            else lanes
        )
        chunked = lax.map(
            lambda ch: jax.vmap(lane_weights)(ch),
            padded.reshape(-1, lane_batch),
        )
        log_w = chunked.reshape(-1, n_support)[:n_lanes]
    idx = jr.categorical(k_cat, log_w, axis=-1)
    chosen = jtu.tree_map(lambda s: s[idx], support)
    new_trace, _, _, _ = trace.edit(
        k_apply, Update(C[prefix + (lanes,) + postfix].set(chosen))
    )
    return new_trace, GibbsInfo(index=idx, log_probs=jax.nn.log_softmax(log_w))


def enum_move(site, support) -> Callable:
    """A sweep move: exact enumerative Gibbs at ``site``."""

    def move(key: PRNGKey, trace: Trace) -> Trace:
        new_trace, _ = enumerative_gibbs(key, trace, site, support)
        return new_trace

    return move


def enum_vmap_move(
    site: tuple,
    support,
    n_lanes: int | None = None,
    lane_batch: int | None = None,
) -> Callable:
    """A sweep move: per-lane block Gibbs at a vmapped ``site``."""

    def move(key: PRNGKey, trace: Trace) -> Trace:
        new_trace, _ = enumerative_gibbs_vmap(
            key, trace, site, support, n_lanes=n_lanes, lane_batch=lane_batch
        )
        return new_trace

    return move


def mh_move(request) -> Callable:
    """A sweep move: one MH-accepted edit (e.g. ``HMC`` on the continuous
    block, or a ``Selection``/``Regenerate`` for structure-changing
    discrete sites)."""

    def move(key: PRNGKey, trace: Trace) -> Trace:
        from .mcmc import mh

        new_trace, _ = mh(key, trace, request)
        return new_trace

    return move


@Pytree.dataclass
class GibbsSweepResult(Pytree):
    """Final trace plus optional per-sweep records (leading axis =
    ``n_sweeps``)."""

    trace: Trace
    history: Any


def gibbs_sweep(
    key: PRNGKey,
    trace: Trace,
    moves: Sequence[Callable],
    n_sweeps: int = 1,
    *,
    record: Callable[[Trace], Any] | None = None,
) -> GibbsSweepResult:
    """Cycle ``moves`` (each ``(key, trace) -> trace``) for ``n_sweeps``
    in one ``lax.scan`` — the deterministic-scan Gibbs kernel. Build moves
    with ``enum_move`` / ``enum_vmap_move`` / ``mh_move``."""
    moves = tuple(moves)

    def sweep(tr, k):
        ks = jr.split(k, len(moves))
        for mv, mk in zip(moves, ks):
            tr = mv(mk, tr)
        out = record(tr) if record is not None else None
        return tr, out

    final, history = lax.scan(sweep, trace, jr.split(key, n_sweeps))
    return GibbsSweepResult(trace=final, history=history)
