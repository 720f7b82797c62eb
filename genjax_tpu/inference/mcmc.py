"""MCMC drivers: Metropolis–Hastings over edit requests, and chain runners.

The reference provides MCMC *moves* (HMC/Rejuvenate edit requests,
Regenerate) but no driver — its tests hand-roll accept loops
(/root/reference/tests/inference/test_requests.py:129-140). This module is
the framework-level driver the reference lacks: a chain is
a ``lax.scan`` of edits, and many chains are a vmapped batch whose leading
axis shards over a device mesh (see ``genjax_tpu.parallel``).

Weight conventions (why ``mh`` treats Regenerate specially): a
``Regenerate`` edit returns the *joint*-density ratio as its weight
(reference distribution.py:258-271 convention, round-trip cancellable),
while the MH log-acceptance for a regenerate-from-prior move is the
*likelihood* ratio. ``mh`` subtracts the selected choices' score change
(via ``project``) to convert: α = w − [proj_new(sel) − proj_old(sel)].
``HMC``/``Rejuvenate`` already return α as their weight.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.concepts import EditRequest, Regenerate
from ..generative.selection import Selection
from ..generative.trace import Trace


def mh(
    key: PRNGKey,
    trace: Trace,
    request: EditRequest | Selection,
) -> tuple[Trace, Any]:
    """One Metropolis–Hastings step driven by an edit request (or a
    ``Selection``, shorthand for ``Regenerate(selection)``). Returns
    ``(trace, accepted)``."""
    if isinstance(request, Selection):
        request = Regenerate(request)
    k_edit, k_proj_new, k_proj_old, k_acc = jr.split(key, 4)
    new_trace, w, _rd, _bwd = trace.edit(k_edit, request)
    if isinstance(request, Regenerate):
        sel = request.selection
        w = w - (
            new_trace.project(k_proj_new, sel) - trace.project(k_proj_old, sel)
        )
    from .requests.hmc import mh_accept

    return mh_accept(k_acc, trace, new_trace, w)


@Pytree.dataclass
class MHChainResult(Pytree):
    """Final trace(s) plus per-step diagnostics."""

    trace: Trace
    accept_rate: Any
    history: Any  # pytree of recorded values per step (or None)


def run_chain(
    key: PRNGKey,
    trace: Trace,
    request: EditRequest | Selection,
    n_steps: int,
    *,
    record: Callable[[Trace], Any] | None = None,
) -> MHChainResult:
    """Run ``n_steps`` of MH in a single ``lax.scan`` (one XLA while-loop:
    no per-step dispatch, fully fusable)."""

    def step(tr, k):
        tr, accepted = mh(k, tr, request)
        out = record(tr) if record is not None else None
        return tr, (jnp.asarray(accepted, jnp.float32), out)

    final, (accepts, history) = lax.scan(
        step, trace, jr.split(key, n_steps), length=n_steps
    )
    return MHChainResult(final, jnp.mean(accepts), history)


def run_chains_hmc(
    key: PRNGKey,
    traces: Trace,
    selection: Selection,
    *,
    eps,
    L: int = 10,
    n_steps: int = 1,
    inv_mass: Any = None,
    chain_axis: int = 0,
) -> tuple[Trace, Any]:
    """``n_steps`` of MH-adjusted HMC on a BATCH of traces, amortizing the
    trace machinery over the whole sweep — the fast path for the workload
    ``run_chains(..., HMC(...))`` expresses one transition at a time.

    Same Markov chain as iterating ``mh(k, tr, HMC(selection, eps, L))``
    (momentum refresh → ``L`` leapfrogs → MH accept on the selected
    choices, everything else frozen), but restructured batch-first:

    - the selected choices of ALL chains are raveled once into a
      ``(d, n_chains)`` column block (chains on the last axis);
    - the sweep runs as one ``lax.scan`` with BULK ``(d, N)`` momentum
      draws (``kernels.hmc._reference_hmc`` — the same sweep the column
      kernels use), instead of ``n_chains`` per-chain threefry streams;
    - the trace is materialized ONCE at the end via a vmapped ``Update``
      edit, instead of once per transition.

    The log-density is the GFI's own ``assess`` over each chain's frozen
    complement (``grad_view.selected_logdensity`` semantics), so any model
    — static/scan/vmap/switch — composes, and per-chain constraints /
    frozen choices are honored. ``bench.py gfi`` compares it with the
    column kernel and the per-transition edit API.

    Args:
        traces: a batched trace pytree (e.g. from ``vmap(generate)``),
            chain axis at ``chain_axis`` on every leaf.
        selection: continuous choices to sample (same contract as ``HMC``).
        inv_mass: optional diagonal inverse mass over the raveled
            selected vector (shape ``(d,)``), as in the ``HMC`` request.

    Returns:
        ``(traces, accept_rate)`` — same layout as the input batch.

    >>> import jax, jax.numpy as jnp, jax.random as jr
    >>> import genjax_tpu as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> obs = g.C["y"].set(2.0)
    >>> trs = jax.vmap(lambda k: model.generate(k, obs, ())[0])(
    ...     jr.split(jr.key(0), 512)
    ... )
    >>> trs, acc = g.run_chains_hmc(
    ...     jr.key(1), trs, g.S["mu"], eps=0.6, L=5, n_steps=100
    ... )
    >>> bool(abs(jnp.mean(trs.get_choices()["mu"]) - 1.0) < 0.15)  # post. mean 1
    True
    >>> bool(acc > 0.5)
    True
    """
    from ..kernels.hmc import _reference_hmc
    from .requests.grad_view import column_view

    k_sweep, k_upd = jr.split(key)
    z_cols, ld_cols, write_back = column_view(traces, selection, chain_axis)
    z_final, accept_rate = _reference_hmc(
        ld_cols,
        z_cols,
        jr.randint(k_sweep, (), 0, 2**30),
        n_steps=n_steps,
        eps=eps,
        L=L,
        inv_mass=inv_mass,
    )
    return write_back(z_final, k_upd), accept_rate


def run_chains_nuts(
    key: PRNGKey,
    traces: Trace,
    selection: Selection,
    *,
    eps,
    max_depth: int = 8,
    n_steps: int = 1,
    inv_mass: Any = None,
    chain_axis: int = 0,
) -> tuple[Trace, Any, Any]:
    """``n_steps`` of NUTS on a BATCH of traces — the ``run_chains_hmc``
    pattern with the batched column NUTS sweep
    (``kernels.nuts.nuts_sweep_cols``: scalar loop conditions,
    collective early exit, bulk draws) as the dynamics. Same chain as
    iterating the ``NUTS`` edit request; the density is the GFI's own
    ``assess`` over each chain's frozen complement and the traces are
    rebuilt by one vmapped ``Update`` at the end.

    Returns ``(traces, accept_stat, mean_leapfrogs)``.

    >>> import jax, jax.numpy as jnp, jax.random as jr
    >>> import genjax_tpu as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> obs = g.C["y"].set(2.0)
    >>> trs = jax.vmap(lambda k: model.generate(k, obs, ())[0])(
    ...     jr.split(jr.key(0), 256)
    ... )
    >>> trs, acc, leaps = g.run_chains_nuts(
    ...     jr.key(1), trs, g.S["mu"], eps=0.5, n_steps=100
    ... )
    >>> bool(abs(jnp.mean(trs.get_choices()["mu"]) - 1.0) < 0.2)
    True
    >>> bool(acc > 0.5) and bool(leaps >= 1.0)
    True
    """
    from ..kernels.nuts import nuts_sweep_cols
    from .requests.grad_view import column_view

    k_sweep, k_upd = jr.split(key)
    z_cols, ld_cols, write_back = column_view(traces, selection, chain_axis)
    z_final, accept_stat, leaps = nuts_sweep_cols(
        ld_cols,
        z_cols,
        jr.randint(k_sweep, (), 0, 2**30),
        n_steps=n_steps,
        eps=eps,
        max_depth=max_depth,
        inv_mass=inv_mass,
    )
    return write_back(z_final, k_upd), accept_stat, leaps


def run_chains(
    key: PRNGKey,
    make_trace: Callable[[PRNGKey], Trace],
    request: EditRequest | Selection,
    n_steps: int,
    n_chains: int,
    *,
    record: Callable[[Trace], Any] | None = None,
    layout: str = "lanes",
) -> MHChainResult:
    """Many independent MH chains as one vmapped program.

    ``layout="lanes"`` (default) batches with the chain axis LAST, so
    per-chain event dims (often ≤16 wide) are the leading axes and the
    chains are the contiguous one. The returned result is transposed back
    to the conventional chains-leading shape, so the API is unchanged;
    pass ``layout="batch"`` to keep the old internal layout (e.g. when a
    custom ``record`` returns values whose leading axis must be stepwise).
    """
    axis = -1 if layout == "lanes" else 0

    def one(k):
        k_init, k_run = jr.split(k)
        tr = make_trace(k_init)
        return run_chain(k_run, tr, request, n_steps, record=record)

    res = jax.vmap(one, out_axes=axis)(jr.split(key, n_chains))
    if axis == -1:
        # restore the conventional chains-leading layout on the outputs
        res = jtu.tree_map(lambda v: jnp.moveaxis(v, -1, 0), res)
    return res
