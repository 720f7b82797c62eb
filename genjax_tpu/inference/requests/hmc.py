"""Hamiltonian Monte Carlo as an edit request.

Parity: reference ``/root/reference/src/genjax/_src/inference/requests/
hmc.py`` (223 LoC) — ``selection_gradient`` :70 (grad/nongrad pytree unzip
:49-65), ``HMC`` :139 (leapfrog in ``lax.scan`` :170-194, α accept-ratio as
weight :198-203), ``SafeHMC`` :214.

Design notes: the whole trajectory is one ``lax.scan``; position updates
are ``Update`` edits of the trace, so arbitrary models (scan/vmap/static)
compose. Gradients flow through ``assess`` — pure XLA, vmappable over
thousands of chains.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax

from ...core.diff import Diff
from ...core.pytree import Pytree
from ...core.typing_ import PRNGKey
from ...generative.concepts import (
    Argdiffs,
    DiffAnnotate,
    EditRequest,
    Retdiff,
    Update,
    Weight,
)
from ...generative.selection import Selection
from ...generative.trace import Trace


# the shared raveled-vector gradient path lives in grad_view.py
from .grad_view import (  # noqa: E402 — re-exported for existing importers
    selected_logdensity,
    selection_gradient,
    split_ravel,
)


# ----------------------------------------------------------------------
# the request
# ----------------------------------------------------------------------


@Pytree.dataclass
class HMC(EditRequest):
    """Leapfrog-integrate Hamiltonian dynamics over the selected (continuous)
    choices; the SMCP3 weight is the MH log-acceptance ratio α
    (reference hmc.py:139).

    ``inv_mass``: optional diagonal inverse mass over the *raveled*
    selected-choice vector (same convention as the ``NUTS`` request and
    ``inference.adaptation.cross_chain_inv_mass``) — momenta draw from
    ``N(0, M)`` and the drift is ``eps * M⁻¹ r``.

    >>> import jax
    >>> import genjax_tpu as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> tr, _ = model.generate(jax.random.key(0), g.C["y"].set(1.0), ())
    >>> new_tr, alpha, _rd, bwd = tr.edit(
    ...     jax.random.key(1), g.HMC(g.S["mu"], 0.1, L=5)
    ... )
    >>> bool(jax.numpy.isfinite(alpha))     # the MH log-acceptance ratio
    True
    >>> isinstance(bwd, HMC)                # backward request for SMCP3
    True
    """

    selection: Selection
    eps: Any
    L: int = Pytree.static(default=10)
    inv_mass: Any = None

    def edit(
        self, key: PRNGKey, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("HMC requires unchanged arguments.")

        # One differentiable log-joint over the RAVELED selected values
        # (grad_view.selected_logdensity — the path shared with NUTS and
        # the slice samplers): the leapfrog scan carries three flat
        # vectors, each step costs one value_and_grad of assess, and a
        # diagonal mass matrix is a single elementwise vector op. The
        # trace is materialized once at the end.
        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(),
            tr.get_choices(),
            self.selection,
            Diff.tree_primal(argdiffs),
        )
        vg = jax.value_and_grad(logdensity)
        if self.inv_mass is None:
            inv_mass = jnp.ones_like(z0)
        else:
            inv_mass = jnp.broadcast_to(
                jnp.asarray(self.inv_mass, z0.dtype), z0.shape
            )
        mom_std = 1.0 / jnp.sqrt(inv_mass)
        key, k_mom, k_update = jr.split(key, 3)
        r0 = mom_std * jr.normal(k_mom, z0.shape)

        def kinetic(r):
            return 0.5 * jnp.sum(inv_mass * r * r)

        lp0, g0 = vg(z0)

        def leapfrog(carry, _step):
            z, g, r = carry
            r = r + (self.eps / 2) * g
            z = z + self.eps * inv_mass * r
            lp, g = vg(z)
            r = r + (self.eps / 2) * g
            return (z, g, r), lp

        (z1, _g1, r1), lps = lax.scan(
            leapfrog, (z0, g0, r0), None, length=self.L
        )
        lp1 = lps[-1]

        final_trace, _, retdiff, _ = Update(to_choices(z1)).edit(
            k_update, tr, argdiffs
        )
        alpha = lp1 - lp0 + kinetic(r0) - kinetic(r1)
        return (
            final_trace,
            alpha,
            retdiff,
            HMC(self.selection, self.eps, self.L, self.inv_mass),
        )


def SafeHMC(selection: Selection, eps, L: int = 10) -> DiffAnnotate:
    """HMC wrapped with a retdiff no-change assertion (reference
    hmc.py:214)."""

    def retdiff_assertion(retdiff):
        assert Diff.static_check_no_change(retdiff), (
            "SafeHMC: the return value changed under the move."
        )
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)


def mh_accept(key: PRNGKey, trace: Trace, new_trace: Trace, alpha: Weight):
    """Metropolis-Hastings accept step over an edit's α weight: returns the
    accepted trace and the accept flag. Batch-friendly: one ``tree_map`` of
    selects, vmappable over chains.

    Robust to callee-identity churn: a model whose body constructs local
    ``@gen``/``Closure`` objects mints fresh (semantically identical)
    static leaves every handler run, so old/new treedefs can differ while
    the DYNAMIC leaves align exactly — in that case select leaf-by-leaf
    and keep the new trace's structure."""
    log_u = jnp.log(jr.uniform(key))
    accept = log_u < alpha

    def pick(new, old):
        return jnp.where(accept, new, old)

    try:
        out = jtu.tree_map(pick, new_trace, trace)
    except ValueError:
        new_leaves, new_def = jtu.tree_flatten(new_trace)
        old_leaves = jtu.tree_leaves(trace)
        if len(new_leaves) != len(old_leaves) or any(
            jnp.shape(n) != jnp.shape(o)
            or jnp.result_type(n) != jnp.result_type(o)
            for n, o in zip(new_leaves, old_leaves)
        ):
            # a REAL structural difference, not just static-identity
            # churn — mixing leaves positionally would corrupt the trace
            raise
        out = jtu.tree_unflatten(
            new_def, [pick(n, o) for n, o in zip(new_leaves, old_leaves)]
        )
    return out, accept
