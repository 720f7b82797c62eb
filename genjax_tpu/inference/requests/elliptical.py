"""Elliptical slice sampling as an edit request — the trace-level
counterpart of ``kernels/elliptical.py``.

No reference counterpart (the reference's request set stops at HMC/
Regenerate — `/root/reference/src/genjax/_src/inference/requests/`). The
request targets any model whose SELECTED choices carry a (multivariate)
Gaussian prior: the likelihood is everything else in the trace. One
transition draws the ellipse through the current value and a fresh prior
sample and shrinks the angle bracket until the likelihood threshold is
met (Murray, Adams & MacKay 2010) — no step size, no trajectory length.

Semantics as an EditRequest: the transition is in detailed balance with
the posterior, so the SMCP3 weight is 0 and ``inference.mcmc.mh`` always
accepts; the backward request is the request itself.

The likelihood is computed as ``assess(joint) − N(z; mean, chol·cholᵀ)``
over the raveled selected values, so it is exact for ANY downstream
structure (scan/vmap/switch) — the only user obligation is that ``mean``/
``chol`` really are the prior over that ravel (matching the model), which
cannot be checked mechanically here.

Notes: the shrink loop is a scalar ``lax.while_loop``; under
``jax.vmap`` over chains JAX batches it into the same lock-step masked
loop the column kernel uses.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import jax.random as jr
from jax import lax
from jax.scipy.linalg import solve_triangular

from ...core.diff import Diff
from ...core.pytree import Pytree
from ...core.typing_ import PRNGKey
from ...generative.concepts import (
    Argdiffs,
    EditRequest,
    Retdiff,
    Update,
    Weight,
)
from ...generative.selection import Selection
from ...generative.trace import Trace
from .grad_view import selected_logdensity

_TWO_PI = 6.283185307179586


@Pytree.dataclass
class EllipticalSlice(EditRequest):
    """One elliptical-slice transition over the selected choices.

    ``mean``/``chol`` describe the selected choices' GAUSSIAN PRIOR over
    their raveled vector: ``chol`` is a lower Cholesky factor ``(d, d)``,
    or a ``(d,)``/scalar standard deviation for diagonal priors.
    ``max_iters`` caps the bracket-shrink loop (termination is a.s.; at
    the cap the move degrades to an exact no-op)."""

    selection: Selection
    mean: Any = 0.0
    chol: Any = 1.0
    max_iters: int = Pytree.static(default=64)

    def edit(
        self, key: PRNGKey, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError(
                "EllipticalSlice requires unchanged arguments."
            )

        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(),
            tr.get_choices(),
            self.selection,
            Diff.tree_primal(argdiffs),
        )
        d = z0.shape[0]

        mean = jnp.broadcast_to(jnp.asarray(self.mean, z0.dtype), z0.shape)
        chol = jnp.asarray(self.chol, z0.dtype)

        def prior_logpdf(z):
            c = z - mean
            if chol.ndim == 2:
                a = solve_triangular(chol, c, lower=True)
                logdet = jnp.sum(jnp.log(jnp.diag(chol)))
            else:
                std = jnp.broadcast_to(chol, z.shape)
                a = c / std
                logdet = jnp.sum(jnp.log(std))
            return (
                -0.5 * jnp.sum(a * a)
                - logdet
                - 0.5 * d * jnp.log(2.0 * jnp.pi)
            )

        def loglik(z):
            return logdensity(z) - prior_logpdf(z)

        k_nu, k_u, k_theta, k_update = jr.split(key, 4)
        eps = jr.normal(k_nu, z0.shape, z0.dtype)
        nu = chol @ eps if chol.ndim == 2 else jnp.broadcast_to(chol, z0.shape) * eps

        log_y = loglik(z0) + jnp.log(jr.uniform(k_u, dtype=z0.dtype))
        theta0 = jr.uniform(k_theta, dtype=z0.dtype) * _TWO_PI
        centered = z0 - mean

        def proposal(theta):
            return mean + centered * jnp.cos(theta) + nu * jnp.sin(theta)

        ok0 = loglik(proposal(theta0)) > log_y

        def cond(state):
            i, _theta, _lo, _hi, ok = state
            return jnp.logical_and(i < self.max_iters, ~ok)

        def body(state):
            i, theta, lo, hi, _ok = state
            lo = jnp.where(theta < 0, theta, lo)
            hi = jnp.where(theta < 0, hi, theta)
            theta = lo + (hi - lo) * jr.uniform(
                jr.fold_in(k_theta, i + 1), dtype=z0.dtype
            )
            return i + 1, theta, lo, hi, loglik(proposal(theta)) > log_y

        _, theta, _, _, ok = lax.while_loop(
            cond, body, (jnp.asarray(0), theta0, theta0 - _TWO_PI, theta0, ok0)
        )
        z1 = jnp.where(ok, proposal(theta), z0)

        values = to_choices(z1)
        final_trace, _, retdiff, _ = Update(values).edit(
            k_update, tr, argdiffs
        )
        return (
            final_trace,
            jnp.asarray(0.0),
            retdiff,
            EllipticalSlice(self.selection, self.mean, self.chol, self.max_iters),
        )
