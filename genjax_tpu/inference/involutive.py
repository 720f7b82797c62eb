"""Involutive MCMC: MH moves defined by an auxiliary generative function
and a deterministic involution on (model choices, auxiliary choices).

No reference counterpart — the reference's programmable moves stop at
``Rejuvenate`` (custom *forward* proposal, Update-applied;
``/root/reference/src/genjax/_src/inference/requests/rejuvenate.py:45-94``).
Involutive MCMC (Cusumano-Towner, Lew & Mansinghka 2020; Gen.jl's
``mh(trace, proposal, involution)``) is the general recipe that subsumes
random-walk moves, proposals with deterministic transport, and
reversible-jump/split-merge moves across model structures.

The kernel: sample auxiliary choices ``u ~ q(·; t)``, map
``(t', u') = f(t, u)`` with ``f`` an involution, accept with

    α = [log p(t') + log q(u'; t')] − [log p(t) + log q(u; t)]
        + log |det J_f|

where the Jacobian is taken over the *continuous* coordinates of
``(t, u)`` (discrete/integer leaves pass through and contribute no
volume). Dimension balance — ``dim(t) + dim(u) = dim(t') + dim(u')`` on
the continuous ravel — is checked statically at trace time.

Design notes: the model-score ratio comes from one fully-determined
``Update`` edit (no fresh sampling, so the weight is exactly
``log p(t') − log p(t)`` even across Switch-branch changes, provided the
involution emits every address of the new structure); the Jacobian is a
dense ``jax.jacfwd`` over the raveled continuous coordinates — moves are
typically low-dimensional, so this is a few small ops; the whole move
is jit/vmap/scan-composable (one program, no host sync).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import Update
from ..generative.gfi import GenerativeFunction
from ..generative.trace import Trace
from .requests.grad_view import split_ravel
from .requests.hmc import mh_accept


@Pytree.dataclass
class InvolutiveInfo(Pytree):
    """Move diagnostics: accept flag, log-acceptance, the Jacobian
    log-determinant, and (when ``check=True``) the max round-trip error of
    applying the involution twice (should be ~0 for a true involution)."""

    accepted: Any
    alpha: Any
    logdet: Any
    involution_error: Any


def _continuous_ravel(t_choices, u_choices):
    """Split (t, u) into continuous (raveled) and passthrough parts —
    one ``split_ravel`` over the pair keeps both trees on a single
    vector layout."""
    return split_ravel((t_choices, u_choices))


def involutive_mh(
    key: PRNGKey,
    trace: Trace,
    aux_model: GenerativeFunction,
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    *,
    aux_args: Callable[[Trace], tuple] | tuple = (),
    jacobian: str = "auto",
    check: bool = False,
) -> tuple[Trace, InvolutiveInfo]:
    """One involutive-MH step on ``trace``.

    ``aux_model`` proposes auxiliary choices; its arguments come from
    ``aux_args`` (a static tuple, or a callable ``trace -> tuple`` so the
    proposal can be data-driven). ``involution`` maps
    ``(model_choices, aux_choices) -> (new_model_choices, new_aux_choices)``
    and must be self-inverse; it must emit *every* address of the new model
    structure (so the Update that applies it samples nothing fresh).

    ``jacobian``: ``"auto"`` differentiates the involution's continuous
    ravel (exact log-|det|); ``"zero"`` certifies a volume-preserving move
    (pure permutations/translations) and skips the O(d²) Jacobian.
    """
    args_of = aux_args if callable(aux_args) else (lambda _tr: aux_args)
    k_aux, k_edit, k_acc = jr.split(key, 3)

    t = trace.get_choices()
    u_trace = aux_model.simulate(k_aux, args_of(trace))
    u = u_trace.get_choices()
    q_fwd = u_trace.get_score()

    t_new, u_new = involution(t, u)

    # Jacobian over the continuous coordinates.
    flat_in, rebuild = _continuous_ravel(t, u)
    if jacobian == "zero" or flat_in.size == 0:
        logdet = jnp.asarray(0.0)
    elif jacobian == "auto":

        def f(z):
            flat_out, _ = split_ravel(involution(*rebuild(z)))
            return flat_out

        out_dim = jax.eval_shape(f, flat_in).shape[0]
        if out_dim != flat_in.shape[0]:
            raise ValueError(
                "involution is not dimension-balanced on the continuous "
                f"coordinates: dim(t)+dim(u) = {flat_in.shape[0]} in, "
                f"{out_dim} out — balance with auxiliary choices"
            )
        jac = jax.jacfwd(f)(flat_in)
        _sign, logdet = jnp.linalg.slogdet(jac)
    else:
        raise ValueError(f"jacobian must be 'auto' or 'zero', got {jacobian!r}")

    new_trace, w_model, _rd, _bwd = trace.edit(k_edit, Update(t_new))
    q_bwd, _ = aux_model.assess(u_new, args_of(new_trace))

    alpha = w_model + q_bwd - q_fwd + logdet

    if check:
        # Round-trip on the continuous ravel: f(f(t, u)) must restore the
        # continuous coordinates (discrete leaves are not compared).
        flat_rt, _ = split_ravel(involution(t_new, u_new))
        if flat_rt.size != flat_in.size:
            involution_error = jnp.asarray(jnp.inf)
        else:
            involution_error = (
                jnp.max(jnp.abs(flat_rt - flat_in))
                if flat_in.size
                else jnp.asarray(0.0)
            )
    else:
        involution_error = jnp.asarray(0.0)

    out, accepted = mh_accept(k_acc, trace, new_trace, alpha)
    return out, InvolutiveInfo(
        accepted=accepted,
        alpha=alpha,
        logdet=logdet,
        involution_error=involution_error,
    )


def involutive_move(
    aux_model: GenerativeFunction,
    involution: Callable,
    *,
    aux_args: Callable[[Trace], tuple] | tuple = (),
    jacobian: str = "auto",
) -> Callable:
    """A ``gibbs_sweep``-compatible move from an involutive kernel."""

    def move(key: PRNGKey, trace: Trace) -> Trace:
        new_trace, _ = involutive_mh(
            key,
            trace,
            aux_model,
            involution,
            aux_args=aux_args,
            jacobian=jacobian,
        )
        return new_trace

    return move
