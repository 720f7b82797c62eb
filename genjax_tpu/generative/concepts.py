"""GFI value concepts and edit-request base classes.

Parity: reference ``/root/reference/src/genjax/_src/core/generative/
concepts.py`` — ``Weight`` :48, ``Score`` :54, ``Arguments`` :61, ``Argdiffs``
:66, ``Retdiff`` :77, ``EditRequest.edit`` :95-109, ``PrimitiveEditRequest``
:135, ``IndexRequest`` :154, ``NotSupportedEditRequest`` :167; plus the extra
requests from ``requests.py`` — ``EmptyRequest`` :49, ``Regenerate`` :64,
``DiffAnnotate`` :70 — and ``Update`` from ``generative_function.py`` :1688.

Weights follow SMCP3 semantics: for an edit moving ``(x, args)`` to
``(x', args')`` the returned weight is
``log [ P(x'; args') q(x; bwd) / P(x; args) q(x'; fwd) ]`` so that importance
weights of particle collections remain properly calibrated under edits.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any, Callable

from ..core.diff import Argdiffs, Diff, Retdiff
from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from ..core.typing_ import FloatArray, PRNGKey

if TYPE_CHECKING:
    from .trace import Trace

# ----- value aliases (concepts.py:48-88) -----

Weight = FloatArray
Score = FloatArray
Arguments = tuple
Retval = Any

__all__ = [
    "Arguments",
    "Argdiffs",
    "DiffAnnotate",
    "EditRequest",
    "EmptyRequest",
    "IndexRequest",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "Retdiff",
    "Retval",
    "Score",
    "Update",
    "VectorRequest",
    "Weight",
]


class NotSupportedEditRequest(GenJAXError):
    """Raised when a generative function cannot serve an edit request."""


class EditRequest(Pytree):
    """A request to transform a trace into a new trace, with SMCP3 weight
    accounting. ``edit`` returns ``(new_trace, weight, retdiff, bwd_request)``
    where applying ``bwd_request`` to ``new_trace`` recovers the original."""

    @abc.abstractmethod
    def edit(
        self,
        key: PRNGKey,
        tr: "Trace",
        argdiffs: Argdiffs,
    ) -> tuple["Trace", Weight, Retdiff, "EditRequest"]:
        ...

    def dimap(
        self,
        argdiff_fn: Callable = lambda d: d,
        retdiff_fn: Callable = lambda d: d,
    ) -> "DiffAnnotate":
        return DiffAnnotate(self, argdiff_fn, retdiff_fn)

    def map(self, retdiff_fn: Callable) -> "DiffAnnotate":
        return DiffAnnotate(self, lambda d: d, retdiff_fn)

    def contramap(self, argdiff_fn: Callable) -> "DiffAnnotate":
        return DiffAnnotate(self, argdiff_fn, lambda d: d)


class PrimitiveEditRequest(EditRequest):
    """An edit request whose semantics are implemented by the generative
    function itself: defers to ``gen_fn.edit`` (concepts.py:135-152)."""

    def edit(self, key, tr, argdiffs):
        gen_fn = tr.get_gen_fn()
        return gen_fn.edit(key, tr, self, argdiffs)


def _leaf_same(a, b) -> bool:
    """Can these two pytree leaves be proven identical without tracing?
    (Concrete device arrays are NOT value-compared: that would force a
    device readback per edit; under jit the
    shared-tracer identity check covers the unchanged case.)"""
    if a is b:
        return True
    import numpy as np

    if isinstance(a, (int, float, bool, str)) and isinstance(
        b, (int, float, bool, str)
    ):
        return a == b
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return False


def source_changed_flags(new_source, old_source) -> list:
    """Per-leaf changed flags between a callee's current closure and the
    one recorded in the previous trace (conservative: unprovable ⇒
    changed)."""
    import jax.tree_util as jtu

    new_leaves = jtu.tree_leaves(new_source)
    old_leaves = jtu.tree_leaves(old_source)
    if len(new_leaves) != len(old_leaves):
        return [True] * len(new_leaves)
    return [not _leaf_same(a, b) for a, b in zip(new_leaves, old_leaves)]


def merge_gen_fn(old_gf, new_gf):
    """The CURRENT callee's dynamic leaves in the PREVIOUS trace's static
    structure. A body that defines a local ``@gen`` function creates a
    fresh function object (a static treedef field) on every execution;
    recording it verbatim would make the edited trace's treedef differ
    from the original's, breaking old-vs-new ``tree_map`` (MH
    accept/reject, SMC resampling). Keeping the old treedef with the new
    dynamic leaves preserves both the fresh closure VALUES and treedef
    stability. Falls back to ``old_gf`` when the structures are
    incompatible (pre-existing behavior)."""
    import jax.tree_util as jtu

    new_leaves, new_td = jtu.tree_flatten(new_gf)
    old_td = jtu.tree_structure(old_gf)
    if new_td == old_td:
        return new_gf
    if old_td.num_leaves == len(new_leaves):
        try:
            return jtu.tree_unflatten(old_td, new_leaves)
        except Exception:
            return old_gf
    return old_gf


def python_closure_mismatch(old, new, depth: int = 0) -> bool:
    """Do ``old`` and ``new`` differ in values reachable only through
    PYTHON closures (``fn.__closure__`` cells) — invisible to the pytree
    system? Distinct function objects with captures cannot be proven
    equal (each execution of a body that defines a local ``@gen`` creates
    a fresh function whose cells hold the current upstream samples), so
    the walk conservatively reports a mismatch for them."""
    import dataclasses
    import types

    if depth > 8 or old is new:
        return False
    if isinstance(old, types.FunctionType) and isinstance(
        new, types.FunctionType
    ):
        oc = old.__closure__ or ()
        nc = new.__closure__ or ()
        if len(oc) != len(nc):
            return True
        return len(nc) > 0
    if type(old) is not type(new):
        return True
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return any(
            python_closure_mismatch(
                getattr(old, f.name, None), getattr(new, f.name, None),
                depth + 1,
            )
            for f in dataclasses.fields(new)
        )
    if isinstance(new, (tuple, list)):
        if len(old) != len(new):
            return True
        return any(
            python_closure_mismatch(a, b, depth + 1)
            for a, b in zip(old, new)
        )
    return False


def dispatch_edit(gen_fn, key, tr, request: "EditRequest", argdiffs):
    """Run ``request`` on ``tr``, scoring under the CURRENT ``gen_fn``.

    Combinators and the static language route sub-edits through this so a
    callee whose dynamic closure leaves changed (e.g. a re-``partial_apply``-ed
    kernel) scores under the new values — the trace's recorded gen_fn is
    stale in that case. The callee is structurally merged with the
    trace's (see ``merge_gen_fn``) so per-execution local function
    objects don't destabilize trace treedefs; when the callee reaches
    values through PYTHON closures (a local ``@gen`` capturing upstream
    samples), the new callee must score the edit verbatim — the result's
    recorded gen_fn is then rebound to the old structure to keep treedefs
    stable (its closure snapshot is stale, but every future edit again
    receives the fresh callee through this dispatcher)."""
    old_gf = tr.get_gen_fn()
    merged = merge_gen_fn(old_gf, gen_fn)
    capture_mismatch = python_closure_mismatch(old_gf, gen_fn)
    scored_gf = gen_fn if capture_mismatch else merged
    if isinstance(request, EmptyRequest):
        # preserve EmptyRequest's no-op shortcut, but treat a changed
        # callee closure like changed argdiffs: fall through to an empty
        # Update so the stale-closure comparison reaches the callee's
        # edit (rebinding the trace would hide it)
        if (
            Diff.static_check_no_change(argdiffs)
            and not capture_mismatch
            and not any(source_changed_flags(scored_gf, old_gf))
        ):
            retdiff = Diff.tree_diff_no_change(tr.get_retval())
            return tr, 0.0, retdiff, EmptyRequest()
        from .choice_map import ChoiceMap

        request = Update(ChoiceMap.empty())
    if isinstance(request, PrimitiveEditRequest):
        out = scored_gf.edit(key, tr, request, argdiffs)
    else:
        out = request.edit(key, tr.with_gen_fn(scored_gf), argdiffs)
    if capture_mismatch:
        new_tr, w, rd, bwd = out
        out = (new_tr.with_gen_fn(merge_gen_fn(old_gf, gen_fn)), w, rd, bwd)
    return out


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Constraint-driven edit: overwrite addressed choices with the values in
    ``constraint`` (generative_function.py:1688)."""

    constraint: Any  # ChoiceMap


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected addresses from their priors (requests.py:64)."""

    selection: Any  # Selection


@Pytree.dataclass
class IndexRequest(PrimitiveEditRequest):
    """Apply a sub-request at a dynamic index of a ``Scan``/``Vmap`` trace —
    the O(1) single-slice edit (concepts.py:154)."""

    index: Any
    request: EditRequest


@Pytree.dataclass
class VectorRequest(PrimitiveEditRequest):
    """Per-lane (vmap) / per-step (scan) edit requests: one request pytree
    whose array leaves carry the batch/time axis in front; slice ``t`` is
    the request for lane/step ``t`` (reference scan.py:100). This is how
    combinator edits return *lossless* backward requests when the kernel's
    backward move is not a plain Update (e.g. a @gen kernel's Regenerate
    produces per-address ``StaticRequest``s)."""

    request: EditRequest


@Pytree.dataclass
class EmptyRequest(EditRequest):
    """No-op unless argdiffs changed, in which case it falls back to an empty
    Update (requests.py:49)."""

    def edit(self, key, tr, argdiffs):
        if Diff.static_check_no_change(argdiffs):
            retdiff = Diff.tree_diff_no_change(tr.get_retval())
            return tr, 0.0, retdiff, EmptyRequest()
        from .choice_map import ChoiceMap

        return Update(ChoiceMap.empty()).edit(key, tr, argdiffs)


@Pytree.dataclass
class DiffAnnotate(EditRequest):
    """Unsafe coercion of argdiff/retdiff annotations around an inner request
    (requests.py:70). The caller asserts the coercions are sound."""

    request: EditRequest
    argdiff_fn: Callable = Pytree.static(default=lambda d: d)
    retdiff_fn: Callable = Pytree.static(default=lambda d: d)

    def edit(self, key, tr, argdiffs):
        new_argdiffs = self.argdiff_fn(argdiffs)
        new_tr, w, retdiff, bwd = self.request.edit(key, tr, new_argdiffs)
        return new_tr, w, self.retdiff_fn(retdiff), bwd
