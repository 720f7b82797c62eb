"""Change tangents (``Diff``) for incremental computation.

Parity: reference ``/root/reference/src/genjax/_src/core/compiler/interpreters/
incremental.py`` — ``ChangeTangent`` :57, ``Diff`` :89, ``NoChange``/
``UnknownChange``, and the propagation rule :300.

Design: instead of a Jaxpr-level forward interpreter, diffs are
propagated *structurally* at Python trace time. Under ``jit`` this is free —
the payoff of ``NoChange`` is that edit handlers can skip re-binding whole
sub-programs (e.g. ``Scan``'s O(1) index edit), which is where the real
asymptotic wins live on accelerators.
"""

from __future__ import annotations

from typing import Any

import jax.tree_util as jtu

from .pytree import Pytree


class _ChangeTangent:
    _instances: dict[str, "_ChangeTangent"] = {}

    def __new__(cls, name: str):
        if name not in cls._instances:
            inst = super().__new__(cls)
            inst.name = name
            cls._instances[name] = inst
        return cls._instances[name]

    def __repr__(self):
        return self.name


NoChange = _ChangeTangent("NoChange")
UnknownChange = _ChangeTangent("UnknownChange")


@Pytree.dataclass
class Diff(Pytree):
    """A primal value paired with a change tangent."""

    primal: Any
    tangent: _ChangeTangent = Pytree.static(default=UnknownChange)

    # ----- constructors -----

    @staticmethod
    def unknown_change(v: Any) -> "Diff":
        v = Diff.tree_primal(v)
        return Diff(v, UnknownChange)

    @staticmethod
    def no_change(v: Any) -> "Diff":
        v = Diff.tree_primal(v)
        return Diff(v, NoChange)

    # ----- predicates -----

    @staticmethod
    def static_check_tree_diff(v: Any) -> bool:
        """True if every leaf-level node of ``v`` is a Diff."""
        leaves = jtu.tree_leaves(v, is_leaf=lambda x: isinstance(x, Diff))
        return all(isinstance(l, Diff) for l in leaves) and len(leaves) > 0

    @staticmethod
    def static_check_no_change(v: Any) -> bool:
        """True if every Diff in ``v`` carries NoChange."""

        def check(x):
            if isinstance(x, Diff):
                return x.tangent is NoChange
            return True

        leaves = jtu.tree_leaves(v, is_leaf=lambda x: isinstance(x, Diff))
        return all(check(l) for l in leaves)

    # ----- tree ops -----

    @staticmethod
    def tree_primal(v: Any) -> Any:
        """Strip all Diff wrappers, leaving primal values."""

        def _unwrap(x):
            return x.primal if isinstance(x, Diff) else x

        return jtu.tree_map(_unwrap, v, is_leaf=lambda x: isinstance(x, Diff))

    @staticmethod
    def tree_tangent(v: Any) -> Any:
        def _t(x):
            return x.tangent if isinstance(x, Diff) else NoChange

        return jtu.tree_map(_t, v, is_leaf=lambda x: isinstance(x, Diff))

    @staticmethod
    def tree_diff(tree: Any, tangent_tree: Any) -> Any:
        return jtu.tree_map(lambda p, t: Diff(p, t), tree, tangent_tree)

    @staticmethod
    def tree_diff_unknown_change(tree: Any) -> Any:
        tree = Diff.tree_primal(tree)
        return jtu.tree_map(lambda p: Diff(p, UnknownChange), tree)

    @staticmethod
    def tree_diff_no_change(tree: Any) -> Any:
        tree = Diff.tree_primal(tree)
        return jtu.tree_map(lambda p: Diff(p, NoChange), tree)


def flat_changed(diff_tree, treedef=None) -> list[bool]:
    """Per-primal-leaf changed flags of a Diff-annotated tree.

    Handles both per-leaf Diffs and a single Diff wrapping a subtree (each
    primal leaf under it inherits the wrapper's tangent). Unannotated leaves
    are conservatively ``changed``.
    """
    out: list[bool] = []

    def walk(x):
        if isinstance(x, Diff):
            n = len(jtu.tree_leaves(x.primal))
            out.extend([x.tangent is not NoChange] * n)
        else:
            kids = jtu.tree_leaves(x, is_leaf=lambda y: isinstance(y, Diff))
            if any(isinstance(k, Diff) for k in kids):
                for k in kids:
                    walk(k)
            else:
                out.extend([True] * len(kids))

    walk(diff_tree)
    return out


def has_hidden_static_change(diff_tree) -> bool:
    """True when a changed tangent has NO dynamic leaf to carry it: a
    ``Diff`` whose primal flattens to zero leaves (a changed ``Const`` or
    static-only pytree). Per-leaf flag lists (``flat_changed``) cannot
    represent such a change — consumers must degrade to a full
    re-evaluation when this reports True."""
    found = False

    def walk(x):
        nonlocal found
        if isinstance(x, Diff):
            if x.tangent is not NoChange and not jtu.tree_leaves(x.primal):
                found = True
        else:
            for k in jtu.tree_leaves(x, is_leaf=lambda y: isinstance(y, Diff)):
                if isinstance(k, Diff):
                    walk(k)

    walk(diff_tree)
    return found


def changed_through(fn, diff_args):
    """Propagate per-leaf change tangents through a PURE function.

    Stages ``fn(*primal_args)`` and marks an output leaf changed iff it
    transitively depends on a changed input leaf — the Jaxpr-level analog
    of the reference incremental interpreter's propagation rule
    (incremental.py:300) for the deterministic pre/post mappings of
    ``Dimap``. Returns the Diff-annotated output, or ``None`` when the
    function cannot be staged abstractly (concrete-control-flow bodies) —
    callers then fall back to all-``UnknownChange``.
    """
    import jax
    from jax.extend.core import Literal

    if has_hidden_static_change(diff_args):
        # a changed Const / zero-leaf pytree: the per-leaf flags below
        # cannot carry it — degrade (caller goes all-UnknownChange)
        return None
    args = Diff.tree_primal(diff_args)
    changed_in = flat_changed(diff_args)
    flat, in_tree = jtu.tree_flatten(args)
    if len(changed_in) != len(flat):
        return None

    def flat_fn(*leaves):
        return fn(*jtu.tree_unflatten(in_tree, leaves))

    try:
        closed, out_shape = jax.make_jaxpr(flat_fn, return_shape=True)(*flat)
        out = flat_fn(*flat)
    except Exception:
        return None
    jaxpr = closed.jaxpr
    chg: dict = {}
    for v in jaxpr.constvars:
        chg[v] = False
    for v, c in zip(jaxpr.invars, changed_in):
        chg[v] = bool(c)

    def read(v) -> bool:
        return False if isinstance(v, Literal) else chg.get(v, True)

    for eqn in jaxpr.eqns:
        c = any(read(v) for v in eqn.invars)
        for ov in eqn.outvars:
            chg[ov] = c
    out_changed = [read(v) for v in jaxpr.outvars]
    out_leaves, out_tree = jtu.tree_flatten(out)
    if len(out_changed) != len(out_leaves):
        return None
    return jtu.tree_unflatten(
        out_tree,
        [
            Diff(p, UnknownChange if c else NoChange)
            for p, c in zip(out_leaves, out_changed)
        ],
    )


# Short aliases used throughout combinator edit code.
def tree_diff_primal(v: Any) -> Any:
    return Diff.tree_primal(v)


def tree_diff_no_change(v: Any) -> Any:
    return Diff.tree_diff_no_change(v)


def tree_diff_unknown_change(v: Any) -> Any:
    return Diff.tree_diff_unknown_change(v)


Argdiffs = Any  # tuple of Diff-annotated arguments
Retdiff = Any  # Diff-annotated return value
