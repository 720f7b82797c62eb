"""Staging utilities and concrete/traced flag algebra.

Parity with reference ``/root/reference/src/genjax/_src/core/compiler/staging.py``
(347 LoC): ``stage`` :286 (cached Jaxpr staging), ``FlagOp`` :55,
``tree_choose`` :187, ``multi_switch`` :221, ``to_shape_fn`` :301,
``empty_trace``/zero-fill :332.

Design notes: ``FlagOp`` short-circuits on concrete Python bools so that
``lax.cond`` never compiles a dead branch; ``tree_choose`` lowers to
``lax.select_n`` (a single fused select, no gather); ``multi_switch``
handles branches with *different* output treedefs by zero-padding to the union
so ``lax.switch`` sees one static shape.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.extend.core import ClosedJaxpr

from .typing_ import Flag, static_check_is_concrete


# ------------------------------------------------------------------
# Jaxpr staging
# ------------------------------------------------------------------


def stage(fn: Callable, **make_jaxpr_kwargs):
    """Stage ``fn`` to a ClosedJaxpr. Returns a callable
    ``(*args) -> (ClosedJaxpr, (flat_args, in_tree, out_tree))``.
    """

    def wrapped(*args):
        closed_jaxpr, out_shape = jax.make_jaxpr(fn, return_shape=True, **make_jaxpr_kwargs)(
            *args
        )
        flat_args, in_tree = jtu.tree_flatten(args)
        out_tree = jtu.tree_structure(out_shape)
        return closed_jaxpr, (flat_args, in_tree, out_tree)

    return wrapped


@functools.lru_cache(maxsize=256)
def _cached_jaxpr(fn, in_tree, avals):
    def flat_fn(*flat):
        args = jtu.tree_unflatten(in_tree, flat)
        return fn(*args)

    closed_jaxpr, out_shape = jax.make_jaxpr(flat_fn, return_shape=True)(
        *[jax.ShapeDtypeStruct(a.shape, a.dtype) for a in avals]
    )
    return closed_jaxpr, jtu.tree_structure(out_shape)


def cached_stage_dynamic(fn: Callable, *args) -> tuple[ClosedJaxpr, Any, Any]:
    """Stage with a cache keyed on (fn, argument treedef, avals).

    Returns ``(closed_jaxpr, flat_args, out_tree)``.
    Parity: reference ``cached_stage_dynamic`` (staging.py:266).
    """
    flat_args, in_tree = jtu.tree_flatten(args)
    avals = tuple(jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)) for a in flat_args)
    closed_jaxpr, out_tree = _cached_jaxpr(fn, in_tree, avals)
    return closed_jaxpr, flat_args, out_tree


def to_shape_fn(callable_: Callable, fill: Callable | None = None) -> Callable:
    """Evaluate ``callable_`` at zero FLOPs, returning its output shape pytree.

    With ``fill`` (e.g. ``jnp.zeros``) the ShapeDtypeStructs are materialized.
    Parity: reference ``to_shape_fn`` (staging.py:301).
    """

    def wrapped(*args, **kwargs):
        shape = jax.eval_shape(callable_, *args, **kwargs)
        if fill is not None:
            return jtu.tree_map(lambda s: fill(s.shape, s.dtype), shape)
        return shape

    return wrapped


_KEY_STRUCT = None


def _abstract_key():
    # eval_shape only needs the key's aval; building a real jax.random.key
    # would issue an eager device computation per call
    global _KEY_STRUCT
    if _KEY_STRUCT is None:
        _KEY_STRUCT = jax.eval_shape(lambda: jax.random.key(0))
    return _KEY_STRUCT


def empty_trace(gen_fn, args) -> Any:
    """A zero-filled fake trace with the right shapes (staging.py:332).

    Runs ``simulate`` under ``eval_shape`` with an abstract key — zero
    FLOPs, zero device dispatch.
    """
    return to_shape_fn(gen_fn.simulate, jnp.zeros)(_abstract_key(), args)


# ------------------------------------------------------------------
# Flag algebra
# ------------------------------------------------------------------


class FlagOp:
    """Boolean algebra over values that may be concrete Python bools or traced
    arrays. Concrete cases short-circuit so dead branches are never compiled.

    Parity: reference ``FlagOp`` (staging.py:55-186).
    """

    @staticmethod
    def is_concrete(f: Flag) -> bool:
        import numpy as np

        return isinstance(f, (bool, np.bool_))

    @staticmethod
    def concrete_true(f: Flag) -> bool:
        return FlagOp.is_concrete(f) and bool(f)

    @staticmethod
    def concrete_false(f: Flag) -> bool:
        return FlagOp.is_concrete(f) and not bool(f)

    @staticmethod
    def and_(f: Flag, g: Flag) -> Flag:
        if FlagOp.concrete_false(f) or FlagOp.concrete_false(g):
            return False
        if FlagOp.concrete_true(f) and FlagOp.concrete_true(g):
            return True
        if FlagOp.concrete_true(f):
            return g
        if FlagOp.concrete_true(g):
            return f
        return jnp.logical_and(f, g)

    @staticmethod
    def or_(f: Flag, g: Flag) -> Flag:
        if FlagOp.concrete_true(f) or FlagOp.concrete_true(g):
            return True
        if FlagOp.concrete_false(f) and FlagOp.concrete_false(g):
            return False
        if FlagOp.concrete_false(f):
            return g
        if FlagOp.concrete_false(g):
            return f
        return jnp.logical_or(f, g)

    @staticmethod
    def xor_(f: Flag, g: Flag) -> Flag:
        if FlagOp.is_concrete(f) and FlagOp.is_concrete(g):
            return bool(f) != bool(g)
        return jnp.logical_xor(f, g)

    @staticmethod
    def not_(f: Flag) -> Flag:
        if FlagOp.is_concrete(f):
            return not bool(f)
        return jnp.logical_not(f)

    @staticmethod
    def where(f: Flag, tv, fv):
        """``f ? tv : fv`` with concrete short-circuiting (staging.py:164)."""
        if FlagOp.concrete_true(f):
            return tv
        if FlagOp.concrete_false(f):
            return fv
        return jnp.where(f, tv, fv)

    @staticmethod
    def cond(f: Flag, tf: Callable, ff: Callable, *args):
        """``lax.cond`` that avoids compiling the dead branch when ``f`` is
        concrete (staging.py:174)."""
        if FlagOp.concrete_true(f):
            return tf(*args)
        if FlagOp.concrete_false(f):
            return ff(*args)
        return lax.cond(f, tf, ff, *args)


def get_shaped_aval(x):
    """The shaped abstract value of ``x`` (reference staging.py parity)."""
    return jax.api_util.shaped_abstractify(x)


def staged_check(v: Flag) -> bool:
    """True only for a concretely-true flag (staging.py:183)."""
    return FlagOp.concrete_true(v)


def staged_choose(idx, vs: Sequence[Any]):
    """Select ``vs[idx]`` for scalar values; concrete idx short-circuits."""
    if static_check_is_concrete(idx) and isinstance(idx, (int,)):
        return vs[idx]
    arrs = [jnp.asarray(v) for v in vs]
    dtype = jnp.result_type(*arrs)
    arrs = [a.astype(dtype) for a in arrs]
    idx_clamped = jnp.clip(jnp.asarray(idx), 0, len(arrs) - 1)
    return lax.select_n(idx_clamped, *arrs)


def tree_choose(idx, trees: Sequence[Any]):
    """Pytree-level select-by-index over structurally matching trees.

    Concrete ``idx`` returns ``trees[idx]`` with no device work; traced ``idx``
    lowers to one ``lax.select_n`` per leaf (fused — no gather,
    no branching). Parity: reference ``tree_choose`` (staging.py:187).
    """
    if static_check_is_concrete(idx) and isinstance(idx, int):
        return trees[idx]
    return jtu.tree_map(lambda *leaves: staged_choose(idx, leaves), *trees)


def multi_switch(idx, fns: Sequence[Callable], operands: Sequence[tuple]):
    """``lax.switch`` over branches with *different* output pytree shapes.

    Each branch's output is zero-padded into a tuple holding every branch's
    output slots; only the selected branch's slot carries real data. Returns
    the list of per-branch outputs. Parity: reference ``multi_switch``
    (staging.py:221-254).
    """
    shapes = [
        jax.eval_shape(fn, *ops) for fn, ops in zip(fns, operands)
    ]

    def make_branch(i, fn):
        def branch(ops_tuple):
            result = fn(*ops_tuple[i])
            out = [
                jtu.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shp)
                for shp in shapes
            ]
            out[i] = result
            return tuple(out)

        return branch

    branches = [make_branch(i, fn) for i, fn in enumerate(fns)]
    if static_check_is_concrete(idx) and isinstance(idx, int):
        return list(branches[idx](tuple(operands)))
    return list(lax.switch(idx, branches, tuple(operands)))
