"""``Mask``: a validity-flagged value — the fixed-shape sum type of the
framework.

Parity: reference ``/root/reference/src/genjax/_src/core/generative/
functional_types.py`` (``Mask`` :43, ``build``/``maybe_mask`` :145-187,
``unmask`` :233-260, ``__or__/__xor__/__invert__`` :283-342; flag-shape
prefix rule :79-107).

Under jit, sum types must be encoded as data: a ``Mask`` is a value plus a
boolean validity flag. Flags may be scalar or vectorized — a vectorized flag's
shape must be a prefix of every leaf's shape so that a batch of particles can
carry per-particle validity.
"""

from __future__ import annotations

from typing import Any, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu

from ..core.pytree import Pytree
from ..core.staging import FlagOp
from ..core.typing_ import Flag

R = TypeVar("R")


def _check_flag_prefix(value: Any, flag: Flag) -> None:
    if FlagOp.is_concrete(flag):
        return
    if not isinstance(flag, jnp.ndarray) and not hasattr(flag, "aval"):
        # non-array flag carrier (e.g. a Diff-annotated flag in retdiffs)
        return
    fshape = jnp.shape(flag)
    if fshape == ():
        return
    for leaf in jtu.tree_leaves(value):
        lshape = jnp.shape(leaf)
        if lshape[: len(fshape)] != fshape:
            raise ValueError(
                f"Mask flag shape {fshape} must be a prefix of every leaf "
                f"shape; got leaf shape {lshape}."
            )


@Pytree.dataclass(init=False)
class Mask(Pytree):
    """Existence uncertainty as data: a value plus a validity flag, so
    optional structure stays fixed-shape under ``jit``.

    >>> import genjax_tpu as g
    >>> m = g.Mask(1.5, True)
    >>> float(m.unmask()), bool(m.flag)
    (1.5, True)
    >>> float(g.Mask(2.5, False).unmask(default=0.0))   # invalid -> default
    0.0
    """

    value: Any
    flag: Flag

    def __init__(self, value: Any, flag: Flag = True):
        if isinstance(value, Mask):
            flag = FlagOp.and_(flag, value.flag)
            value = value.value
        _check_flag_prefix(value, flag)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "flag", flag)

    # ----- constructors -----

    @staticmethod
    def build(v: Any, flag: Flag = True) -> "Mask":
        return Mask(v, flag)

    @staticmethod
    def maybe_mask(v: Any, flag: Flag):
        """Statically simplify: concrete-True → the value unchanged (an
        inner Mask keeps its own flag — unwrapping would discard dynamic
        validity), concrete-False → None, else a Mask whose flag ANDs with
        any inner flag (reference functional_types.py:168-187)."""
        if v is None:
            return None
        if FlagOp.concrete_true(flag):
            return v
        if FlagOp.concrete_false(flag):
            return None
        return Mask(v, flag)

    @staticmethod
    def maybe_none(v: Any):
        """Collapse a concretely-invalid Mask to None; unwrap a concretely
        valid one."""
        if v is None:
            return None
        if isinstance(v, Mask):
            if FlagOp.concrete_true(v.flag):
                return v.value
            if FlagOp.concrete_false(v.flag):
                return None
        return v

    # ----- queries -----

    def primal_flag(self) -> Flag:
        return self.flag

    def unmask(self, default: Any = None) -> Any:
        """Return the value. If ``default`` is given, invalid lanes are
        replaced by it; otherwise an (optional, checkify-gated) validity
        assertion fires. See ``genjax_tpu.checkify``."""
        if default is None:
            from ..checkify import optional_check

            def check():
                import jax.experimental.checkify as cf

                cf.check(
                    jnp.all(jnp.asarray(self.flag)),
                    "Attempted to unmask an invalid Mask.",
                )

            optional_check(check)
            return self.value

        def merge(v, d):
            flag = jnp.asarray(self.flag)
            fshape = flag.shape
            v = jnp.asarray(v)
            if fshape != () and fshape != v.shape:
                extra = v.ndim - flag.ndim
                flag = flag.reshape(fshape + (1,) * extra)
            return jnp.where(flag, v, d)

        return jtu.tree_map(merge, self.value, default)

    # ----- combination (index-select truth tables; functional_types.py:283) --

    def __or__(self, other: "Mask") -> "Mask":
        # valid(self) ? self : (valid(other) ? other : invalid)
        f1, f2 = self.flag, other.flag
        newflag = FlagOp.or_(f1, f2)
        idx = _flag_to_idx2(f1, f2, mode="or")
        value = _choose_value(idx, self.value, other.value)
        return Mask(value, newflag)

    def __xor__(self, other: "Mask") -> "Mask":
        f1, f2 = self.flag, other.flag
        newflag = FlagOp.xor_(f1, f2)
        idx = _flag_to_idx2(f1, f2, mode="xor")
        value = _choose_value(idx, self.value, other.value)
        return Mask(value, newflag)

    def __invert__(self) -> "Mask":
        return Mask(self.value, FlagOp.not_(self.flag))


def _flag_to_idx2(f1: Flag, f2: Flag, mode: str):
    """Index of the value to take: 0 → first, 1 → second."""
    if FlagOp.is_concrete(f1) and FlagOp.is_concrete(f2):
        if mode == "or":
            return 0 if f1 else 1
        # xor: valid result only when exactly one valid
        return 0 if f1 else 1
    a1 = jnp.asarray(f1)
    a2 = jnp.asarray(f2)
    if mode == "or":
        return jnp.where(a1, 0, 1)
    return jnp.where(a1 & ~a2, 0, jnp.where(a2 & ~a1, 1, 0))


def _choose_value(idx, v1, v2):
    if isinstance(idx, int):
        return (v1, v2)[idx]

    def per_leaf(l1, l2):
        l1 = jnp.asarray(l1)
        i = idx
        if i.shape != () and i.shape != l1.shape:
            extra = l1.ndim - i.ndim
            i = i.reshape(i.shape + (1,) * extra)
        return jnp.where(i == 0, l1, jnp.asarray(l2))

    return jtu.tree_map(per_leaf, v1, v2)
