"""``Selection``: an algebra of address predicates.

Parity: reference ``/root/reference/src/genjax/_src/core/generative/
choice_map.py`` selection half — ``Selection`` :124, builders ``all/none/leaf``
:203-255, combinators ``|,&,~`` :261-271, ``extend`` :298, node types
``AllSel`` :364, ``NoneSel`` :386, ``LeafSel`` :409, ``ComplementSel`` :432,
``StaticSel`` :478 (with ``...`` wildcard :516), ``AndSel`` :526, ``OrSel``
:576, ``ChmSel`` :628, builder ``Selection.at`` :188.

A selection answers two questions at a node of the address tree:
``check()`` — is a choice *here* selected (a ``Flag``, possibly traced) — and
``s(addr)`` — the subselection under ``addr``. Dynamic integer addresses are
supported by returning flag-masked subselections, which keeps the whole
algebra vmap/shard-friendly (pure selects, no data-dependent structure).
"""

from __future__ import annotations

import abc
from typing import Any

import jax.numpy as jnp

from ..core.pytree import Pytree
from ..core.staging import FlagOp
from ..core.typing_ import Flag


class Selection(Pytree):
    """A predicate over addresses — what to regenerate, project, or
    filter. Build with ``S``; combine with ``|``/``&``/``~``; test
    membership with ``in``:

    >>> import genjax_tpu as g
    >>> sel = g.S["x"] | g.S["y", "z"]
    >>> ("x",) in sel, ("y", "z") in sel, ("y",) in sel
    (True, True, False)
    >>> ("x",) in ~sel, ("other",) in ~sel
    (False, True)
    """

    # ----- interface -----

    @abc.abstractmethod
    def check(self) -> Flag:
        """Is the address *ending here* selected?"""

    @abc.abstractmethod
    def get_subselection(self, addr) -> "Selection":
        ...

    # ----- builders -----

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    # ----- combinators -----

    def __or__(self, other: "Selection") -> "Selection":
        if isinstance(self, AllSel) or isinstance(other, AllSel):
            return AllSel()
        if isinstance(self, NoneSel):
            return other
        if isinstance(other, NoneSel):
            return self
        return OrSel(self, other)

    def __and__(self, other: "Selection") -> "Selection":
        if isinstance(self, NoneSel) or isinstance(other, NoneSel):
            return NoneSel()
        if isinstance(self, AllSel):
            return other
        if isinstance(other, AllSel):
            return self
        return AndSel(self, other)

    def __invert__(self) -> "Selection":
        if isinstance(self, AllSel):
            return NoneSel()
        if isinstance(self, NoneSel):
            return AllSel()
        return ComplementSel(self)

    def complement(self) -> "Selection":
        return ~self

    def mask(self, flag: Flag) -> "Selection":
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return NoneSel()
        return MaskedSel(self, flag)

    def extend(self, *addrs) -> "Selection":
        """Prefix this selection with address components (outermost first).
        Traced/array integer components route to ``IdxSel`` (a dynamic
        value must not land in ``StaticSel``'s static treedef — same
        dispatch as the ``S[...]`` builder)."""
        sel = self
        for addr in reversed(addrs):
            if _is_dynamic_int(addr):
                sel = IdxSel(sel, jnp.atleast_1d(jnp.asarray(addr)))
            else:
                sel = StaticSel(sel, addr)
        return sel

    # ----- sugar -----

    def __call__(self, *addr) -> "Selection":
        sel = self
        for comp in addr:
            sel = sel.get_subselection(comp)
        return sel

    def __getitem__(self, addr) -> Flag:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return self(*addr).check()

    def __contains__(self, addr) -> bool:
        import jax

        flag = self[addr]
        try:
            return bool(flag)
        except (
            jax.errors.TracerBoolConversionError,
            jax.errors.ConcretizationTypeError,
        ) as e:
            from ..core.handlers import GenJAXError

            raise GenJAXError(
                "`addr in selection` requires a concrete membership flag; "
                "this selection's check is traced (dynamic index or mask)."
                " Use `selection[addr]` to keep the traced Flag."
            ) from e


@Pytree.dataclass
class AllSel(Selection):
    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class NoneSel(Selection):
    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    """Selects exactly the choice at the current node."""

    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return NoneSel()


@Pytree.dataclass
class ComplementSel(Selection):
    inner: Selection

    def check(self) -> Flag:
        return FlagOp.not_(self.inner.check())

    def get_subselection(self, addr) -> Selection:
        return ~self.inner.get_subselection(addr)


@Pytree.dataclass
class MaskedSel(Selection):
    inner: Selection
    flag: Flag

    def check(self) -> Flag:
        return FlagOp.and_(self.flag, self.inner.check())

    def get_subselection(self, addr) -> Selection:
        return self.inner.get_subselection(addr).mask(self.flag)


def _addr_match(key, addr) -> Flag:
    """Compare an address component against a selection key. Supports the
    ``...`` wildcard and traced integer addresses."""
    if key is Ellipsis:
        return True
    kc = not isinstance(key, jnp.ndarray) and not hasattr(key, "aval")
    ac = not isinstance(addr, jnp.ndarray) and not hasattr(addr, "aval")
    if kc and ac:
        return key == addr
    if isinstance(key, str) or isinstance(addr, str):
        return False
    return jnp.asarray(key) == jnp.asarray(addr)


@Pytree.dataclass
class StaticSel(Selection):
    """Selects addresses under a single component (str, int, array, or
    ``...`` wildcard)."""

    inner: Selection
    addr: Any = Pytree.static()

    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        flag = _addr_match(self.addr, addr)
        return self.inner.mask(flag)


@Pytree.dataclass
class IdxSel(Selection):
    """Selects dynamic integer addresses from an index array."""

    inner: Selection
    idx: Any  # int array, dynamic

    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        if isinstance(addr, str) or addr is None:
            return NoneSel()
        flag = jnp.any(jnp.asarray(self.idx) == jnp.asarray(addr))
        return self.inner.mask(flag)


@Pytree.dataclass
class AndSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return FlagOp.and_(self.a.check(), self.b.check())

    def get_subselection(self, addr) -> Selection:
        return self.a.get_subselection(addr) & self.b.get_subselection(addr)


@Pytree.dataclass
class OrSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return FlagOp.or_(self.a.check(), self.b.check())

    def get_subselection(self, addr) -> Selection:
        return self.a.get_subselection(addr) | self.b.get_subselection(addr)


@Pytree.dataclass
class ChmSel(Selection):
    """Selection of every address holding a value in a choice map
    (reference ChmSel, choice_map.py:628)."""

    chm: Any  # ChoiceMap, typed loosely to avoid circular import

    def check(self) -> Flag:
        v = self.chm.get_value()
        if v is None:
            return False
        from .mask import Mask

        if isinstance(v, Mask):
            return v.primal_flag()
        return True

    def get_subselection(self, addr) -> Selection:
        sub = self.chm.get_submap(addr)
        if sub.static_is_empty():
            return NoneSel()
        return ChmSel(sub)


class _SelectionBuilder:
    """``S["x", "y"]`` → selection of the subtree at path x/y;
    ``S[...]`` wildcard; ``S.all()``, ``S.none()``, ``S.leaf()``."""

    def __getitem__(self, addr) -> Selection:
        addr = addr if isinstance(addr, tuple) else (addr,)
        sel: Selection = AllSel()
        for comp in reversed(addr):
            if _is_dynamic_int(comp):
                sel = IdxSel(sel, jnp.atleast_1d(jnp.asarray(comp)))
            else:
                sel = StaticSel(sel, comp)
        return sel

    @property
    def all(self):
        return Selection.all

    @property
    def none(self):
        return Selection.none

    @property
    def leaf(self):
        return Selection.leaf


def _is_dynamic_int(comp) -> bool:
    if isinstance(comp, (str, tuple)) or comp is Ellipsis:
        return False
    if isinstance(comp, bool):
        return False
    if isinstance(comp, int):
        return False  # concrete ints are static components
    import numpy as np

    if isinstance(comp, np.ndarray):
        # host-numpy index arrays (the recommended carrier) must take
        # the IdxSel path too: a vector in StaticSel would yield a
        # non-scalar Flag from the match
        return comp.ndim > 0
    return isinstance(comp, jnp.ndarray) or hasattr(comp, "aval")


S = _SelectionBuilder()
SelectionBuilder = _SelectionBuilder
