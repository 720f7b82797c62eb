"""``ChoiceMap``: hierarchical addressed sample storage as a pytree of arrays.

Parity: reference ``/root/reference/src/genjax/_src/core/generative/
choice_map.py`` (1786 LoC) — ``ChoiceMap`` :847, builders
``empty/choice/entry/from_mapping/d/kw/switch`` :959-1165, ``filter`` :896,
``mask`` :1171, ``extend`` :1197, ``merge``/``|`` :1227/1292, node types
``Choice`` :1397, ``Indexed`` :1454 (dynamic int addressing with
Mask-on-mismatch lookup :1501-1531), ``Static`` :1535, ``Switch`` :1627,
``Or`` :1672, builder ``ChoiceMapBuilder``/``.at`` :752/1782.

Redesign: ``filter`` and ``mask`` are **lazy wrapper nodes** resolved
only when a value is actually read (``get_value``), at which point they lower
to a handful of fused selects — no eager tree surgery, no trace-time ``vmap``
over the address structure. All leaves are arrays (a leading batch axis on
every leaf is a sharded choice map), all address structure is static treedef,
so ``NamedSharding`` specs apply uniformly.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterable, Mapping

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from ..core.staging import FlagOp
from ..core.typing_ import Flag
from .mask import Mask
from .selection import (
    AllSel,
    ChmSel,
    NoneSel,
    Selection,
)


class ChoiceMapNoValueAtAddress(GenJAXError):
    pass


class ChoiceMapCoercionError(GenJAXError):
    pass


class ChoiceMapInvalidAddress(GenJAXError):
    """A constraint addressed a location the generative function never
    samples (e.g. a typo): under ``do_checkify()`` this is an error instead
    of the constraint being silently ignored."""


def _is_dynamic(x) -> bool:
    return isinstance(x, (jax.Array, np.ndarray)) or hasattr(x, "aval")


def _static_addr(x) -> bool:
    return isinstance(x, str) or (x is Ellipsis) or isinstance(x, tuple)


def _eq_flag(a, b) -> Flag:
    """Address equality that stays concrete when both sides are concrete."""
    if not _is_dynamic(a) and not _is_dynamic(b):
        return a == b
    return jnp.asarray(a) == jnp.asarray(b)


def _slice_leaves(chm: "ChoiceMap", i) -> "ChoiceMap":
    """Index every array leaf of ``chm`` at ``i`` along its leading axis.

    Scalar (non-array) leaves pass through unchanged; by construction every
    dense-indexed choice map (vmap/scan trace choices) carries the batch axis
    on all array leaves.
    """

    def ix(leaf):
        if _is_dynamic(leaf) and jnp.ndim(leaf) >= 1:
            if isinstance(leaf, np.ndarray) and _is_dynamic(i):
                # host-numpy leaves (the recommended carrier for model
                # constants) cannot be indexed by a tracer directly
                return jnp.asarray(leaf)[i]
            return leaf[i]
        return leaf

    return jtu.tree_map(ix, chm)


def _leading_axis_size(chm: "ChoiceMap") -> int | None:
    for leaf in jtu.tree_leaves(chm):
        if _is_dynamic(leaf) and jnp.ndim(leaf) >= 1:
            return leaf.shape[0]
    return None


class ChoiceMap(Pytree):
    """Hierarchical, address-indexed storage of sampled values.

    Build with the ``C`` builder, read with ``[]``, combine with ``|``
    (left wins) or ``^`` (disjoint), restrict with ``filter``:

    >>> import genjax_tpu as g
    >>> chm = g.C["obs", "y"].set(1.0) | g.C["mu"].set(0.5)
    >>> float(chm["obs", "y"]), float(chm["mu"])
    (1.0, 0.5)
    >>> kept = chm.filter(g.S["mu"])
    >>> kept("obs").static_is_empty(), float(kept["mu"])
    (True, 0.5)
    >>> float((g.C["mu"].set(9.9) | chm)["mu"])   # left priority
    9.9
    """

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------

    @abc.abstractmethod
    def get_value(self) -> Any:
        """Value stored at this node: None, a raw value, or a ``Mask``."""

    @abc.abstractmethod
    def get_inner_map(self, addr) -> "ChoiceMap":
        """Submap under a *single* address component."""

    def static_is_empty(self) -> bool:
        return False

    # ------------------------------------------------------------------
    # builders (ChoiceMap.* — reference choice_map.py:959-1165)
    # ------------------------------------------------------------------

    @staticmethod
    def empty() -> "ChoiceMap":
        return _EMPTY

    @staticmethod
    def choice(v: Any) -> "ChoiceMap":
        return ValueChm(v)

    value = choice

    @staticmethod
    def entry(v: Any, *addrs) -> "ChoiceMap":
        if isinstance(v, ChoiceMap):
            chm = v
        elif isinstance(v, Mapping):
            chm = ChoiceMap.d(v)
        else:
            chm = ValueChm(v)
        return chm.extend(*addrs)

    @staticmethod
    def from_mapping(pairs: Iterable[tuple[Any, Any]]) -> "ChoiceMap":
        acc = ChoiceMap.empty()
        for addr, v in pairs:
            addr = addr if isinstance(addr, tuple) else (addr,)
            acc |= ChoiceMap.entry(v, *addr)
        return acc

    @staticmethod
    def d(mapping: Mapping[Any, Any]) -> "ChoiceMap":
        return ChoiceMap.from_mapping(mapping.items())

    @staticmethod
    def kw(**kwargs) -> "ChoiceMap":
        return ChoiceMap.d(kwargs)

    @staticmethod
    def switch(idx, chms: Iterable["ChoiceMap"]) -> "ChoiceMap":
        chms = list(chms)
        if isinstance(idx, int):
            return chms[idx]
        return SwitchChm(jnp.asarray(idx), tuple(chms))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def has_value(self) -> bool:
        return self.get_value() is not None

    def get_submap(self, *addresses) -> "ChoiceMap":
        chm = self
        for addr in addresses:
            components = addr if isinstance(addr, tuple) else (addr,)
            for comp in components:
                chm = chm.get_inner_map(comp)
        return chm

    def filter_eager(self, selection: Selection) -> "ChoiceMap":
        """Eagerly prune to the entries covered by ``selection``: unlike
        the lazy ``filter`` wrapper, statically-unselected subtrees are
        REMOVED from the result's structure (dynamically-conditioned parts
        stay as masked entries). Used where the result's *leaf set* is
        load-bearing — raveling a selection to a flat parameter vector
        (HMC/NUTS/fit_map) must not carry inert unselected leaves."""
        return _invalid_extras(self, ~selection)

    def filter(self, selection: Selection | Flag) -> "ChoiceMap":
        if not isinstance(selection, Selection):
            return self.mask(selection)
        if isinstance(selection, AllSel):
            return self
        if isinstance(selection, NoneSel):
            return ChoiceMap.empty()
        if self.static_is_empty():
            return self
        return FilteredChm(self, selection)

    def mask(self, flag: Flag) -> "ChoiceMap":
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return ChoiceMap.empty()
        if self.static_is_empty():
            return self
        return MaskedChm(self, flag)

    def extend(self, *addrs) -> "ChoiceMap":
        acc = self
        for addr in reversed(addrs):
            if isinstance(addr, tuple):
                # a tuple address is a path: nest one level per component
                # (get_submap flattens tuples the same way)
                acc = acc.extend(*addr)
            elif isinstance(addr, str):
                acc = StaticChm.build({addr: acc})
            else:
                acc = IndexedChm.build(acc, addr)
        return acc

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def get_selection(self) -> Selection:
        return ChmSel(self)

    def static_addresses(self) -> tuple:
        """Statically-known top-level address components (best effort)."""
        return ()

    def invalid_subset(self, gen_fn, args: tuple) -> "ChoiceMap | None":
        """The subset of this map's choices that are unreachable in any
        execution of ``gen_fn(*args)`` — e.g. misspelled constraint
        addresses — or None if every choice is reachable.

        Parity: reference ``ChoiceMap.invalid_subset``
        (choice_map.py:1358) / ``_shape_selection`` (:1747). The shape of
        the reachable address tree comes from a zero-FLOP ``get_zero_trace``
        shape evaluation; extras are pruned *eagerly* so the result is
        statically empty exactly when the constraint is statically valid.
        """
        shape_chm = gen_fn.get_zero_trace(*args).get_choices()
        extras = _invalid_extras(self, shape_selection(shape_chm))
        if not extras.static_is_empty():
            return extras
        return None

    # ------------------------------------------------------------------
    # dunders
    # ------------------------------------------------------------------

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
        return _or_build(self, other)

    def __add__(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def __xor__(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def __and__(self, other: "ChoiceMap") -> "ChoiceMap":
        return other.filter(self.get_selection())

    def __call__(self, *addresses) -> "ChoiceMap":
        return self.get_submap(*addresses)

    def __getitem__(self, addr):
        addr = addr if isinstance(addr, tuple) else (addr,)
        submap = self.get_submap(*addr)
        v = submap.get_value()
        if v is None:
            raise ChoiceMapNoValueAtAddress(addr)
        return v

    def __contains__(self, addr) -> bool:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return self.get_submap(*addr).has_value()

    @property
    def at(self) -> "_ChoiceMapBuilder":
        return _ChoiceMapBuilder(self, ())


# ----------------------------------------------------------------------
# node types
# ----------------------------------------------------------------------


@Pytree.dataclass
class EmptyChm(ChoiceMap):
    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        return self

    def static_is_empty(self) -> bool:
        return True


_EMPTY = EmptyChm()


@Pytree.dataclass
class ValueChm(ChoiceMap):
    """A leaf choice (reference ``Choice``, choice_map.py:1397)."""

    v: Any

    def get_value(self) -> Any:
        return Mask.maybe_none(self.v)

    def get_inner_map(self, addr) -> ChoiceMap:
        return _EMPTY

    def static_is_empty(self) -> bool:
        if isinstance(self.v, Mask):
            return FlagOp.concrete_false(self.v.flag)
        return False


@Pytree.dataclass
class StaticChm(ChoiceMap):
    """String/tuple-keyed mapping of submaps (reference ``Static``:1535)."""

    submaps: tuple
    keys: tuple = Pytree.static()

    @staticmethod
    def build(mapping: Mapping[Any, ChoiceMap]) -> ChoiceMap:
        keys = []
        submaps = []
        for k, v in mapping.items():
            if not v.static_is_empty():
                keys.append(k)
                submaps.append(v)
        if not keys:
            return _EMPTY
        return StaticChm(tuple(submaps), tuple(keys))

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        if not _static_addr(addr) and not isinstance(addr, (int, bool)):
            return _EMPTY
        try:
            i = self.keys.index(addr)
        except ValueError:
            return _EMPTY
        return self.submaps[i]

    def static_addresses(self) -> tuple:
        return self.keys

    def static_is_empty(self) -> bool:
        return all(s.static_is_empty() for s in self.submaps)


@Pytree.dataclass
class IndexedChm(ChoiceMap):
    """Integer-addressed submaps (reference ``Indexed``, choice_map.py:1454).

    Three modes, selected statically by ``idx``:

    - ``idx is None`` (dense): ``inner``'s array leaves carry a leading axis of
      size T; address ``j`` selects slice ``j``. This is the layout produced by
      ``Scan``/``Vmap`` traces — contiguous, shardable.
    - scalar ``idx``: ``inner`` has no leading axis; address ``j`` is valid iff
      ``j == idx``.
    - 1-D ``idx`` of shape (N,): ``inner``'s array leaves carry a leading axis
      N; lookup finds the matching position and masks on mismatch
      (reference's argwhere trick, choice_map.py:1501-1531).

    Negative indices are a READ convenience (Python semantics, concrete or
    traced) on the dense mode only; ``Selection``s always address
    canonical non-negative indices.
    """

    inner: ChoiceMap
    idx: Any  # None | scalar | 1-D int array

    @staticmethod
    def build(inner: ChoiceMap, idx) -> ChoiceMap:
        if inner.static_is_empty():
            return _EMPTY
        if idx is None:
            return IndexedChm(inner, None)
        if isinstance(idx, slice):
            if idx == slice(None, None, None):
                return IndexedChm(inner, None)
            raise ChoiceMapCoercionError(f"Unsupported slice address: {idx}")
        idx = jnp.asarray(idx) if _is_dynamic(idx) else idx
        return IndexedChm(inner, idx)

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        if _static_addr(addr):
            return _EMPTY
        if isinstance(addr, slice):
            # Full-slice read returns the whole dense inner (reference
            # choice_map.py:1483-1487); partial slices are rejected there
            # too. Under scalar/sparse ``idx`` the reference asserts out
            # (:1513-1514) — do the same.
            if addr != slice(None, None, None):
                raise ValueError(f"Partial slices not supported: {addr}")
            if self.idx is None:
                return self.inner
            raise ValueError(
                "Slice reads are not supported on sparsely-indexed maps"
            )
        if self.idx is None:
            size = _leading_axis_size(self.inner)
            if size is None:
                return _EMPTY
            if isinstance(addr, int) and not _is_dynamic(addr):
                if -size <= addr < size:
                    return _slice_leaves(self.inner, addr)
                return _EMPTY
            j = jnp.asarray(addr)
            # normalize negatives (Python indexing semantics) so traced
            # and eager reads of the same index agree
            j = jnp.where(j < 0, j + size, j)
            valid = (j >= 0) & (j < size)
            jc = jnp.clip(j, 0, size - 1)
            return _slice_leaves(self.inner, jc).mask(valid)
        if jnp.ndim(self.idx) == 0:
            return self.inner.mask(_eq_flag(addr, self.idx))
        # sparse 1-D index array
        matches = jnp.asarray(self.idx) == jnp.asarray(addr)
        valid = jnp.any(matches)
        pos = jnp.argmax(matches)
        return _slice_leaves(self.inner, pos).mask(valid)

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty()


@Pytree.dataclass
class MaskedChm(ChoiceMap):
    inner: ChoiceMap
    flag: Flag

    def get_value(self) -> Any:
        v = self.inner.get_value()
        return Mask.maybe_mask(v, self.flag)

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.inner.get_inner_map(addr).mask(self.flag)

    def mask(self, flag: Flag) -> ChoiceMap:
        return self.inner.mask(FlagOp.and_(self.flag, flag))

    def static_addresses(self) -> tuple:
        return self.inner.static_addresses()

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty() or FlagOp.concrete_false(self.flag)


@Pytree.dataclass
class FilteredChm(ChoiceMap):
    """Lazy filter by a selection (resolved at read time)."""

    inner: ChoiceMap
    selection: Selection

    def get_value(self) -> Any:
        v = self.inner.get_value()
        return Mask.maybe_mask(v, self.selection.check())

    def get_inner_map(self, addr) -> ChoiceMap:
        sub = self.inner.get_inner_map(addr)
        return sub.filter(self.selection.get_subselection(addr))

    def static_addresses(self) -> tuple:
        return self.inner.static_addresses()

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty()


@Pytree.dataclass
class SwitchChm(ChoiceMap):
    """Index-masked union over branch choice maps (reference ``Switch``:1627)."""

    idx: Any
    branches: tuple

    def get_value(self) -> Any:
        acc = None
        for i, b in enumerate(self.branches):
            v = b.get_value()
            if v is None:
                continue
            m = Mask(v, _eq_flag(self.idx, i))
            acc = m if acc is None else (acc | m)
        if acc is None:
            return None
        return Mask.maybe_none(acc)

    def get_inner_map(self, addr) -> ChoiceMap:
        subs = [b.get_inner_map(addr) for b in self.branches]
        if all(s.static_is_empty() for s in subs):
            return _EMPTY
        return SwitchChm(self.idx, tuple(subs))

    def static_addresses(self) -> tuple:
        out: list = []
        for b in self.branches:
            for a in b.static_addresses():
                if a not in out:
                    out.append(a)
        return tuple(out)

    def static_is_empty(self) -> bool:
        return all(b.static_is_empty() for b in self.branches)


@Pytree.dataclass
class OrChm(ChoiceMap):
    """Left-priority union (reference ``Or``, choice_map.py:1672)."""

    c1: ChoiceMap
    c2: ChoiceMap

    def get_value(self) -> Any:
        v1 = self.c1.get_value()
        v2 = self.c2.get_value()
        if v1 is None:
            return v2
        if v2 is None:
            return v1
        return Mask.maybe_none(Mask(v1) | Mask(v2))

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.c1.get_inner_map(addr) | self.c2.get_inner_map(addr)

    def filter(self, selection) -> ChoiceMap:
        return self.c1.filter(selection) | self.c2.filter(selection)

    def static_addresses(self) -> tuple:
        out = list(self.c1.static_addresses())
        for a in self.c2.static_addresses():
            if a not in out:
                out.append(a)
        return tuple(out)

    def static_is_empty(self) -> bool:
        return self.c1.static_is_empty() and self.c2.static_is_empty()


def _or_build(c1: ChoiceMap, c2: ChoiceMap) -> ChoiceMap:
    if c2.static_is_empty():
        return c1
    if c1.static_is_empty():
        return c2
    if isinstance(c1, StaticChm) and isinstance(c2, StaticChm):
        merged: dict = {k: v for k, v in zip(c1.keys, c1.submaps)}
        for k, v in zip(c2.keys, c2.submaps):
            merged[k] = _or_build(merged[k], v) if k in merged else v
        return StaticChm.build(merged)
    if isinstance(c1, ValueChm) and isinstance(c2, ValueChm):
        return ValueChm(Mask(c1.v) | Mask(c2.v))
    if isinstance(c1, SwitchChm) and not isinstance(c2, SwitchChm):
        return SwitchChm(c1.idx, tuple(b | c2 for b in c1.branches))
    if isinstance(c2, SwitchChm) and not isinstance(c1, SwitchChm):
        return SwitchChm(c2.idx, tuple(c1 | b for b in c2.branches))
    return OrChm(c1, c2)


# ----------------------------------------------------------------------
# constraint validation (reference choice_map.py:699-749, :1358, :1747)
# ----------------------------------------------------------------------


def shape_selection(chm: ChoiceMap) -> Selection:
    """The selection of every address reachable in ``chm``'s address tree
    (reference ``_shape_selection``, choice_map.py:1747). Integer-indexed
    levels widen to the ``...`` wildcard."""
    from .selection import LeafSel, NoneSel, Selection

    if isinstance(chm, EmptyChm):
        return NoneSel()
    if isinstance(chm, ValueChm):
        return LeafSel()
    if isinstance(chm, StaticChm):
        acc: Selection = NoneSel()
        for k, sub in zip(chm.keys, chm.submaps):
            acc = acc | shape_selection(sub).extend(k)
        return acc
    if isinstance(chm, IndexedChm):
        return shape_selection(chm.inner).extend(...)
    if isinstance(chm, (MaskedChm, FilteredChm)):
        return shape_selection(chm.inner)
    if isinstance(chm, SwitchChm):
        acc = NoneSel()
        for b in chm.branches:
            acc = acc | shape_selection(b)
        return acc
    if isinstance(chm, OrChm):
        return shape_selection(chm.c1) | shape_selection(chm.c2)
    raise ValueError(f"Unknown ChoiceMap node: {type(chm).__name__}")


def _invalid_extras(chm: ChoiceMap, sel: Selection) -> ChoiceMap:
    """Eagerly prune ``chm`` down to the entries NOT covered by ``sel``.

    Unlike ``filter`` (a lazy wrapper), the result is statically empty when
    the constraint is statically valid, so callers can raise at trace time.
    Dynamically-conditioned parts stay as masked entries for ``checkify``.
    """
    if chm.static_is_empty():
        return _EMPTY
    if isinstance(chm, ValueChm):
        chk = sel.check()
        if FlagOp.concrete_true(chk):
            return _EMPTY
        if FlagOp.concrete_false(chk):
            return chm
        return MaskedChm(chm, FlagOp.not_(chk))
    if isinstance(chm, StaticChm):
        out = {}
        for k, sub in zip(chm.keys, chm.submaps):
            ex = _invalid_extras(sub, sel.get_subselection(k))
            if not ex.static_is_empty():
                out[k] = ex
        return StaticChm.build(out)
    if isinstance(chm, IndexedChm):
        if chm.idx is not None and jnp.ndim(chm.idx) == 0:
            # scalar index (concrete or traced): resolve AT that index
            ex = _invalid_extras(chm.inner, sel.get_subselection(chm.idx))
            if ex.static_is_empty():
                return _EMPTY
            return IndexedChm(ex, chm.idx)
        if chm.idx is None:
            size = _leading_axis_size(chm.inner)
            if size is None:
                ex = _invalid_extras(chm.inner, sel.get_subselection(0))
                return _EMPTY if ex.static_is_empty() else IndexedChm(ex, None)
            if size == 0:
                return _EMPTY  # a zero-length dense map stores nothing
            # selections resolve at CANONICAL (non-negative) indices;
            # negative indices are a read-time convenience only (see
            # IndexedChm docstring) — aliasing cannot be pushed through
            # an opaque selection (complements invert the union)
            subsels = [sel.get_subselection(j) for j in range(size)]
            if _sels_uniform(subsels):
                # index-independent selection (the common wildcard /
                # shape-selection case): one representative keeps the
                # dense leaf sharing
                ex = _invalid_extras(chm.inner, subsels[0])
                return _EMPTY if ex.static_is_empty() else IndexedChm(ex, None)
            # index-dependent selection (e.g. S["steps", 3]): resolve
            # slice by slice so the verdict at index 0 is not applied to
            # every slice
            acc: ChoiceMap = _EMPTY
            for j in range(size):
                ex = _invalid_extras(_slice_leaves(chm.inner, j), subsels[j])
                if not ex.static_is_empty():
                    acc = _or_build(acc, IndexedChm(ex, j))
            return acc
        # sparse 1-D index array: resolve each stored position at its own
        # (possibly traced) index value
        npos = jnp.shape(chm.idx)[0]
        acc = _EMPTY
        for pos in range(npos):
            iv = chm.idx[pos]
            if not _is_dynamic(iv):
                iv = int(iv)
            ex = _invalid_extras(
                _slice_leaves(chm.inner, pos), sel.get_subselection(iv)
            )
            if not ex.static_is_empty():
                acc = _or_build(acc, IndexedChm(ex, iv))
        return acc
    if isinstance(chm, MaskedChm):
        ex = _invalid_extras(chm.inner, sel)
        return ex.mask(chm.flag)
    if isinstance(chm, FilteredChm):
        # conservative: the filter can only remove entries, so extras of
        # the filtered map are a subset of the inner extras (may overreport
        # dynamically; existence stays gated by _exists_flag)
        return _invalid_extras(chm.inner, sel)
    if isinstance(chm, SwitchChm):
        subs = tuple(_invalid_extras(b, sel) for b in chm.branches)
        if all(s.static_is_empty() for s in subs):
            return _EMPTY
        return SwitchChm(chm.idx, subs)
    if isinstance(chm, OrChm):
        e1 = _invalid_extras(chm.c1, sel)
        e2 = _invalid_extras(chm.c2, sel)
        return _or_build(e1, e2)
    # unknown node: conservatively report it whole
    return chm


def _sels_uniform(sels) -> bool:
    """Are these selections structurally identical (same verdict at every
    index)? Conservative: any dynamic leaf or structural difference says
    no — callers then fall back to per-index resolution."""
    if not sels:
        return True
    s0 = jtu.tree_structure(sels[0])
    l0 = jtu.tree_leaves(sels[0])
    for s in sels[1:]:
        if s is sels[0]:
            continue
        if jtu.tree_structure(s) != s0:
            return False
        for a, b in zip(l0, jtu.tree_leaves(s)):
            if a is b:
                continue
            if _is_dynamic(a) or _is_dynamic(b):
                return False
            if a != b:
                return False
    return True


def exists_flag(chm: ChoiceMap) -> Flag:
    """Does any value actually exist in ``chm`` at runtime? Concrete
    ``True`` means statically provable presence."""
    if isinstance(chm, EmptyChm):
        return False
    if isinstance(chm, ValueChm):
        v = chm.get_value()
        if v is None:
            return False
        return v.primal_flag() if isinstance(v, Mask) else True
    if isinstance(chm, StaticChm):
        flag: Flag = False
        for sub in chm.submaps:
            flag = FlagOp.or_(flag, exists_flag(sub))
        return flag
    if isinstance(chm, IndexedChm):
        return exists_flag(chm.inner)
    if isinstance(chm, MaskedChm):
        return FlagOp.and_(chm.flag, exists_flag(chm.inner))
    if isinstance(chm, SwitchChm):
        flag = False
        for i, b in enumerate(chm.branches):
            flag = FlagOp.or_(
                flag, FlagOp.and_(_eq_flag(chm.idx, i), exists_flag(b))
            )
        return flag
    if isinstance(chm, OrChm):
        return FlagOp.or_(exists_flag(chm.c1), exists_flag(chm.c2))
    if isinstance(chm, FilteredChm):
        return exists_flag(chm.inner)  # conservative over-approximation
    return True


# ----------------------------------------------------------------------
# builder
# ----------------------------------------------------------------------


class _ChoiceMapBuilder:
    """``C["x", 0, "y"].set(v)`` — fluent construction of nested entries.

    Parity: reference ``_ChoiceMapBuilder`` (choice_map.py:752) and the
    ``ChoiceMap.at`` property (:1782). ``chm.at[addr].set(v)`` layers the new
    entry over ``chm`` with priority.
    """

    def __init__(self, base: ChoiceMap | None, path: tuple):
        self._base = base
        self._path = path

    def __getitem__(self, addr) -> "_ChoiceMapBuilder":
        addr = addr if isinstance(addr, tuple) else (addr,)
        return _ChoiceMapBuilder(self._base, self._path + addr)

    def set(self, v) -> ChoiceMap:
        entry = ChoiceMap.entry(v, *self._path)
        if self._base is None or self._base.static_is_empty():
            return entry
        return entry | self._base

    def update(self, fn: Callable[[Any], Any]) -> ChoiceMap:
        if self._base is not None:
            sub = self._base.get_submap(*self._path)
            v = sub.get_value()
            return self.set(fn(v))
        return self.set(fn(None))

    # convenience passthroughs so `C.kw(...)`, `C.d(...)` work
    def kw(self, **kwargs) -> ChoiceMap:
        return ChoiceMap.kw(**kwargs).extend(*self._path)

    def d(self, mapping) -> ChoiceMap:
        return ChoiceMap.d(mapping).extend(*self._path)

    def v(self, value) -> ChoiceMap:
        return ChoiceMap.entry(value, *self._path)

    def from_mapping(self, pairs) -> ChoiceMap:
        return ChoiceMap.from_mapping(pairs).extend(*self._path)

    def switch(self, idx, chms) -> ChoiceMap:
        return ChoiceMap.switch(idx, chms).extend(*self._path)

    def empty(self) -> ChoiceMap:
        return ChoiceMap.empty()

    def value(self, v) -> ChoiceMap:
        return ChoiceMap.entry(v, *self._path)


C = _ChoiceMapBuilder(None, ())
ChoiceMapBuilder = C
