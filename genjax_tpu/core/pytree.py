"""Pytree dataclass substrate.

Design note: every framework object (traces, choice maps, requests,
generative functions) is a frozen dataclass registered with JAX's pytree system
via ``jax.tree_util.register_dataclass``. Static fields live in the treedef
(hashable, compared at trace time); dynamic fields are array leaves, so a batch
of 64k chains is just a leading axis on every leaf — ready for
``jax.sharding.NamedSharding`` without any repacking.

Functional parity with the reference substrate
(``/root/reference/src/genjax/_src/core/pytree.py``: ``Pytree`` :40,
``Pytree.dataclass`` :73, ``Pytree.static`` :113, ``Pytree.field`` :134,
``Const`` :234, ``Closure`` :300, ``PythonicPytree`` :342) — re-designed on
plain ``dataclasses`` + ``register_dataclass`` instead of penzai structs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

T = TypeVar("T")

_STATIC_MARK = "genjax_tpu_static"


class Pytree:
    """Base mixin for JAX-registered dataclasses.

    Subclasses are declared with the ``@Pytree.dataclass`` decorator. Fields
    declared with ``Pytree.static()`` are stored in the treedef (must be
    hashable); all other fields are dynamic pytree children.

    >>> import jax
    >>> import jax.numpy as jnp
    >>> from genjax_tpu import Pytree
    >>> @Pytree.dataclass
    ... class Particle(Pytree):
    ...     pos: jnp.ndarray
    ...     name: str = Pytree.static(default="p")
    >>> p = Particle(jnp.zeros(3))
    >>> [leaf.shape for leaf in jax.tree_util.tree_leaves(p)]
    [(3,)]
    >>> jax.tree_util.tree_map(lambda x: x + 1.0, p).name  # static rides along
    'p'
    """

    @staticmethod
    def dataclass(cls: type[T] | None = None, /, **kwargs) -> type[T]:
        if cls is None:
            return functools.partial(Pytree.dataclass, **kwargs)  # type: ignore

        kwargs.setdefault("frozen", True)
        dcls = dataclasses.dataclass(**kwargs)(cls)
        meta_fields = []
        data_fields = []
        for f in dataclasses.fields(dcls):
            if f.metadata.get(_STATIC_MARK, False):
                meta_fields.append(f.name)
            else:
                data_fields.append(f.name)
        jtu.register_dataclass(dcls, data_fields=data_fields, meta_fields=meta_fields)
        return dcls

    @staticmethod
    def static(**kwargs) -> Any:
        """Declare a static (treedef) field."""
        metadata = dict(kwargs.pop("metadata", {}))
        metadata[_STATIC_MARK] = True
        return dataclasses.field(metadata=metadata, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """Declare a dynamic (leaf-bearing) field."""
        return dataclasses.field(**kwargs)

    @staticmethod
    def const(v: Any) -> "Const":
        """Wrap ``v`` as a static constant that rides in the treedef."""
        if isinstance(v, Const):
            return v
        return Const(v)

    @staticmethod
    def partial(*closed_over) -> Callable[[Callable], "Closure"]:
        """Create a JAX-compatible closure: ``Pytree.partial(x)(fn)``."""

        def decorator(fn: Callable) -> Closure:
            return Closure(closed_over, fn)

        return decorator

    # ----- convenience -----

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)  # type: ignore

    def treedef(self):
        return jtu.tree_structure(self)

    def render_html(self):
        import treescope  # deferred: optional pretty-printing dep

        with treescope.using_expansion_strategy(max_height=None):
            return treescope.render_to_html(self, compressed=True)

    def treescope_color(self) -> str:
        import treescope

        return treescope.formatting_util.color_from_string(type(self).__name__)

    def __repr__(self) -> str:
        if dataclasses.is_dataclass(self):
            parts = []
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, jax.Array):
                    if v.ndim == 0:
                        parts.append(f"{f.name}={v}")
                    else:
                        parts.append(f"{f.name}=<{v.dtype}{list(v.shape)}>")
                else:
                    parts.append(f"{f.name}={v!r}")
            return f"{type(self).__name__}({', '.join(parts)})"
        return super().__repr__()


@Pytree.dataclass
class Const(Pytree):
    """A static value smuggled through ``jit`` boundaries in the treedef.

    Parity: reference ``Const`` (pytree.py:234). ``Const(3)`` has no array
    leaves; the payload is compared/hashed as part of the treedef.
    """

    val: Any = Pytree.static()

    def unwrap(self) -> Any:
        return self.val

    def __call__(self, *args, **kwargs):
        return self.val(*args, **kwargs)


def const_unwrap(v: Any) -> Any:
    return v.val if isinstance(v, Const) else v


def tree_const(v: Any) -> Any:
    """Wrap every leaf of ``v`` in ``Const`` (reference pytree.py:155)."""
    return jtu.tree_map(lambda x: x if isinstance(x, Const) else Const(x), v)


def tree_const_unwrap(v: Any) -> Any:
    """Unwrap every ``Const`` leaf of ``v`` (reference pytree.py:170)."""
    return jtu.tree_map(const_unwrap, v, is_leaf=lambda x: isinstance(x, Const))


@Pytree.dataclass
class Closure(Pytree):
    """A JAX-compatible closure: static callable + dynamic closed-over args.

    Parity: reference ``Closure`` (pytree.py:300). Used as the source carrier
    for ``@gen`` functions with captured dynamic state.
    """

    dyn_args: tuple
    fn: Callable = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.fn(*self.dyn_args, *args, **kwargs)


class PythonicPytree(Pytree):
    """Sugar for uniform-leaf pytrees: indexing, len, iteration, concat.

    Parity: reference ``PythonicPytree`` (pytree.py:342-377).
    """

    def __getitem__(self, idx):
        return jtu.tree_map(lambda leaf: leaf[idx], self)

    def __len__(self) -> int:
        leaves = jtu.tree_leaves(self)
        if not leaves:
            return 0
        return int(leaves[0].shape[0])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __add__(self, other):
        return jtu.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self, other
        )


def nth(tree: Any, idx) -> Any:
    """Index every leaf of ``tree`` at ``idx`` along the leading axis."""
    return jtu.tree_map(lambda leaf: leaf[idx], tree)
