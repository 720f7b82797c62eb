"""``Vmap`` combinator: broadcast a generative function over a batch axis.

Parity: reference ``/root/reference/src/genjax/_src/generative_functions/
combinators/vmap.py`` (420 LoC) — ``VmapTrace`` :55, axis-length validation
:153, ``simulate`` :180, ``generate`` :193 (per-index constraint lookup),
``project`` :220, ``assess`` :363, ``edit_choice_map`` :237, ``edit_index``
:277 (O(1) slice-edit-scatter), ``edit`` :334, decorator ``vmap`` :384.

Design notes: the batched inner trace is a *single pytree* whose leaves
carry the batch axis in front — exactly the layout that shards over a device
mesh with ``NamedSharding(("batch", ...))``. ``edit_index`` lowers to one
dynamic-slice + one dynamic-update-slice per leaf (no gather/scatter over
the full batch).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu

from ..core.diff import Diff
from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap, IndexedChm
from ..generative.concepts import (
    dispatch_edit,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    Regenerate,
    Retdiff,
    Update,
    VectorRequest,
    Weight,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace


@Pytree.dataclass
class VmapTrace(Trace):
    """Trace of a vmapped generative function: one inner trace pytree with a
    leading batch axis on every leaf (reference vmap.py:55)."""

    gen_fn: "VmapCombinator"
    inner: Trace
    args: tuple
    n: int = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.inner.get_retval()

    def get_gen_fn(self) -> "VmapCombinator":
        return self.gen_fn

    def get_score(self):
        return jnp.sum(jax.vmap(lambda tr: tr.get_score())(self.inner))

    def get_choices(self) -> ChoiceMap:
        return IndexedChm.build(self.inner.get_choices(), None)

    def get_inner_trace(self, address) -> Trace:
        return jtu.tree_map(lambda v: v[address], self.inner)


@Pytree.dataclass
class VmapCombinator(GenerativeFunction):
    """``vmap``-broadcast of ``gen_fn`` over a leading batch axis of its
    arguments (reference vmap.py:98)."""

    gen_fn: GenerativeFunction
    in_axes: Any = Pytree.static(default=0)
    axis_size: int | None = Pytree.static(default=None)
    axis_name: str | None = Pytree.static(default=None)

    # ------------------------------------------------------------------
    # axis bookkeeping (reference _static_broadcast_dim_length, vmap.py:153)
    # ------------------------------------------------------------------

    def _static_axis_size(self, args: tuple) -> int:
        axes = self.in_axes
        if not isinstance(axes, tuple):
            axes = (axes,) * len(args)
        sizes = set()
        for ax, arg in zip(axes, args):
            if ax is None:
                continue
            leaves = jtu.tree_leaves(arg)
            if isinstance(ax, int):
                leaf_axes = [ax] * len(leaves)
            else:
                # prefix pytree of per-subtree axes: broadcast each entry
                # over the leaves of the corresponding subtree
                leaf_axes = jtu.tree_leaves(
                    jtu.tree_map(
                        lambda a, sub: jtu.tree_map(lambda _: a, sub),
                        ax,
                        arg,
                        is_leaf=lambda x: x is None,
                    ),
                    is_leaf=lambda x: x is None,
                )
            for leaf_ax, leaf in zip(leaf_axes, leaves):
                if leaf_ax is not None:
                    sizes.add(jnp.shape(leaf)[leaf_ax])
        if self.axis_size is not None:
            sizes.add(self.axis_size)
        if len(sizes) > 1:
            raise ValueError(
                f"vmap: inconsistent batch axis sizes {sorted(sizes)}; check "
                "in_axes/axis_size."
            )
        if not sizes:
            raise ValueError(
                "vmap: could not infer the batch axis size — all in_axes are "
                "None and no axis_size was given."
            )
        return int(next(iter(sizes)))

    def _vmap(self, fn, extra_in_axes: tuple):
        return jax.vmap(
            fn,
            in_axes=(*extra_in_axes, self.in_axes),
            axis_name=self.axis_name,
            axis_size=self.axis_size,
        )

    # ------------------------------------------------------------------
    # GFI
    # ------------------------------------------------------------------

    def simulate(self, key: PRNGKey, args: tuple) -> VmapTrace:
        n = self._static_axis_size(args)
        keys = jr.split(key, n)
        inner = self._vmap(self.gen_fn.simulate, (0,))(keys, args)
        return VmapTrace(self, inner, args, n)

    def generate(self, key: PRNGKey, constraint: ChoiceMap, args: tuple):
        n = self._static_axis_size(args)
        keys = jr.split(key, n)
        idxs = jnp.arange(n)

        def _gen(key, i, a):
            return self.gen_fn.generate(key, constraint.get_submap(i), a)

        inner, ws = self._vmap(_gen, (0, 0))(keys, idxs, args)
        return VmapTrace(self, inner, args, n), jnp.sum(ws)

    def assess(self, chm: ChoiceMap, args: tuple):
        n = self._static_axis_size(args)
        idxs = jnp.arange(n)

        def _assess(i, a):
            return self.gen_fn.assess(chm.get_submap(i), a)

        scores, retvals = self._vmap(_assess, (0,))(idxs, args)
        return jnp.sum(scores), retvals

    def project(self, key: PRNGKey, trace: VmapTrace, selection: Selection) -> Weight:
        n = trace.n
        keys = jr.split(key, n)
        idxs = jnp.arange(n)

        def _proj(key, i, tr):
            return self.gen_fn.project(key, tr, selection.get_subselection(i))

        ws = jax.vmap(_proj)(keys, idxs, trace.inner)
        return jnp.sum(ws)

    # ------------------------------------------------------------------
    # edits
    # ------------------------------------------------------------------

    def edit(
        self,
        key: PRNGKey,
        trace: VmapTrace,
        request: EditRequest,
        argdiffs: Any,
    ) -> tuple[VmapTrace, Weight, Retdiff, EditRequest]:
        if isinstance(request, Update):
            return self._edit_choice_map(key, trace, request.constraint, argdiffs)
        if isinstance(request, Regenerate):
            return self._edit_regenerate(key, trace, request.selection, argdiffs)
        if isinstance(request, IndexRequest):
            return self._edit_index(key, trace, request.index, request.request, argdiffs)
        if isinstance(request, VectorRequest):
            return self._edit_vector(key, trace, request.request, argdiffs)
        raise NotSupportedEditRequest(
            f"VmapCombinator cannot serve {type(request).__name__}."
        )

    def _edit_choice_map(self, key, trace: VmapTrace, constraint: ChoiceMap, argdiffs):
        primals = Diff.tree_primal(argdiffs)
        n = trace.n
        keys = jr.split(key, n)
        idxs = jnp.arange(n)

        def _edit(key, i, sub_tr, ad):
            submap = constraint.get_submap(i)
            new_tr, w, _rd, bwd = self.gen_fn.edit(key, sub_tr, Update(submap), ad)
            return new_tr, w, bwd

        new_inner, ws, bwds = self._vmap(_edit, (0, 0, 0))(
            keys, idxs, trace.inner, argdiffs
        )
        new_tr = VmapTrace(self, new_inner, primals, n)
        retdiff = Diff.tree_diff_unknown_change(new_tr.get_retval())
        return new_tr, jnp.sum(ws), retdiff, _lossless_bwd(bwds)

    def _edit_regenerate(self, key, trace: VmapTrace, selection: Selection, argdiffs):
        primals = Diff.tree_primal(argdiffs)
        n = trace.n
        keys = jr.split(key, n)
        idxs = jnp.arange(n)

        def _edit(key, i, sub_tr, ad):
            subsel = selection.get_subselection(i)
            new_tr, w, _rd, bwd = self.gen_fn.edit(key, sub_tr, Regenerate(subsel), ad)
            return new_tr, w, bwd

        new_inner, ws, bwds = self._vmap(_edit, (0, 0, 0))(
            keys, idxs, trace.inner, argdiffs
        )
        new_tr = VmapTrace(self, new_inner, primals, n)
        retdiff = Diff.tree_diff_unknown_change(new_tr.get_retval())
        return new_tr, jnp.sum(ws), retdiff, _lossless_bwd(bwds)

    def _edit_vector(self, key, trace: VmapTrace, per_lane: EditRequest, argdiffs):
        """Apply a per-lane request pytree (leaves batched on axis 0)."""
        primals = Diff.tree_primal(argdiffs)
        n = trace.n
        keys = jr.split(key, n)

        def _edit(key, req, sub_tr, ad):
            new_tr, w, _rd, bwd = dispatch_edit(self.gen_fn, key, sub_tr, req, ad)
            return new_tr, w, bwd

        new_inner, ws, bwds = self._vmap(_edit, (0, 0, 0))(
            keys, per_lane, trace.inner, argdiffs
        )
        new_tr = VmapTrace(self, new_inner, primals, n)
        retdiff = Diff.tree_diff_unknown_change(new_tr.get_retval())
        return new_tr, jnp.sum(ws), retdiff, _lossless_bwd(bwds)

    def _edit_index(self, key, trace: VmapTrace, idx, request: EditRequest, argdiffs):
        """O(1) single-lane edit: slice the lane, edit it, scatter it back
        (reference vmap.py:277). One dynamic-slice + one
        dynamic-update-slice per leaf — no full-batch traffic."""
        if not Diff.static_check_no_change(argdiffs):
            raise NotSupportedEditRequest(
                "IndexRequest into Vmap requires unchanged arguments."
            )
        slice_tr = jtu.tree_map(lambda v: v[idx], trace.inner)
        sub_argdiffs = Diff.tree_diff_no_change(slice_tr.get_args())
        new_slice, w, _rd, bwd = dispatch_edit(
            self.gen_fn, key, slice_tr, request, sub_argdiffs
        )
        new_inner = jtu.tree_map(
            lambda v, s: v.at[idx].set(s), trace.inner, new_slice
        )
        new_tr = VmapTrace(self, new_inner, trace.args, trace.n)
        retdiff = Diff.tree_diff_unknown_change(new_tr.get_retval())
        return new_tr, w, retdiff, IndexRequest(idx, bwd)


def _lossless_bwd(bwds) -> EditRequest:
    """Batched per-lane backward requests: Updates collapse to the usual
    dense-choice-map discard; anything else is carried per lane."""
    if isinstance(bwds, Update):
        return Update(IndexedChm.build(bwds.constraint, None))
    return VectorRequest(bwds)


def vmap(*, in_axes: Any = 0, axis_size: int | None = None, axis_name: str | None = None):
    """Decorator form: ``vmap(in_axes=...)(gen_fn)`` (reference vmap.py:384).

    One batched execution; choices index by lane first:

    >>> import jax
    >>> import jax.numpy as jnp
    >>> import genjax_tpu as g
    >>> @g.vmap(in_axes=(0,))
    ... @g.gen
    ... def batched(mu):
    ...     return g.normal(mu, 1.0) @ "x"
    >>> tr = batched.simulate(jax.random.key(0), (jnp.zeros(3),))
    >>> tr.get_choices()[1, "x"].shape
    ()
    >>> tr.get_retval().shape
    (3,)
    """

    def decorator(gen_fn: GenerativeFunction) -> VmapCombinator:
        return VmapCombinator(gen_fn, in_axes=in_axes, axis_size=axis_size, axis_name=axis_name)

    return decorator
