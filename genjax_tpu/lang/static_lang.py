"""The ``@gen`` static modeling language.

Parity: reference ``/root/reference/src/genjax/_src/generative_functions/
static.py`` (1062 LoC) — the ``trace`` intrinsic :175, handlers
``SimulateHandler`` :254 (fresh keys by ``fold_in`` counter :260-263),
``AssessHandler`` :298 (raises ``MissingAddress`` :147), ``GenerateHandler``
:341, ``UpdateHandler`` :407, ``StaticEditRequestHandler`` :512 (per-address
sub-requests via ``StaticRequest`` :130), ``RegenerateRequestHandler`` :616,
``StaticGenerativeFunction`` :726 (edit routing :948-981), ``StaticTrace``
:81 (score = sum of subscores :102), ``gen`` decorator :1044, method support
:757, ``partial_apply`` :1011, ``AddressReuse`` :139.

Redesign: instead of staging the model to a Jaxpr and
re-interpreting ``trace_p`` equations, each GFI method executes the Python
body under a handler installed on a dynamic handler stack
(``genjax_tpu.core.handlers``). Under ``jit`` this produces the identical XLA
program with less trace-time overhead, and models may use arbitrary Python
data structure without pytree flattening constraints.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp
import jax.random as jr

from ..core.diff import Diff
from ..core.handlers import (
    AddressReuse,
    MissingAddress,
    TraceHandler,
    handle,
)
from ..core.pytree import Closure, Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import (
    EditRequest,
    EmptyRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Retdiff,
    Update,
    Weight,
    dispatch_edit,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace


@Pytree.dataclass
class StaticRequest(PrimitiveEditRequest):
    """Heterogeneous per-address edit requests for a static model
    (reference static.py:130). A ``PrimitiveEditRequest``: ``edit``
    defers to the generative function, so ``dispatch_edit`` can route it
    through the CURRENT callee when closures changed."""

    subrequests: tuple
    addresses: tuple = Pytree.static()

    @staticmethod
    def d(mapping: dict) -> "StaticRequest":
        return StaticRequest(tuple(mapping.values()), tuple(mapping.keys()))

    def get(self, addr) -> EditRequest:
        try:
            i = self.addresses.index(addr)
        except ValueError:
            return EmptyRequest()
        return self.subrequests[i]


@Pytree.dataclass
class StaticTrace(Trace):
    gen_fn: "StaticGenerativeFunction"
    args: tuple
    retval: Any
    subtraces: tuple
    addresses: tuple = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_gen_fn(self) -> "StaticGenerativeFunction":
        return self.gen_fn

    def get_score(self):
        total = jnp.asarray(0.0)
        for tr in self.subtraces:
            total = total + tr.get_score()
        return total

    def get_choices(self) -> ChoiceMap:
        acc = ChoiceMap.empty()
        for addr, tr in zip(self.addresses, self.subtraces):
            path = addr if isinstance(addr, tuple) else (addr,)
            acc |= tr.get_choices().extend(*path)
        return acc

    def get_inner_trace(self, address) -> Trace:
        try:
            i = self.addresses.index(address)
        except ValueError as e:
            raise MissingAddress(f"No subtrace at address {address!r}") from e
        return self.subtraces[i]


# ----------------------------------------------------------------------
# handlers
# ----------------------------------------------------------------------


class StaticHandler(TraceHandler):
    """Base: key management by fold_in counter + address-reuse detection."""

    def __init__(self, key: PRNGKey | None):
        self.key = key
        self.count = 0
        self.addresses: list = []
        self.subtraces: list[Trace] = []

    def visit(self, addr) -> None:
        if addr in self.addresses:
            raise AddressReuse(f"Address {addr!r} was traced twice.")
        self.addresses.append(addr)

    def fresh_key(self) -> PRNGKey:
        k = jr.fold_in(self.key, self.count)
        self.count += 1
        return k

    def record(self, tr: Trace) -> Any:
        self.subtraces.append(tr)
        return tr.get_retval()


class SimulateHandler(StaticHandler):
    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        return self.record(gen_fn.simulate(self.fresh_key(), args))


class AssessHandler(StaticHandler):
    def __init__(self, chm: ChoiceMap):
        super().__init__(None)
        self.chm = chm
        self.score = jnp.asarray(0.0)

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        path = addr if isinstance(addr, tuple) else (addr,)
        submap = self.chm.get_submap(*path)
        if submap.static_is_empty():
            raise MissingAddress(f"assess: no constraint at address {addr!r}")
        score, retval = gen_fn.assess(submap, args)
        self.score = self.score + score
        return retval


class GenerateHandler(StaticHandler):
    def __init__(self, key: PRNGKey, constraint: ChoiceMap):
        super().__init__(key)
        self.constraint = constraint
        self.weight = jnp.asarray(0.0)

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        path = addr if isinstance(addr, tuple) else (addr,)
        submap = self.constraint.get_submap(*path)
        tr, w = gen_fn.generate(self.fresh_key(), submap, args)
        self.weight = self.weight + w
        return self.record(tr)


class EditHandler(StaticHandler):
    """Shared machinery for Update / Regenerate / StaticRequest edits: re-runs
    the body, editing each old subtrace with a per-address sub-request.

    Clean-prefix optimization: in a static body, execution order equals
    dependency order, so until the first address whose sub-request actually
    does something (and while the top-level arguments are unchanged), every
    address's arguments are bitwise-identical to the previous trace's —
    those subtraces are reused untouched (weight 0, no re-scoring). This
    recovers the reference incremental interpreter's O(selected-suffix)
    edit cost and keeps stochastic-density callees from injecting weight
    noise at untouched addresses.
    """

    def __init__(self, key: PRNGKey, prev: StaticTrace, args_unchanged: bool):
        super().__init__(key)
        self.prev = prev
        self.weight = jnp.asarray(0.0)
        self.bwd: dict = {}
        # False once an upstream address may have changed a value
        self.clean = args_unchanged

    def subrequest(self, addr) -> EditRequest:
        raise NotImplementedError

    @staticmethod
    def _is_trivial(request: EditRequest) -> bool:
        if isinstance(request, EmptyRequest):
            return True
        if isinstance(request, Update):
            return request.constraint.static_is_empty()
        if isinstance(request, Regenerate):
            from ..generative.selection import NoneSel

            return isinstance(request.selection, NoneSel)
        return False

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        sub_tr = self.prev.get_inner_trace(addr)
        request = self.subrequest(addr)
        if self.clean and self._is_trivial(request):
            # nothing upstream changed, nothing requested here: reuse
            self.fresh_key()  # keep the key counter aligned
            self.bwd[addr] = EmptyRequest()
            return self.record(sub_tr)
        argdiffs = Diff.tree_diff_unknown_change(args)
        # dispatch through the CURRENT callee: the handler re-executed the
        # body with the new arguments, so ``gen_fn`` carries any
        # re-closed-over dynamic values the previous subtrace is stale on
        new_tr, w, _retdiff, bwd = dispatch_edit(
            gen_fn, self.fresh_key(), sub_tr, request, argdiffs
        )
        self.weight = self.weight + w
        self.bwd[addr] = bwd
        if not self._is_trivial(request):
            self.clean = False
        return self.record(new_tr)


class UpdateHandler(EditHandler):
    def __init__(self, key, prev, constraint: ChoiceMap, args_unchanged=False):
        super().__init__(key, prev, args_unchanged)
        self.constraint = constraint

    def subrequest(self, addr) -> EditRequest:
        path = addr if isinstance(addr, tuple) else (addr,)
        return Update(self.constraint.get_submap(*path))

    def bwd_request(self) -> Update:
        return _assemble_update_bwd(self.bwd)


class RegenerateHandler(EditHandler):
    def __init__(self, key, prev, selection: Selection, args_unchanged=False):
        super().__init__(key, prev, args_unchanged)
        self.selection = selection

    def subrequest(self, addr) -> EditRequest:
        path = addr if isinstance(addr, tuple) else (addr,)
        subsel = self.selection
        for comp in path:
            subsel = subsel.get_subselection(comp)
        return Regenerate(subsel)

    def bwd_request(self) -> EditRequest:
        # Per-address backward requests (Updates carrying the old values), so
        # applying the backward request restores the original trace and
        # cancels the forward weight exactly.
        return StaticRequest.d(self.bwd)


class StaticRequestHandler(EditHandler):
    def __init__(self, key, prev, request: StaticRequest, args_unchanged=False):
        super().__init__(key, prev, args_unchanged)
        self.request = request

    def subrequest(self, addr) -> EditRequest:
        return self.request.get(addr)

    def bwd_request(self) -> StaticRequest:
        return StaticRequest.d(self.bwd)


# ----------------------------------------------------------------------
# the generative function
# ----------------------------------------------------------------------


@Pytree.dataclass
class StaticGenerativeFunction(GenerativeFunction):
    """A generative function constructed from a Python body containing
    addressed calls (``gen_fn(args) @ "addr"``)."""

    source: Closure

    def run(self, handler: StaticHandler, args: tuple):
        with handle(handler):
            retval = self.source(*args)
        return retval

    # ----- GFI -----

    def simulate(self, key: PRNGKey, args: tuple) -> StaticTrace:
        from ..typecheck import check_args, check_key

        check_key(key, "simulate")
        check_args(args, "simulate")
        h = SimulateHandler(key)
        retval = self.run(h, args)
        return StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))

    def assess(self, chm: ChoiceMap, args: tuple):
        from ..typecheck import check_args, check_constraint

        check_constraint(chm, "assess")
        check_args(args, "assess")
        _maybe_validate_constraint(self, chm, args, "assess")
        h = AssessHandler(chm)
        retval = self.run(h, args)
        return h.score, retval

    def generate(self, key: PRNGKey, constraint: ChoiceMap, args: tuple):
        from ..typecheck import check_args, check_constraint, check_key

        check_key(key, "generate")
        check_constraint(constraint, "generate")
        check_args(args, "generate")
        _maybe_validate_constraint(self, constraint, args, "generate")
        h = GenerateHandler(key, constraint)
        retval = self.run(h, args)
        tr = StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))
        return tr, h.weight

    def project(self, key: PRNGKey, trace: StaticTrace, selection: Selection) -> Weight:
        total = jnp.asarray(0.0)
        for i, (addr, sub_tr) in enumerate(
            zip(trace.addresses, trace.subtraces)
        ):
            path = addr if isinstance(addr, tuple) else (addr,)
            subsel = selection
            for comp in path:
                subsel = subsel.get_subselection(comp)
            total = total + sub_tr.project(jr.fold_in(key, i), subsel)
        return total

    def edit(
        self,
        key: PRNGKey,
        trace: StaticTrace,
        request: EditRequest,
        argdiffs: Any,
    ) -> tuple[StaticTrace, Weight, Retdiff, EditRequest]:
        if not isinstance(request, (Update, Regenerate, StaticRequest)):
            raise NotSupportedEditRequest(
                f"StaticGenerativeFunction cannot serve {type(request).__name__}."
            )
        primals = Diff.tree_primal(argdiffs)
        from .staged_edit import StagingUnsupported, stage_body

        try:
            staged = stage_body(self.source, primals)
        except StagingUnsupported:
            # bodies requiring concrete values (Python control flow on
            # traced data) cannot be staged — serve them with the
            # handler-based edit (clean-prefix reuse only)
            return self._edit_via_handler(key, trace, request, argdiffs)
        return self._edit_staged(key, trace, request, argdiffs, staged)

    def _edit_staged(self, key, trace, request, argdiffs, staged):
        """Jaxpr-level incremental edit: per-equation NoChange propagation,
        so only the selected addresses and their true dependents re-score
        (reference incremental.py:300-311 + static.py:469-504)."""
        import jax.tree_util as jtu

        from .staged_edit import flat_changed, incremental_edit, _tangent_tree

        primals = Diff.tree_primal(argdiffs)
        closed_jaxpr, flat_args, out_tree = staged

        if isinstance(request, Update):
            constraint = request.constraint

            def subrequest(addr):
                path = addr if isinstance(addr, tuple) else (addr,)
                return Update(constraint.get_submap(*path))

        elif isinstance(request, Regenerate):
            selection = request.selection

            def subrequest(addr):
                path = addr if isinstance(addr, tuple) else (addr,)
                subsel = selection
                for comp in path:
                    subsel = subsel.get_subselection(comp)
                return Regenerate(subsel)

        else:  # StaticRequest
            subrequest = request.get

        # input change flags: the source closure's leaves compare against
        # the PREVIOUS trace's gen fn — a re-``partial_apply``-ed callee
        # whose closed-over values changed must re-score its dependents
        # even when the argdiffs say NoChange; argument leaves come from
        # the caller's diffs
        from ..generative.concepts import python_closure_mismatch
        from .staged_edit import source_changed_flags

        changed_in = source_changed_flags(
            self.source, trace.get_gen_fn().source
        ) + flat_changed(argdiffs)
        from ..core.diff import has_hidden_static_change

        if has_hidden_static_change(argdiffs):
            # a changed Const has no dynamic leaf to carry its flag (the
            # staged jaxpr embeds it as a literal): degrade to a full
            # re-evaluation rather than silently reusing stale subtraces
            changed_in = [True] * len(changed_in)

        out_flat, out_changed, weight, addresses, subtraces, bwd = (
            incremental_edit(
                closed_jaxpr,
                flat_args,
                changed_in,
                key=key,
                prev_trace=trace,
                subrequest=subrequest,
                is_trivial=EditHandler._is_trivial,
                # body constants captured via Python closures may carry
                # fresh upstream values when the function object changed
                consts_changed=python_closure_mismatch(
                    trace.get_gen_fn().source, self.source
                ),
            )
        )
        retval = jtu.tree_unflatten(out_tree, out_flat)
        new_tr = StaticTrace(
            self, primals, retval, tuple(subtraces), tuple(addresses)
        )
        retdiff = Diff.tree_diff(retval, _tangent_tree(retval, out_changed))
        if isinstance(request, Update):
            bwd_req: EditRequest = _assemble_update_bwd(bwd)
        else:
            bwd_req = StaticRequest.d(bwd)
        return new_tr, weight, retdiff, bwd_req

    def _edit_via_handler(self, key, trace, request, argdiffs):
        """Fallback edit path executing the body under the handler stack
        (round-1 semantics: clean-prefix reuse, conservative argdiffs)."""
        primals = Diff.tree_primal(argdiffs)
        from ..generative.concepts import python_closure_mismatch
        from .staged_edit import source_changed_flags

        unchanged = (
            Diff.static_check_no_change(argdiffs)
            and not any(
                source_changed_flags(self.source, trace.get_gen_fn().source)
            )
            and not python_closure_mismatch(
                trace.get_gen_fn().source, self.source
            )
        )
        if isinstance(request, Update):
            h: EditHandler = UpdateHandler(key, trace, request.constraint, unchanged)
        elif isinstance(request, Regenerate):
            h = RegenerateHandler(key, trace, request.selection, unchanged)
        else:
            h = StaticRequestHandler(key, trace, request, unchanged)
        retval = self.run(h, primals)
        new_tr = StaticTrace(
            self, primals, retval, tuple(h.subtraces), tuple(h.addresses)
        )
        # if the whole body stayed on the clean path (args unchanged, every
        # sub-request trivial), the deterministic body reproduced the old
        # retval exactly
        retdiff = (
            Diff.tree_diff_no_change(retval)
            if h.clean
            else Diff.tree_diff_unknown_change(retval)
        )
        return new_tr, h.weight, retdiff, h.bwd_request()

    # ----- ergonomics -----

    def partial_apply(self, *args) -> "StaticGenerativeFunction":
        """Pre-apply leading arguments (reference static.py:1011)."""
        inner = self.source
        return StaticGenerativeFunction(
            Closure((*inner.dyn_args, *args), inner.fn)
        )

    def handle_kwargs(self) -> "StaticGenerativeFunction":
        # The inner Closure rides as a *dynamic* closed-over value so its
        # captured state stays in the pytree (tracers keep tracing), and the
        # wrapper fn is a module-level function so treedefs stay equal
        # across calls (no jit retraces).
        return StaticGenerativeFunction(Closure((self.source,), _kwargs_call))

    def inline(self, *args):
        """Splice this function's body into an enclosing ``@gen`` body,
        without introducing a new address level."""
        return self.source(*args)

    def __get__(self, instance, _owner):
        if instance is None:
            return self
        return self.partial_apply(instance)


def _maybe_validate_constraint(gen_fn, constraint: ChoiceMap, args, what: str):
    """Under ``do_checkify()``: reject constraints whose addresses the model
    never samples (VERDICT round-1 item 2; reference choice_map.py:699-749).

    Statically-present extras raise ``ChoiceMapInvalidAddress`` at trace
    time; dynamically-conditioned extras (masked/switched) stage a
    ``jax.experimental.checkify`` check. Validation runs only at the top of
    a GFI entry — not inside an enclosing body execution, and not under a
    combinator that legitimately fans a constraint across heterogeneous
    branches (``suppress_constraint_validation``).
    """
    from ..checkify import constraint_validation_active
    from ..core.handlers import active_handler

    if not constraint_validation_active():
        return
    if active_handler() is not None:
        return  # nested addressed call: the submap was already scoped
    if constraint.static_is_empty():
        return
    from ..generative.choice_map import ChoiceMapInvalidAddress, exists_flag

    extras = constraint.invalid_subset(gen_fn, args)
    if extras is None:
        return
    flag = exists_flag(extras)
    from ..core.staging import FlagOp

    if FlagOp.concrete_true(flag):
        raise ChoiceMapInvalidAddress(
            f"{what}: constraint contains addresses the model never "
            f"samples: {extras}"
        )
    if not FlagOp.concrete_false(flag):
        import jax.experimental.checkify as cf

        cf.check(
            jnp.logical_not(jnp.asarray(flag)),
            f"{what}: constraint addresses not present in the model",
        )


def _assemble_update_bwd(bwd: dict) -> Update:
    """Collect per-address backward Updates into one discard choice map
    (the reference's discard semantics, static.py:855-865)."""
    acc = ChoiceMap.empty()
    for addr, req in bwd.items():
        if isinstance(req, Update) and not req.constraint.static_is_empty():
            path = addr if isinstance(addr, tuple) else (addr,)
            acc |= req.constraint.extend(*path)
    return Update(acc)


def trace(addr, gen_fn, args: tuple = ()):
    """The trace intrinsic in function form (reference static.py:175):
    ``trace(addr, gen_fn, args)`` is ``gen_fn(*args) @ addr``."""
    from ..core.handlers import dispatch_trace

    return dispatch_trace(addr, gen_fn, args)


def _kwargs_call(inner: Closure, args: tuple, kwargs: dict):
    return inner(*args, **kwargs)


def gen(fn: Callable) -> StaticGenerativeFunction:
    """Decorator: a Python function with addressed calls becomes a
    ``StaticGenerativeFunction`` (reference static.py:1044).

    Addressed calls (``dist(args) @ "addr"`` or ``gen_fn(args) @ "addr"``)
    record random choices; everything else is ordinary traced JAX:

    >>> import jax
    >>> import genjax_tpu as g
    >>> @g.gen
    ... def pair(shift):
    ...     x = g.normal(shift, 1.0) @ "x"
    ...     return x + shift
    >>> @g.gen
    ... def model():
    ...     a = pair(1.0) @ "sub"       # generative functions nest
    ...     b = g.flip(0.5) @ "b"
    ...     return a
    >>> tr = model.simulate(jax.random.key(0), ())
    >>> chm = tr.get_choices()
    >>> bool(jax.numpy.isclose(tr.get_retval(), chm["sub", "x"] + 1.0))
    True
    >>> chm["b"].dtype.name
    'bool'
    """
    if isinstance(fn, Closure):
        closure = fn
    else:
        closure = Closure((), fn)
    return StaticGenerativeFunction(closure)
