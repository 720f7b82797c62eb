"""Trace-time effect-handler dispatch for the ``@gen`` language.

This is the replacement for the reference's stateful Jaxpr
interpreter (``/root/reference/src/genjax/_src/core/compiler/interpreters/
stateful.py`` :32-99 and the ``trace_p`` primitive machinery in
``static.py`` :156-252).

Design rationale: the reference stages the model to a Jaxpr and re-interprets
it per GFI method, dispatching ``trace_p`` equations to a mutable handler. The
net effect under ``jit`` is identical to dispatching the addressed call at
Python-trace time through a handler stack — but the handler stack avoids a
Jaxpr round-trip per GFI call, keeps arbitrary Python structure in models
(dicts, dataclasses) without flatten/unflatten, and produces exactly the same
XLA program. The hot loop the interpreter represented runs once at trace time
either way; everything after that is compiled.
"""

from __future__ import annotations

import abc
from typing import Any

_HANDLER_STACK: list["TraceHandler"] = []


class GenJAXError(Exception):
    pass


class AddressReuse(GenJAXError):
    """An address was traced twice in one generative function body.

    Parity: reference ``AddressReuse`` (static.py:139).
    """


class MissingAddress(GenJAXError):
    """``assess``/``generate`` required a constraint that was not provided.

    Parity: reference ``MissingAddress`` (static.py:147).
    """


class NotTracedError(GenJAXError):
    """An ``@ addr`` binding executed outside any GFI method."""


class TraceHandler(abc.ABC):
    """Receives each addressed generative-function call in a model body."""

    @abc.abstractmethod
    def handle_trace(self, addr: Any, gen_fn: Any, args: tuple) -> Any:
        """Process one ``gen_fn(*args) @ addr`` binding; returns the retval."""

    def handle_cache(self, addr: Any, fn: Any, args: tuple) -> Any:
        """Process a cached deterministic computation (default: just call)."""
        return fn(*args)


def push_handler(h: TraceHandler) -> None:
    _HANDLER_STACK.append(h)


def pop_handler() -> TraceHandler:
    return _HANDLER_STACK.pop()


def active_handler() -> TraceHandler | None:
    return _HANDLER_STACK[-1] if _HANDLER_STACK else None


class handle:
    """Context manager installing a handler for the dynamic extent of a model
    body execution."""

    def __init__(self, handler: TraceHandler):
        self.handler = handler

    def __enter__(self):
        push_handler(self.handler)
        return self.handler

    def __exit__(self, *exc):
        popped = pop_handler()
        assert popped is self.handler
        return False


def dispatch_trace(addr: Any, gen_fn: Any, args: tuple) -> Any:
    h = active_handler()
    if h is None:
        raise NotTracedError(
            f"Address binding {addr!r} executed outside a generative function "
            "interpretation. Addressed calls (`gen_fn(args) @ addr`) only make "
            "sense inside a @gen body run through the GFI."
        )
    return h.handle_trace(addr, gen_fn, args)


def dispatch_cache(addr: Any, fn: Any, args: tuple) -> Any:
    h = active_handler()
    if h is None:
        raise NotTracedError(f"cache({addr!r}, ...) executed outside a @gen body.")
    return h.handle_cache(addr, fn, args)


# Reference-parity aliases: the reference's StatefulHandler/stateful
# (compiler/interpreters/stateful.py:32/:89) correspond to the handler
# stack here — TraceHandler receives addressed calls, `handle` installs one
# for the dynamic extent of a model-body execution.
StatefulHandler = TraceHandler
stateful = handle
