"""The port's tracing: named spans at its layer boundaries, off by default,
and host counters, always on.

``span(name)`` is a ``torch.profiler.record_function`` range while
tracing is on (``enable(True)``), so a span lands in the profiler's trace
beside the device activities its layer launched, on the trace's clock.
While tracing is off it costs one flag check and returns one shared null
context. ``spanned(name)`` puts a function's every call inside
``span(name)``. ``count(name, n)`` adds to ``COUNTS``, plain host
integers: no span or counter reads a device value, so none synchronises.

The span names are fixed and dotted (``physics.fk``, ``env.step``,
``ppo.update``, ...; PERF.md lists each with its code site). Which spans
belong to which layer is for the reader of the trace to decide.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

COUNTS: collections.Counter = collections.Counter()

_on = False
_NULL = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn spans on or off for the whole process."""
    global _on
    _on = bool(on)


def span(name: str, args: str | None = None):
    """A context manager: a profiler range named `name` (with the string
    `args` attached) while tracing is on, else the shared null context."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(name, args)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n
