"""The port's spans: where the program's host time goes, on the profiler's
clock.

    with trace.span("dsc_block") as rec:     # rec None when off
        if rec is not None:
            rec.args["B"] = x.shape[0]         # args only when on
        ...

A span records only while a torch profile is running
(``torch.profiler.profile`` or ``torch.autograd.profiler.profile``, any
activities): that is how an operator asks for spans, and there is no other
switch. Off, ``span`` reads one flag and returns a shared null context.

On, a span enters ``_RecordFunctionFast("repro_torch::<name>")``, so that it
lies in the profiler's trace as a host event (with no device-side range:
that takes a span of the user scope, which costs twice as much), and keeps
a record in memory: its name, ``time.time_ns()`` stamps taken just outside
the event (the clock the profiler stamps host events on), the index of the
enclosing span and its args. A record is kept as six numbers and strings
(its args as their ``repr``), objects the garbage collector does not count,
so that a profiled window allocates no more of what it counts with spans
than without: records it counted made it pause for tenths of a second in a
profiled window. ``records()`` returns them as ``Record``s. The store keeps
the newest ``CAP`` records. Spans read no tensor and launch nothing:
outputs are the same bit for bit with a profile running and without.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import itertools
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch::"
CAP = 1 << 20                   # records kept, the newest


class _Off:
    """The one context every span returns while no profile runs."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()

# index, name, start_ns, end_ns, parent (-1: none), repr(args) ('' if none)
_FIELDS = 6
_store: collections.deque = collections.deque(maxlen=_FIELDS * CAP)
_index = itertools.count()
_local = threading.local()


@dataclasses.dataclass
class Record:
    """One span as it ran."""

    index: int                  # order of entry, over the whole process
    name: str
    start_ns: int               # time.time_ns() before the event began
    end_ns: int                 # ... after it ended
    parent: Optional[int]       # index of the enclosing span
    args: dict


def span(name: str):
    """A context manager that records ``name`` while a profile runs. Its
    ``as`` target, None when off, holds the span's ``index`` and its
    ``args``, a dict the body fills: numbers, strings, booleans and tuples
    of them. Args are given there, never as keyword arguments of ``span``,
    whose dict would cost every call."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("index", "name", "parent", "args", "start_ns", "fn")

    def __init__(self, name: str):
        stack = _stack()
        self.index = next(_index)
        self.name = name
        self.parent = stack[-1] if stack else None
        self.args = {}
        self.fn = torch._C._profiler._RecordFunctionFast(PREFIX + name)

    def __enter__(self) -> "_Span":
        _stack().append(self.index)
        self.start_ns = time.time_ns()
        self.fn.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.fn.__exit__(*exc)
        _store.extend((self.index, self.name, self.start_ns, time.time_ns(),
                       -1 if self.parent is None else self.parent,
                       repr(self.args) if self.args else ""))
        _stack().pop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def records(name: Optional[str] = None) -> List[Record]:
    """The records kept, in order of entry (only ``name``'s, if given)."""
    flat = list(_store)
    out = []
    for i in range(0, len(flat), _FIELDS):
        index, n, start, end, parent, args = flat[i:i + _FIELDS]
        if name is None or n == name:
            out.append(Record(index, n, start, end,
                              None if parent < 0 else parent,
                              ast.literal_eval(args) if args else {}))
    out.sort(key=lambda r: r.index)
    return out


def clear() -> None:
    """Forget every record kept."""
    _store.clear()
