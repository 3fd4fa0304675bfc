"""Spans at the port's layer boundaries: the one place they are recorded.

``span(name)`` is a context manager put around a layer's call (the serving
call, its upload, each net, the phases of a train step). Tracing is off
unless ``enable()`` turns it on:

- off, ``span`` tests one module-level flag and returns a shared inert
  context: nothing is recorded or allocated;
- on, each span records a ``Span`` (name, its id, the call id, its parent's
  id, the thread, start and end on ``time.perf_counter_ns``) into an
  in-memory list that ``drain()`` hands over and empties, and enters
  ``torch.profiler.record_function(name)``, so a profiler's trace shows the
  span under its name. A span with no open span around it on its thread is
  a root: its id is the call id that every span inside it carries.

While ``torch.compiler.is_compiling()`` (``torch.export`` of the serving
forward, ``torch.compile``) a span is inert whether tracing is on or off,
so no graph holds it.

``enable()`` also reads the host clocks back to back (the tightest of a few
pairs): ``offset_ns()`` maps a span's ``perf_counter_ns`` reading onto the
wall clock, the timeline of an exported ``torch.profiler`` trace
(``ts * 1000 + baseTimeNanoseconds``, in ns).

The spans (the benchmark's ``bench_port/spans.py`` reads them):

- ``serve`` (root): ``MainModel.serve_forward``; ``serve.upload`` inside it,
  the two host-to-device copies of the request;
- ``net.<name>``: each net's call (``ServingForward``, ``BaseModel.run_net``,
  the translators in ``MainModel._forward_all`` and
  ``MainSRModel._real_input_depth``); one span for a batched 2B call;
- ``step.stage`` (root): ``BaseModel.set_input`` and the staging of
  ``optimize_parameters_multi``;
- ``step`` (root): ``MainModel.optimize_parameters``, with ``step.forward``
  (``step.holes`` inside it), ``step.losses``, ``step.backward`` (autograd
  issues the backward's launches from its own thread while this one waits
  here) and ``step.optimizer``;
- ``train_step`` and ``device_finish``: the train CLI's loop, under
  ``--profile_dir`` (which turns tracing on for its window).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    id: int
    call: int  # the id of the root span it lies in (its own for a root)
    parent: int | None  # the id of the span open around it on its thread
    thread: int  # threading.get_ident(); its low 32 bits are a launch's ``tid`` in the trace
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


_on = False
_INERT = contextlib.nullcontext()
_ids = itertools.count()
_lock = threading.Lock()
_spans: list[Span] = []
_local = threading.local()
_offset_ns = 0


def span(name):
    """A context manager that records the span ``name`` while tracing is on."""
    if not _on:
        return _INERT
    if torch.compiler.is_compiling():
        return _INERT
    return _Open(name)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "id", "call", "parent", "start", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.call = self.id if outer is None else outer.call
        stack.append(self)
        self.annotation = torch.profiler.record_function(self.name)
        self.start = time.perf_counter_ns()
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end = time.perf_counter_ns()
        _stack().pop()
        done = Span(self.name, self.id, self.call, self.parent, threading.get_ident(),
                    self.start, end)
        with _lock:
            _spans.append(done)
        return False


def _clock_offset(pairs=5):
    """wall ns - perf_counter ns, from the tightest of ``pairs`` readings."""
    best = None
    for _ in range(pairs):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + p1) // 2)
    return best[1]


def enable():
    """Turn tracing on and read the clocks' offset."""
    global _on, _offset_ns
    _offset_ns = _clock_offset()
    _on = True


def disable():
    """Turn tracing off; spans still open record when they close."""
    global _on
    _on = False


def offset_ns():
    """What to add to a span's ``start_ns`` / ``end_ns`` for the wall clock
    (``time.time_ns``), as read by the last ``enable()``."""
    return _offset_ns


def drain():
    """The spans recorded so far, in the order they opened; the list empties."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return sorted(out, key=lambda s: s.id)
