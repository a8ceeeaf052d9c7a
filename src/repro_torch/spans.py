"""Spans at the port's layer boundaries, recorded while a ``torch.profiler``
runs and free while none does.

    with span("serve.gather"):
        ...

While no profiler is active, ``span`` returns one shared no-op context (the
test is a flag read, ``torch.autograd.profiler._is_profiler_enabled``), so
an untraced serving round or training step pays a call and a read a span.
While one is active, a span opens the profiler's cheap range
(``torch._C._profiler._RecordFunctionFast``, the one compiled code uses:
``torch.profiler.record_function`` costs several times more a span, and
adds a copy on the device's timeline), which puts it on the profiler's
host timeline beside the device's (a trace then names the host's phase
around each idle gap of the card), and keeps a ``Record``: its name, its
start and end on ``time.perf_counter_ns`` and the span it opened inside.

A span given ``device=`` a CUDA device also records a pair of CUDA events
on the current stream around its work; ``records()`` synchronizes once and
turns each pair into the device milliseconds between them. Every other
record's ``ms`` is its host milliseconds (on the CPU the work runs within
the span).

Only the newest ``CAP`` records are kept (a traced stretch of the
benchmark makes a few thousand): each span past it drops the oldest,
counted in ``records().dropped`` until ``clear()``. Spans never read the
serving engine's injectable clock (``serve/clock.py``): a replay on a
``TickClock`` or ``ManualClock`` reads it as often traced as untraced.
"""
from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16     # records kept, the newest


class Record:
    """One span, and while it is open its context manager: ``parent`` is
    the record of the span it opened inside (None at the top); ``end_ns``
    and ``ms`` are None while it is open."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "ms", "_events",
                 "_function", "_stack")

    def __init__(self, name, device):
        self.name = name
        self.parent = self.start_ns = self.end_ns = self.ms = None
        self._events = None
        if device is not None and torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        self._stack = _RECORDER.stack()
        if self._stack:
            self.parent = self._stack[-1]
        _RECORDER.keep(self)
        self._stack.append(self)
        # the profiler's cheap range: a host event of this name on its
        # timeline, and no copy of it on the device's
        self._function = torch._C._profiler._RecordFunctionFast(self.name)
        self._function.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        else:
            self.ms = self.host_ms
        self._stack.pop()
        self._function.__exit__(*exc)
        self._function = self._stack = None
        return None


class Records(list):
    """The kept records in the order their spans opened; ``dropped``
    counts the older ones past the cap."""
    dropped = 0


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()   # each thread's open spans
        self.clear()

    def clear(self):
        with self.lock:
            self.records = collections.deque(maxlen=CAP)
            self.dropped = 0

    def keep(self, record):
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()


def span(name: str, device=None):
    """A span named ``name`` over the ``with`` block: recorded while a
    profiler is active, the shared no-op otherwise. ``device``: the device
    the block's work runs on (a CUDA device adds the event pair)."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return Record(name, device)


def records() -> Records:
    """The records kept since ``clear()``, the device pairs of finished
    spans resolved to milliseconds (one synchronize) and then freed."""
    r = _RECORDER
    with r.lock:
        out = Records(r.records)
        out.dropped = r.dropped
    pending = [x for x in out
               if x._events is not None and x.end_ns is not None]
    if pending:
        torch.cuda.synchronize()
        for x in pending:
            x.ms = x._events[0].elapsed_time(x._events[1])
            x._events = None
    return out


def clear():
    """Drop every record, their event pairs with them, and the count of
    dropped ones (call it with no span open)."""
    _RECORDER.clear()
