"""Spans and counters inside the program, off unless a sink is set.

``sink`` is the operator's way in: any object with ``add(name, t0_ns,
t1_ns)`` and ``record(name, value)``.  While it is ``None`` (the default),
:func:`span` returns one shared null context: it reads no clock, records no
CUDA event and allocates nothing.  Once it is set, every span

* reads ``time.perf_counter_ns()`` at open and at close and calls
  ``sink.add(name, t0, t1)`` (the host's time inside the span);
* given a CUDA ``device``, also records a timing ``torch.cuda.Event`` on
  the device's current stream at open and at close and calls
  ``sink.record(name, (work, ev_open, ev_close))``: once both events have
  completed, ``ev_open.elapsed_time(ev_close)`` is the stage's interval on
  the stream, which starts when the work queued before it ends.

``after`` is the span (the value of its ``with ... as``) that closed just
before this one opens, with nothing queued on the stream in between: its
closing event, and its stream, serve as this span's opening ones, which
saves a stream lookup and an event.  A span closes, and reports, when its
body raises too.  ``work`` is the count the stage was handed (the sketch
layer: rows x positions; the count layer's merges: entries in plus
entries out).

:func:`count` hands the sink one reading of a counter of the program
(``sink.record(name, value)``); it too does nothing while ``sink`` is
``None``.
"""

from __future__ import annotations

import contextlib
import time

import torch

sink = None

_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("out", "name", "work", "stream", "t0", "ev", "end")

    def __init__(self, out, name: str, work: int, device, after):
        self.out, self.name, self.work = out, name, work
        self.ev = self.end = None
        if after is not None and after.end is not None:
            self.stream, self.ev = after.stream, after.end
        elif device is not None and device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
        else:
            self.stream = None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if self.stream is not None and self.ev is None:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(self.stream)
            self.out.record(self.name, (self.work, self.ev, self.end))
        self.out.add(self.name, self.t0, time.perf_counter_ns())
        return False


def span(name: str, work: int = 0, device: torch.device | None = None,
         after: _Span | None = None):
    """A context around one stage of the program (see the module
    docstring); the shared null context while ``sink`` is None."""
    if sink is None:
        return _NULL
    return _Span(sink, name, work, device, after)


def count(name: str, value) -> None:
    """One reading of counter ``name`` (``sink.record(name, value)``);
    nothing while ``sink`` is None."""
    if sink is not None:
        sink.record(name, value)
