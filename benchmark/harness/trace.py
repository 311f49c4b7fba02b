"""Tracing of a ``--trace 1`` run, from the benchmark's own files.

Host spans come from wrappers that the metric readers install around the
program's module attributes (:meth:`Tracer.patch`), only in the traced run
and only for the window; each span is (name, start ns, end ns) on the
``time.perf_counter_ns`` clock.  Device operations come from
``torch.profiler`` over the window: the kernels, copies and memsets, put on
the same clock by a reading of both clocks at the window's start.

:class:`Trace` is what a metric reader reads: the window, the spans, the
records the wrappers kept, and the device operations clipped to the
window.  Busy time is the union of the device intervals, so a copy that
overlaps a kernel counts once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from . import families


class Tracer:
    """Spans and records of the traced run, and the patches that make them."""

    def __init__(self):
        self.spans: list = []           # (name, t0 ns, t1 ns)
        self.records: dict = {}         # name -> list of values
        self._patches: list = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.spans.append((name, t0, t1))

    def record(self, name: str, value) -> None:
        self.records.setdefault(name, []).append(value)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns())

    def patch(self, owner, attr: str, make) -> None:
        """Replace ``owner.attr`` by ``make(original)`` until
        :meth:`restore`."""
        orig = getattr(owner, attr)
        self._patches.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def wrap_span(self, owner, attr: str, name: str) -> None:
        """Record a span ``name`` around every call of ``owner.attr``."""
        def make(orig):
            def wrapped(*a, **kw):
                with self.span(name):
                    return orig(*a, **kw)
            return wrapped
        self.patch(owner, attr, make)

    def restore(self) -> None:
        while self._patches:
            owner, attr, orig = self._patches.pop()
            setattr(owner, attr, orig)


class DeviceProfile:
    """torch.profiler over the window, CUDA activity only (the device's
    kernels, copies and memsets, and the CUDA runtime calls of the host):
    recording every host operator as well would slow the host enough to
    change the idle share it measures.  The profiler's timestamps are on
    the wall clock; :meth:`mark`, at the window's start, reads the wall
    clock and the perf_counter clock together, and :meth:`events` moves
    the events onto the latter."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.offset = 0                 # wall ns - perf_counter ns

    def start(self) -> None:
        self.prof.__enter__()

    def mark(self) -> None:
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        self.offset = w - (a + b) // 2

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def events(self):
        """(device ops [(name, t0, t1)], host runtime calls {name: [calls,
        ns]}) on the perf_counter clock."""
        from torch.autograd import DeviceType
        evs = self.prof.profiler.kineto_results.events()
        offset = self.offset
        dev, host = [], {}
        for e in evs:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), e.start_ns() - offset,
                            e.end_ns() - offset))
            else:
                h = host.setdefault(e.name(), [0, 0])
                h[0] += 1
                h[1] += e.duration_ns()
        return dev, host


def union(intervals):
    """Merged [(t0, t1)] of the given intervals, sorted."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Trace:
    """What a per-layer metric reads (times in ns on one clock)."""
    t0: int
    t1: int
    jobs: int
    spans: list
    records: dict
    device: list            # (family, name, t0, t1), clipped to the window

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def span_s(self, name: str) -> float:
        """Seconds of the window inside spans ``name`` (overlaps once)."""
        iv = [(max(a, self.t0), min(b, self.t1)) for n, a, b in self.spans
              if n == name and b > self.t0 and a < self.t1]
        return sum(b - a for a, b in union(iv)) / 1e9

    def has_span(self, name: str) -> bool:
        return any(n == name for n, _, _ in self.spans)

    def family_s(self, fams) -> float:
        return sum(b - a for f, _, a, b in self.device if f in fams) / 1e9

    def busy(self) -> list:
        return union([(a, b) for _, _, a, b in self.device])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9


def clip_device(dev_ops, t0: int, t1: int) -> list:
    out = []
    for name, a, b in dev_ops:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((families.family(name), name, a, b))
    return out


def breakdown(trace: Trace):
    """(device_ops, idle_gaps, idle_by_label): the 10 device families that
    took most time; the 10 longest idle gaps of the window, each named by
    the host span open at its middle (the readers' span names, else
    "other"); and the idle seconds summed by that name."""
    labels = sorted({n for n, _, _ in trace.spans})
    fam: dict = {}
    for f, _, a, b in trace.device:
        fam[f] = fam.get(f, 0.0) + (b - a) / 1e9
    ops = sorted(fam.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev = trace.t0
    for a, b in trace.busy() + [[trace.t1, trace.t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    mids = np.array([(a + b) // 2 for a, b in gaps], np.int64)
    name_of = np.full(mids.size, len(labels))
    for li in range(len(labels) - 1, -1, -1):
        iv = sorted((s0, s1) for n, s0, s1 in trace.spans if n == labels[li])
        if not iv:
            continue
        s0 = np.array([a for a, _ in iv], np.int64)
        s1 = np.array([b for _, b in iv], np.int64)
        at = np.searchsorted(s0, mids, side="right") - 1
        inside = (at >= 0) & (s1[np.maximum(at, 0)] > mids)
        name_of[inside] = li
    names = list(labels) + ["other"]
    named = []
    by_label: dict = {}
    for (a, b), li in zip(gaps, name_of):
        label = names[li]
        named.append((label, (b - a) / 1e9))
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
    named.sort(key=lambda g: -g[1])
    return ([[k, v] for k, v in ops], [[k, v] for k, v in named[:10]],
            by_label)
