"""Tracing from the benchmark's side, for ``--trace 1`` runs.

* Spans: :class:`Spans` wraps functions of the program at run time.  A
  wrapped call records its host interval, and (``device=True``) launches
  one marker kernel (``torch.cuda._sleep(0)``, ATen's ``spin_kernel``)
  before and after it, so that the device events between a pair of
  markers, on the one stream the program uses, are the call's device work.
  Recorders beside a span keep what the call's work is counted from (its
  shapes, or device tensors such as a decode's ``kv_len``, read only
  after the slice).
* The slice: :func:`profile_slice` runs ``torch.profiler`` over device
  activity only and reads the raw kineto events in memory (the
  profiler's per-operator tables take minutes at ~10^5 launches); no
  trace file is written.
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict

MARKER = "spin_kernel"


class Spans:
    def __init__(self, torch):
        self.torch = torch
        self.active = False
        self.host: list[tuple[str, int, int]] = []   # (name, start, end) ns
        self.order: list[str] = []                   # device span per pair
        self.records: dict[str, list] = defaultdict(list)
        self._undo: list = []

    def marker(self):
        self.torch.cuda._sleep(0)

    def wrap(self, module, attr: str, name: str, *, device: bool = True,
             record=None):
        """Replace ``module.attr`` by a wrapper that records span ``name``
        (and calls ``record(args, kwargs, result)`` while active)."""
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not self.active:
                return fn(*a, **kw)
            t0 = time.perf_counter_ns()
            if device:
                self.marker()
            try:
                out = fn(*a, **kw)
            finally:
                if device:
                    self.marker()
                    self.order.append(name)
                self.host.append((name, t0, time.perf_counter_ns()))
            if record is not None:
                record(a, kw, out)
            return out
        setattr(module, attr, wrapper)
        self._undo.append((module, attr, fn))

    def host_span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter_ns()

            def __exit__(self, *exc):
                if spans.active:
                    spans.host.append((name, self.t0, time.perf_counter_ns()))
        return _Span()

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


class Slice:
    """What a traced slice gave: device busy seconds, the slice's length,
    device seconds by kernel name and by span, and idle gaps."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: dict[str, list] = {}       # name -> [seconds, count]
        self.span_s: dict[str, float] = defaultdict(float)
        self.span_calls: dict[str, int] = defaultdict(int)
        self.gaps: list[tuple[float, str]] = []  # (seconds, host span)


def warm(torch):
    """Start and stop the profiler once, in set-up: its first start
    initialises CUPTI, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(0)
        torch.cuda.synchronize()


def profile_slice(torch, spans: Spans, body):
    """Run ``body()`` under the profiler with ``spans`` active; returns a
    :class:`Slice`.  The host and device clocks are tied by one marker
    launched on an idle device at the slice's start."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_cal = time.perf_counter_ns()
        spans.marker()
        torch.cuda.synchronize()
        spans.active = True
        t0 = time.perf_counter_ns()
        try:
            body()
            torch.cuda.synchronize()
        finally:
            spans.active = False
        t1 = time.perf_counter_ns()
    events = sorted(((e.name(), e.start_ns(), e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA")),
                    key=lambda e: e[1])
    return reduce_events(events, spans, t_cal, t0, t1)


def reduce_events(events, spans: Spans, t_cal: int, t0: int, t1: int):
    """``events``: (name, start_ns, duration_ns) of the device, sorted by
    start; the first marker is the clock tie launched at host time
    ``t_cal``; the rest pair up with ``spans.order``."""
    s = Slice()
    markers = [e for e in events if MARKER in e[0]]
    if not markers:
        raise RuntimeError("profiler trace holds no marker kernel: the "
                           "device activity was not traced")
    offset = markers[0][1] - t_cal          # device ns = host ns + offset
    lo, hi = t0 + offset, t1 + offset
    kern = defaultdict(lambda: [0.0, 0])
    inside: str | None = None
    pairs = iter(spans.order)
    opened = None
    last_end, busy = lo, 0
    host = sorted(spans.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = []
    for name, start, dur in events[1:]:
        if MARKER in name:
            if inside is None:
                inside = opened = next(pairs, "?")
            else:
                s.span_calls[opened] += 1
                inside = None
            continue
        end = start + dur
        if end <= lo or start >= hi:
            continue
        start, end = max(start, lo), min(end, hi)
        k = kern[name]
        k[0] += (end - start) / 1e9
        k[1] += 1
        if inside is not None:
            s.span_s[inside] += (end - start) / 1e9
        if start > last_end:
            gaps.append((last_end, start))
        busy += max(0, end - max(start, last_end))
        last_end = max(last_end, end)
    if hi > last_end:
        gaps.append((last_end, hi))
    s.window_s = (t1 - t0) / 1e9
    s.busy_s = busy / 1e9
    s.kernels = dict(kern)
    s.gaps = [((b - a) / 1e9, _host_label(host, starts, a - offset))
              for a, b in gaps]
    return s


def _host_label(host, starts, t_host: int, look_back: int = 256) -> str:
    """The innermost host span open at ``t_host`` (the latest started of
    those that cover it, among the ``look_back`` latest started before
    it), or ``harness``."""
    i = bisect.bisect_right(starts, t_host)
    for name, a, b in reversed(host[max(0, i - look_back):i]):
        if b >= t_host:
            return name
    return "harness"


def breakdown(sl: Slice) -> dict:
    """The ten device operations that took most time, and the idle time
    by what the host was doing, each as [name, seconds]."""
    ops = sorted(((n[:120], v[0]) for n, v in sl.kernels.items()),
                 key=lambda x: -x[1])[:10]
    idle = defaultdict(float)
    for sec, label in sl.gaps:
        idle[label] += sec
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in gaps]}
