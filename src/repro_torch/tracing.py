"""Spans and counters inside the port, recorded only on request.

    from repro_torch import tracing
    with tracing.recording() as rec:
        params, opt, m = step(params, opt, batch)
    rec.spans      # [(name, parent, thread, start_ns, end_ns), ...]
    rec.counters   # {name: int}, read once when recording ends

:func:`span` marks a phase of the host's work by name; :func:`count` adds
to a named counter.  Both check one module-level flag first: while
nothing records, which is the default, a span allocates nothing, reads
no clock and touches no device, and a count does nothing.  Only
:func:`recording` turns recording on; no variable of the environment
and no flag of a command does.

A span's times are ``time.perf_counter_ns()``.  Its ``parent`` is the
index in ``spans`` of the innermost span open on the same thread, or,
where none is open there, of the innermost span open on the thread that
started recording (-1 where there is none): the backward pass on a card
runs on autograd's own thread, and a remat recompute's spans land under
the span around ``torch.autograd.grad``.  ``threads`` maps each
recording thread's ``threading.get_ident()`` to its native id.

A count takes an ``int`` (summed on the host) or a 0-d tensor (summed on
its device, never read before recording ends; a DTensor is made whole).
A counter of forward work is guarded by :func:`counting`, which is also
false while autograd's engine runs, so that a remat recompute does not
count it again and its tensor work runs only while recording.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from repro_torch.core.sharding import whole

_active: Record | None = None     # the recording in progress
_OFF = contextlib.nullcontext()


class Record:
    """What one recording holds: ``spans`` (a span open when recording
    ended has ``end_ns`` None), ``threads`` and, once it has ended,
    ``counters``."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.threads: dict[int, int] = {}
        self.counters: dict[str, int] = {}
        self.thread = threading.get_ident()
        self._open: dict[int, list[int]] = {}
        self._host: dict[str, int] = {}
        self._device: dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    def _enter(self, name: str) -> int:
        t = threading.get_ident()
        with self._lock:
            stack = self._open.setdefault(t, [])
            if t not in self.threads:
                self.threads[t] = threading.get_native_id()
            outer = stack or self._open.get(self.thread) or [-1]
            i = len(self.spans)
            self.spans.append((name, outer[-1], t, time.perf_counter_ns(),
                               None))
            stack.append(i)
        return i

    def _exit(self, i: int) -> None:
        end = time.perf_counter_ns()
        with self._lock:
            name, parent, t, start, _ = self.spans[i]
            self.spans[i] = (name, parent, t, start, end)
            self._open[t].remove(i)

    def _count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = whole(value.detach())
            with self._lock:
                acc = self._device.get(name)
                self._device[name] = value if acc is None else acc + value
        else:
            with self._lock:
                self._host[name] = self._host.get(name, 0) + int(value)

    def _close(self) -> None:
        """The counters, each device sum read once (a meta tensor, which
        holds no value, is kept as it is)."""
        out = dict(self._host)
        for name, t in self._device.items():
            out[name] = t if t.is_meta else out.get(name, 0) + int(t)
        self.counters = out


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec._enter(self.name)

    def __exit__(self, *exc):
        self.rec._exit(self.i)


def span(name: str):
    """A context that records span ``name`` while recording is on."""
    rec = _active
    return _OFF if rec is None else _Span(rec, name)


def count(name: str, value) -> None:
    """Add ``value`` (an int or a 0-d tensor) to counter ``name`` while
    recording is on."""
    rec = _active
    if rec is not None:
        rec._count(name, value)


def counting() -> bool:
    """Recording is on and autograd's engine is not running on this
    thread: a forward counter counts now."""
    return _active is not None and torch._C._current_graph_task_id() == -1


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the ``with`` block; yields the
    :class:`Record`, whose ``counters`` are read when the block ends."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing is already recording")
    rec = _active = Record()
    try:
        yield rec
    finally:
        _active = None
        rec._close()
