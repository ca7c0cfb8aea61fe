"""The program's own spans and counters, on the profiler's clock.

Off by default, and then a span is one shared null context and a count
returns at once: nothing is allocated, no clock is read, nothing is
kept. Tracing is on while :func:`enable` holds or while a
``torch.profiler`` is started anywhere in the process (the profiler
module's process-wide flag; ``torch.autograd._profiler_enabled()`` reads
only the calling thread's state, and the server's threads do the work
while the profiler runs on another). :func:`refresh` reads that state
into a module bool: ``Engine.step`` calls it once a step and the
server's loops once a pass.

A span record (:class:`Record`) holds the name, the thread's ident,
the host start and end in ``time.time_ns()`` nanoseconds (the clock of
the profiler's events), the name of the span open on that thread when it
began, and with ``device=True`` the device milliseconds between two CUDA
timing events recorded at entry and exit on the stream current at entry
(a device span inside another: on that one's stream), or None on a CPU
tensor path, where the caller passes ``device=False``. The events come
from a pool; a record's are read by ``event.query()`` when a later
outermost device span begins, and by :func:`records`, which
synchronises first: nothing on the hot path waits for the card. Spans
are not profiler ranges, which the profiler would put on the device's
timeline as annotations; the device sees only the event records.

Counters (:func:`count`) count only while tracing is on. A count that
lives on the device (:func:`tally`: a member count the host never reads
in a step) is summed there, and :func:`counters` reads the sum. At most
MAX_RECORDS records are kept: past that the oldest drop, and the counter
``trace.dropped`` says how many.

    with trace.span("pm.solve", device=rho.is_cuda):
        ...
    trace.count("server.frames_sent")
    if trace.on():
        trace.tally("pmx.members", n_members)
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

#: Records kept (a 20 s window of 1M PM steps holds ~40k).
MAX_RECORDS = 200_000


class Record(NamedTuple):
    name: str
    thread: int                 # threading.get_ident() of the span
    start_ns: int               # time.time_ns() at entry
    end_ns: int                 # time.time_ns() at exit
    parent: Optional[str]       # the span open on the thread at entry
    device_ms: Optional[float]  # CUDA event time, device=True spans only


_on = False                 # tracing is on (read by refresh)
_enabled = False            # enable() holds
_lock = threading.Lock()    # guards everything below
_local = threading.local()  # .stack: names of the thread's open spans
_done: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_pending: collections.deque = collections.deque()  # device events unread
_pool: list = []            # free CUDA timing events
_counts: collections.Counter = collections.Counter()
_tallies: dict = {}         # name -> int64 0-d sum on the tally's device


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


def _resolve(sp: "_Span") -> None:
    """Read a finished span's device time and free its events (lock
    held)."""
    start, end = sp.events
    sp.device_ms = start.elapsed_time(end)
    _pool.extend(sp.events)
    sp.events = None
    if sp.on_device is not None:
        sp.on_device(sp.device_ms)


def _poll() -> None:
    """Resolve the unread spans whose end events have completed. When the
    newest one's has, so have those of the older ones on its stream
    (recorded there before it): one query reads them all."""
    if not _pending:
        return
    newest = _pending[-1]
    if newest.events[1].query():
        later = [sp for sp in _pending if sp.stream != newest.stream]
        for sp in _pending:
            if sp.stream == newest.stream:
                _resolve(sp)
        _pending.clear()
        _pending.extend(later)
        return
    while _pending and _pending[0].events[1].query():
        _resolve(_pending.popleft())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "thread", "parent", "start_ns", "end_ns",
                 "device_ms", "events", "stream", "on_device")

    def __init__(self, name, device, on_device):
        self.name, self.on_device = name, on_device
        self.device_ms = self.events = self.stream = None
        if not device:
            return
        # a device span inside another times on its stream; the outermost
        # one reads the current stream and the events that are done
        outer = next((sp for sp in reversed(_stack())
                      if sp.events is not None), None)
        with _lock:
            if outer is None:
                self.stream = torch.cuda.current_stream()
                _poll()
            else:
                self.stream = outer.stream
            self.events = (_event(), _event())

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.thread = threading.get_ident()
        if self.events is not None:
            self.events[0].record(self.stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        with _lock:
            if self.events is not None:
                # under the lock: _pending holds the spans in the order
                # their end events reach the stream, which _poll relies on
                self.events[1].record(self.stream)
                _pending.append(self)
            self.end_ns = time.time_ns()
            if len(_done) == _done.maxlen:
                _counts["trace.dropped"] += 1
            _done.append(self)
        return False

    def record(self) -> Record:
        return Record(self.name, self.thread, self.start_ns, self.end_ns,
                      self.parent, self.device_ms)


def refresh() -> bool:
    """Read whether tracing is on (enable(), or a started profiler) into
    the module's flag; -> it."""
    global _on
    _on = _enabled or _profiler._is_profiler_enabled
    return _on


def enable() -> None:
    global _enabled
    _enabled = True
    refresh()


def disable() -> None:
    global _enabled
    _enabled = False
    refresh()


def span(name: str, device: bool = False,
         on_device: Optional[Callable[[float], None]] = None):
    """A context manager that records the enclosed block as span ``name``
    while tracing is on; ``device``: also its device time on the current
    CUDA stream, passed to ``on_device`` when it is read. Off: the shared
    null context."""
    if not _on:
        return _NULL
    return _Span(name, device, on_device)


def on() -> bool:
    """Whether tracing is on (as the last :func:`refresh` read it): a
    caller computes what it would :func:`tally` only then."""
    return _on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counts[name] += n


def tally(name: str, value: torch.Tensor) -> None:
    """Add the device scalar ``value`` to counter ``name`` while tracing
    is on, on the device: nothing is read back until :func:`counters`."""
    if not _on:
        return
    with _lock:
        acc = _tallies.get(name)
        if acc is None:
            _tallies[name] = value.detach().to(torch.int64).clone()
        else:
            acc.add_(value)


def records(t0_ns: int = 0, t1_ns: Optional[int] = None) -> list:
    """The finished spans that overlap [t0_ns, t1_ns] (time.time_ns()), as
    :class:`Record`, in the order they ended. Waits for the card first
    when a span's device time is unread."""
    with _lock:
        if _pending:
            torch.cuda.synchronize()
            while _pending:
                _resolve(_pending.popleft())
        done = list(_done)
    return [sp.record() for sp in done
            if sp.end_ns >= t0_ns and (t1_ns is None or sp.start_ns <= t1_ns)]


def counters() -> dict:
    """The counts, with the device tallies read (a synchronisation when
    there are any)."""
    with _lock:
        return {**_counts, **{k: int(v) for k, v in _tallies.items()}}


def reset() -> None:
    """Forget every record, count and pooled event (unread device times
    are dropped)."""
    with _lock:
        _done.clear()
        _pending.clear()
        _pool.clear()
        _counts.clear()
        _tallies.clear()
