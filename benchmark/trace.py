"""Spans around the calls into the program, and the device trace.

Spans are the benchmark's own: in a traced run the harness wraps, on the
instance, the engine's methods that each layer enters (``wrap``) in a
``torch.profiler.record_function`` range named ``bench:<label>``, and
times each call on the host clock; with ``profiled`` off the wrapper only
times the call. The profiler's events are read in
memory (no trace file is written) into a :class:`TraceView`:

  * device operations: every kernel, copy and set on the card, with its
    interval and the span that launched it (the span, on the launching
    thread, that holds the host time of the launch);
  * spans: the ``bench:`` ranges, with their threads and intervals;
  * host operations: the other host events, which name an idle gap where
    no span is open.

The view's arithmetic (the union of the device intervals, the idle gaps,
the attribution) works on plain tuples, so it is tested on synthetic
events without a card.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Iterable, List, NamedTuple, Optional

SPAN_PREFIX = "bench:"


class DeviceOp(NamedTuple):
    name: str
    start: float        # seconds, host clock of the profiler
    end: float
    span: str           # label of the launching span, or "" when none


class HostEvent(NamedTuple):
    name: str
    start: float
    end: float
    thread: int


class Spans:
    """Host spans around the program's methods: a call's host duration
    (kept while ``recording``) and, while ``profiled``, a profiler range
    around it."""

    def __init__(self):
        self.durations = collections.defaultdict(list)
        self.recording = False
        self.profiled = True

    def take(self) -> dict:
        """The durations kept so far, which start again empty."""
        out, self.durations = dict(self.durations), \
            collections.defaultdict(list)
        return out

    def wrap(self, obj, method: str, label: str) -> None:
        import contextlib

        import torch

        orig = getattr(obj, method)

        def spanned(*args, **kwargs):
            with (torch.profiler.record_function(SPAN_PREFIX + label)
                  if self.profiled else contextlib.nullcontext()):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    if self.recording:
                        self.durations[label].append(
                            time.perf_counter() - t0)

        setattr(obj, method, spanned)


def union_length(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[tuple], lo: float, hi: float) -> List[tuple]:
    """(start, end) of the stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class TraceView:
    """The device trace of one traced window [t0, t1]."""

    def __init__(self, ops: List[DeviceOp], spans: List[HostEvent],
                 host: List[HostEvent], t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.ops = [o for o in ops if o.end > t0 and o.start < t1]
        self.spans = [s for s in spans if s.end > t0 and s.start < t1]
        self.host = host
        self._spans_by_start = sorted(self.spans, key=lambda e: e.start)
        self._span_starts = [e.start for e in self._spans_by_start]
        self._host_by_start = sorted(host, key=lambda e: e.start)
        self._host_starts = [e.start for e in self._host_by_start]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_length(((o.start, o.end) for o in self.ops),
                            self.t0, self.t1)

    def idle_pct(self) -> Optional[float]:
        if not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def span_count(self, label: str) -> int:
        return sum(1 for s in self.spans if s.name == label)

    def device_time(self, span: Optional[str] = None,
                    patterns: Iterable[str] = ()) -> tuple:
        """(seconds, count) of the device operations launched inside
        ``span`` (any span when None) whose name matches one of
        ``patterns`` (every name when empty)."""
        regs = [re.compile(p) for p in patterns]
        secs, count = 0.0, 0
        for o in self.ops:
            if span is not None and o.span != span:
                continue
            if regs and not any(r.search(o.name) for r in regs):
                continue
            secs += o.end - o.start
            count += 1
        return secs, count

    def top_ops(self, k: int = 10) -> list:
        """[span/name, seconds] of the k device operations with the most
        time in the window."""
        tot = collections.Counter()
        for o in self.ops:
            tot[f"{o.span or 'no span'}/{o.name}"] += o.end - o.start
        return [[name, secs] for name, secs in tot.most_common(k)]

    def _host_label(self, t: float) -> str:
        """The innermost span open at ``t`` on any thread, else the
        innermost host event (the latest started that is still open),
        else "host idle"."""
        for group, starts in ((self._spans_by_start, self._span_starts),
                              (self._host_by_start, self._host_starts)):
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 20000, -1), -1):
                if t < group[j].end:
                    return group[j].name
        return "host idle"

    def top_gaps(self, k: int = 10) -> list:
        """[host label, seconds] of the k longest idle gaps of the card in
        the window, each named by what the host was in at its middle."""
        gs = sorted(gaps(((o.start, o.end) for o in self.ops), self.t0,
                         self.t1), key=lambda g: g[0] - g[1])[:k]
        return [[self._host_label(0.5 * (s + e)), e - s] for s, e in gs]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.top_gaps()}


def build_view(device_ops: list, launches: dict, spans: List[HostEvent],
               host: List[HostEvent], t0: float, t1: float) -> TraceView:
    """A TraceView from raw records: ``device_ops`` (name, start, end,
    launch key), ``launches`` {launch key: [(host time, thread), ...]},
    the candidates for the launch, best first. A device operation belongs
    to the span that holds a candidate's time on its thread; failing
    that, to the one span of any thread that holds the runtime call's
    time (the profiler may name another thread's runtime calls by
    another id; the spans of the cells' threads do not overlap in time:
    the server's sim and pack threads hold one lock)."""
    by_thread = collections.defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    starts = {}
    for th, lst in by_thread.items():
        lst.sort(key=lambda s: s.start)
        starts[th] = [s.start for s in lst]
    every = sorted(spans, key=lambda s: s.start)
    every_starts = [s.start for s in every]

    def on_thread(t, th):
        i = bisect.bisect_right(starts.get(th, ()), t) - 1
        if i >= 0 and t < by_thread[th][i].end:
            return by_thread[th][i].name
        return ""

    def any_thread(t):
        i = bisect.bisect_right(every_starts, t) - 1
        hits = {every[j].name for j in range(i, max(i - 8, -1), -1)
                if every[j].start <= t < every[j].end}
        return hits.pop() if len(hits) == 1 else ""

    ops = []
    for name, s, e, key in device_ops:
        cands = launches.get(key, ())
        label = next((lab for lab in (on_thread(t, th) for t, th in cands)
                      if lab), "")
        if not label and cands:
            label = any_thread(cands[-1][0])
        ops.append(DeviceOp(name, s, e, label))
    return TraceView(ops, spans, host, t0, t1)


def view_from_profiler(prof, t0_ns: int, t1_ns: int) -> TraceView:
    """A TraceView from a stopped ``torch.profiler.profile``: its kineto
    events read in memory. A device event's launch candidates are the host
    operation that was innermost at its launch (``linked_correlation_id``),
    then the runtime call that launched it (``cudaLaunchKernel`` ...),
    which is last: its time is the launch's own."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    lo, hi = t0_ns * 1e-9, t1_ns * 1e-9
    raw, spans, host, runtime, ops_by_corr = [], [], [], {}, {}
    for e in events:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if not name.startswith(SPAN_PREFIX):
                raw.append((name, e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                            (e.correlation_id(), e.linked_correlation_id())))
            continue
        ev = HostEvent(name, e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                       e.start_thread_id())
        act = e.activity_type() if hasattr(e, "activity_type") else ""
        if act in ("cuda_runtime", "cuda_driver") or (
                not act and name.startswith("cu")):
            runtime[e.correlation_id()] = ev
        else:
            ops_by_corr.setdefault(e.correlation_id(), ev)
        if name.startswith(SPAN_PREFIX):
            spans.append(ev._replace(name=name[len(SPAN_PREFIX):]))
        elif ev.end > lo and ev.start < hi:
            host.append(ev)
    launches = {}
    for _, _, _, key in raw:
        corr, linked = key
        cands = [ev for ev in (ops_by_corr.get(linked) if linked else None,
                               runtime.get(corr)) if ev is not None]
        launches[key] = [(ev.start, ev.thread) for ev in cands]
    return build_view(raw, launches, spans, host, lo, hi)
