"""The program's own spans and counters in a traced run.

The port records spans and counts (``particle_sim_tpu_torch/utils/
trace.py``) while a profiler is started; ``traffic.py`` starts it at the
traced window and stops it there, so the records and counters are the
window's. Span records are read here clipped to the window
``[run.trace.t0, run.trace.t1]``; their host times are on the profiler's
clock (``time.time_ns()``), so they line up with the device operations of
``run.trace``.

Every helper returns None when the run was not traced, when the program
has no tracer (a tree before it), or when it finds nothing to read. The
counters are the process's, which is the window's in a run of
``run.py`` (one run a process).
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Iterable, Optional

from . import trace as tracing

#: The span of one Engine.step call, which the per-step readers count.
STEP = "engine.step"


def _tracer():
    try:
        from particle_sim_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _window_ns(run) -> tuple:
    return round(run.trace.t0 * 1e9), round(run.trace.t1 * 1e9)


def records(run) -> Optional[list]:
    """The program's span records that overlap the traced window."""
    tr = None if run.trace is None else _tracer()
    if tr is None:
        return None
    return tr.records(*_window_ns(run))


def counters(run) -> Optional[dict]:
    tr = None if run.trace is None else _tracer()
    return None if tr is None else tr.counters()


def device_ms_per_step(run, names: Iterable[str]) -> Optional[float]:
    """Device ms of the spans named ``names`` that began in the window,
    over the engine.step spans that began there."""
    recs = records(run)
    if not recs:
        return None
    lo, hi = _window_ns(run)
    names = set(names)
    started = [r for r in recs if lo <= r.start_ns < hi]
    steps = sum(1 for r in started if r.name == STEP)
    ms = [r.device_ms for r in started if r.name in names]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps


def device_ms_mean(run, name: str) -> Optional[float]:
    """Device ms a span named ``name`` that began in the window."""
    recs = records(run)
    if not recs:
        return None
    lo, hi = _window_ns(run)
    ms = [r.device_ms for r in recs
          if r.name == name and lo <= r.start_ns < hi]
    if not ms or None in ms:
        return None
    return statistics.fmean(ms)


def host_ms_mean(run, name: str) -> Optional[float]:
    """Host ms a span named ``name``, each clipped to the window."""
    recs = records(run)
    if not recs:
        return None
    lo, hi = _window_ns(run)
    ms = [(min(r.end_ns, hi) - max(r.start_ns, lo)) * 1e-6
          for r in recs if r.name == name]
    return statistics.fmean(ms) if ms else None


def gap_spans(run, recs: Optional[list] = None) -> Optional[list]:
    """[(seconds, names)] for each idle gap of the card in the window
    (``trace.gaps`` over the device operations): the gap's length and the
    names of the program's spans (``recs``, by default the window's)
    open, on any thread, at its middle. A span name is entered by one
    thread at a time, so its spans do not overlap one another."""
    recs = records(run) if recs is None else recs
    if not recs or not run.trace.ops:
        return None
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append((r.start_ns * 1e-9, r.end_ns * 1e-9))
    index = {}
    for name, iv in by_name.items():
        iv.sort()
        index[name] = ([s for s, _ in iv], iv)
    out = []
    for s, e in tracing.gaps(((o.start, o.end) for o in run.trace.ops),
                             run.trace.t0, run.trace.t1):
        mid = 0.5 * (s + e)
        names = []
        for name, (starts, iv) in index.items():
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid < iv[i][1]:
                names.append(name)
        out.append((e - s, sorted(names)))
    return out


def host_bound_pct(run) -> Optional[float]:
    """The share of the window in which the card was idle while the
    stepping thread was inside engine.step (at each gap's middle)."""
    recs = records(run)
    if not recs or not any(r.name == STEP for r in recs):
        return None
    split = gap_spans(run, recs)
    if split is None:
        return None
    idle = sum(secs for secs, names in split if STEP in names)
    return 100.0 * idle / run.trace.window_s
