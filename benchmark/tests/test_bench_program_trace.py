"""The readers of the program's own spans and counters
(``program_trace.py`` and the metrics that use it) on synthetic records
and device intervals; on the card, that the program's spans share the
profiler's clock and that tracing adds no device operation."""

import collections
import time
from types import SimpleNamespace

import pytest

from benchmark import program_trace, spec
from benchmark import trace as tr

#: An epoch-sized origin, as time.time_ns() gives, in seconds.
T = 1_760_000_000.0


def rec(name, start, end, device_ms=None, parent=None):
    from particle_sim_tpu_torch.utils.trace import Record

    return Record(name, 1, round((T + start) * 1e9), round((T + end) * 1e9),
                  parent, device_ms)


def _fake_run(monkeypatch, records, counts=None, ops=None):
    from particle_sim_tpu_torch.utils import trace as ptrace

    def window(t0_ns=0, t1_ns=None):
        return [r for r in records if r.end_ns >= t0_ns
                and (t1_ns is None or r.start_ns <= t1_ns)]

    monkeypatch.setattr(ptrace, "records", window)
    monkeypatch.setattr(ptrace, "counters", lambda: dict(counts or {}))
    ops = ops if ops is not None else [(0.0, 1.0), (1.5, 2.5), (3.0, 9.0),
                                       (9.5, 10.0)]
    dev = [(f"k{i}", T + s, T + e, i) for i, (s, e) in enumerate(ops)]
    return SimpleNamespace(trace=tr.build_view(dev, {}, [], [], T, T + 10.0))


RECORDS = [
    rec("engine.step", -1.0, -0.2),            # before the window
    rec("pm.solve", -0.5, 0.1, 9.0),           # began before it
    rec("engine.step", 0.0, 2.0),
    rec("engine.step", 3.0, 5.0),
    rec("engine.step", 6.0, 8.0),
    *[rec("pm.solve", s + 0.1, s + 0.2, 1.5, "engine.step")
      for s in (0.0, 3.0, 6.0)],
    *[rec("pm.momentum", s + 0.3, s + 0.4, 0.3, "engine.step")
      for s in (0.0, 3.0, 6.0)],
    *[rec("pm.kick", s + 0.5, s + 0.6, 0.2, "engine.step")
      for s in (0.0, 3.0, 6.0)],
    rec("persist.repair", 3.05, 3.08, 4.0, "engine.step"),
    rec("persist.repair", 6.05, 6.08, 2.0, "engine.step"),
    rec("server.lock_wait", -0.5, 0.5),        # clipped to 0.5 s
    rec("server.lock_wait", 9.0, 9.5),
    rec("render.kept_read", 2.6, 2.7),
    rec("server.frame_host", 2.7, 2.9),
    rec("server.frame_host", 9.9, 10.3),       # clipped to 0.1 s
]


@pytest.mark.parametrize("name,want", [
    ("pm.solve_span_ms.headless", 1.5),
    ("pm.kick_momentum_ms.headless", 0.5),
    ("pm_persist.repair_ms.headless", 3.0),
    # the card idle 1.0-1.5 (inside a step), 2.5-3.0 and 9.0-9.5 (not)
    ("engine.host_bound_pct.headless", 5.0),
    ("server.lock_wait_ms.served", 500.0),
    ("render.kept_read_ms.served", 100.0),
    ("server.frame_host_ms.served", 150.0),
    ("server.frames_skipped_pct.served", 20.0),
])
def test_readers_on_synthetic_records(name, want, monkeypatch):
    run = _fake_run(monkeypatch, RECORDS, {"server.frames_built": 10,
                                           "server.frames_sent": 8})
    assert spec.metric_reader(name).read(run) == pytest.approx(want)


def test_gaps_named_by_the_spans_open_at_their_middle(monkeypatch):
    run = _fake_run(monkeypatch, RECORDS)
    got = program_trace.gap_spans(run)
    assert [(pytest.approx(s), n) for s, n in got] == [
        (0.5, ["engine.step"]), (0.5, ["server.frame_host"]),
        (0.5, ["server.lock_wait"])]


NEW = ("pm.solve_span_ms.headless", "pm.kick_momentum_ms.headless",
       "pm_persist.repair_ms.headless", "engine.host_bound_pct.headless",
       "server.lock_wait_ms.served", "render.kept_read_ms.served",
       "server.frame_host_ms.served", "server.frames_skipped_pct.served")


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_to_read(name, monkeypatch):
    reader = spec.metric_reader(name)
    assert reader.read(SimpleNamespace(trace=None)) is None
    run = _fake_run(monkeypatch, [])
    assert reader.read(run) is None
    # a tree whose program has no tracer
    run = _fake_run(monkeypatch, RECORDS, {"server.frames_built": 10})
    monkeypatch.setattr(program_trace, "_tracer", lambda: None)
    assert reader.read(run) is None


def test_device_time_missing_on_the_cpu_reads_nothing(monkeypatch):
    recs = [rec("engine.step", 0.0, 1.0), rec("pm.solve", 0.1, 0.2)]
    run = _fake_run(monkeypatch, recs)
    assert spec.metric_reader("pm.solve_span_ms.headless").read(run) is None


# -- on the card ------------------------------------------------------------------
def _profiled(fn):
    """(view of the device operations, t0_ns, t1_ns) of fn() under the
    profiler, every thread, as traffic.py starts it."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    t0 = time.time_ns()
    fn()
    torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.stop()
    return tr.view_from_profiler(prof, t0, t1), t0, t1


@pytest.mark.chip
def test_span_clock_is_the_profilers(card):
    """Spans around a ~5 ms sleep kernel line up with the profiler's
    events within 50 us: the kernel's launch follows the device span's
    host start, the host end of the span around it (just after the host
    sees the kernel done) follows the kernel's end, and the device span's
    time (its CUDA events, queued behind a ~1 ms kernel so no launch
    latency enters it) is the kernel's."""
    import torch

    from particle_sim_tpu_torch.utils import trace as ptrace

    ptrace.reset()
    ptrace.enable()             # first uses: the events' pool, the kernel
    with ptrace.span("warm", device=True):
        torch.cuda._sleep(1000)
    ptrace.records()
    ptrace.disable()
    done = torch.cuda.Event()

    def probe():
        ptrace.refresh()
        for i in range(2):      # the first: the profiler's first calls
            with ptrace.span(f"probe{i}"):
                torch.cuda._sleep(2_000_000)
                with ptrace.span(f"probe{i}.device", device=True):
                    torch.cuda._sleep(10_000_000)
                done.record()
                while not done.query():   # wakes sooner than a synchronise
                    pass

    view, t0, t1 = _profiled(probe)
    recs = {r.name: r for r in ptrace.records(t0, t1)}
    sleeps = sorted((o for o in view.ops
                     if "spin" in o.name or "sleep" in o.name),
                    key=lambda o: o.start)
    assert len(sleeps) == 4
    op, host, dev = sleeps[3], recs["probe1"], recs["probe1.device"]
    lo, hi = dev.start_ns * 1e-9, dev.end_ns * 1e-9
    launches = [e.start for e in view.host
                if "LaunchKernel" in e.name and lo <= e.start <= hi]
    assert launches, "no kernel launch inside the device span"
    offsets = {"launch": min(launches) - lo,
               "end": host.end_ns * 1e-9 - op.end,
               "device": dev.device_ms * 1e-3 - (op.end - op.start)}
    print("offsets (s):", offsets, "kernel", op.name, op.end - op.start)
    assert 0 <= offsets["launch"] < 50e-6, offsets
    assert 0 <= offsets["end"] < 50e-6, offsets
    assert abs(offsets["device"]) < 50e-6, offsets


@pytest.mark.chip
def test_tracing_adds_no_device_operation(card, monkeypatch):
    """The same stretch of persistent PM steps (a repair forced) under the
    profiler, with the program's tracing off and on: the same device
    operations, by name and count."""
    from particle_sim_tpu_torch.core.params import PMConfig, SimParams
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.ops.pm_persist import CHECK_EVERY
    from particle_sim_tpu_torch.utils import trace as ptrace

    eng = Engine(particle_count=1 << 18, device="cuda",
                 pm=PMConfig(grid=64), pm_persist=True)
    params = SimParams()
    for _ in range(10):
        eng.step(params)
    seed = eng.state
    seed = type(seed)(pos=seed.pos.clone(), vel=seed.vel.clone(),
                      init_color=seed.init_color, n_active=seed.n_active)

    def stretch():
        eng.state = type(seed)(pos=seed.pos.clone(), vel=seed.vel.clone(),
                               init_color=seed.init_color,
                               n_active=seed.n_active)
        for i in range(2 * CHECK_EVERY):    # the verdicts at the same frames
            if i == 4:
                eng._trigger.due = lambda: True
            eng.step(params)
            if i == 4:
                del eng._trigger.due
        assert eng.resorts == 1

    stretch()   # first uses (constants, sort buffers) outside the profiler
    ptrace.disable()
    ptrace.reset()
    with monkeypatch.context() as m:
        m.setattr(ptrace, "refresh", lambda: False)
        off, _, _ = _profiled(stretch)
    assert ptrace.records() == []
    on, t0, t1 = _profiled(stretch)
    recs = ptrace.records(t0, t1)
    assert {r.name for r in recs} == {"engine.step", "pm.solve",
                                      "pm.momentum", "pm.kick",
                                      "persist.repair"}
    assert all(r.device_ms > 0 for r in recs)
    assert eng.stats.device_ms > 0
    names_off = collections.Counter(o.name for o in off.ops)
    names_on = collections.Counter(o.name for o in on.ops)
    print("device operations:", sum(names_off.values()), "off,",
          sum(names_on.values()), "on")
    assert names_on == names_off, (names_on - names_off,
                                   names_off - names_on)
