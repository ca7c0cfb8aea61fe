"""The port's tracer (utils/trace.py) on the CPU: off by default and free
there, on under a profiler started on another thread, nesting, counters
and the record bound, the device-time bookkeeping on stand-in events,
and the spans and counters the engine, the persistent PM and the stream
server record. The CLI's stats lines keep the JAX package's keys."""

import base64
import functools
import json
import socket
import threading
import time

import pytest
import torch

from particle_sim_tpu.engine.stats import FrameStats as JFrameStats

from particle_sim_tpu_torch.app import cli, server
from particle_sim_tpu_torch.core.params import Method, PMConfig, SimParams
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.engine.stats import FrameStats
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

WAIT_S = 20.0
PM_STEP = {"engine.step", "pm.solve", "pm.momentum", "pm.kick"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def names(recs):
    return {r.name for r in recs}


def pm_engine(**kw):
    return Engine(particle_count=4096, device="cpu", method=Method.TORCH,
                  pm=PMConfig(grid=32), **kw)


# -- the tracer ---------------------------------------------------------------
def test_off_by_default_reads_no_clock(monkeypatch):
    class NoClock:
        @staticmethod
        def time_ns():
            raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(trace, "time", NoClock)
    assert trace.refresh() is False
    null = trace.span("a")
    assert trace.span("b", device=True) is null
    with null as sp:
        assert sp is None
    trace.count("c")
    pm_engine().step(SimParams())
    assert trace.records() == [] and trace.counters() == {}


def test_on_under_a_profiler_started_on_another_thread():
    seen = []

    def worker():
        on = trace.refresh()
        with trace.span("worker"):
            trace.count("worker.count")
        seen.append((on, threading.get_ident()))

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        t = threading.Thread(target=worker)
        t.start()
        t.join(WAIT_S)
        assert not t.is_alive()
    finally:
        prof.stop()
    assert trace.refresh() is False
    (on, tid), = seen
    assert on
    (rec,) = trace.records()
    assert (rec.name, rec.thread, rec.parent) == ("worker", tid, None)
    assert rec.start_ns <= rec.end_ns and rec.device_ms is None
    assert trace.counters() == {"worker.count": 1}


def test_nesting_and_parents_per_thread():
    trace.enable()
    t0 = time.time_ns()
    inner_started = threading.Event()
    outer_open = threading.Event()

    def other():
        outer_open.wait(WAIT_S)
        with trace.span("other"):
            inner_started.set()

    t = threading.Thread(target=other)
    t.start()
    with trace.span("outer"):
        outer_open.set()
        with trace.span("inner"):
            inner_started.wait(WAIT_S)
            with trace.span("leaf"):
                pass
    t.join(WAIT_S)
    assert not t.is_alive()
    t1 = time.time_ns()
    recs = {r.name: r for r in trace.records(t0, t1)}
    assert recs["leaf"].parent == "inner"
    assert recs["inner"].parent == "outer"
    assert recs["outer"].parent is None
    # the other thread's span has no parent though "inner" was open
    assert recs["other"].parent is None
    assert recs["other"].thread != recs["outer"].thread
    assert recs["outer"].start_ns <= recs["inner"].start_ns
    assert recs["inner"].end_ns <= recs["outer"].end_ns
    assert trace.records(t1 + 1) == []


def test_counters_only_while_on():
    trace.count("x")
    trace.enable()
    trace.count("x")
    trace.count("x", 4)
    trace.disable()
    trace.count("x")
    assert trace.counters() == {"x": 5}


def test_records_are_bounded(monkeypatch):
    import collections

    monkeypatch.setattr(trace, "_done", collections.deque(maxlen=3))
    trace.enable()
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [r.name for r in trace.records()] == ["s2", "s3", "s4"]
    assert trace.counters() == {"trace.dropped": 2}


def test_device_times_are_read_later_and_passed_on(monkeypatch):
    """Stand-in CUDA events: a span's device time is read when a later
    span begins and finds its end event complete, or by records()."""
    done = {"flag": False}
    synced = []

    class Event:
        made = 0

        def __init__(self):
            Event.made += 1

        def record(self, stream):
            pass

        def query(self):
            return done["flag"]

        def elapsed_time(self, end):
            return 2.5

    monkeypatch.setattr(trace.torch.cuda, "Event",
                        lambda enable_timing: Event())
    monkeypatch.setattr(trace.torch.cuda, "synchronize",
                        lambda: synced.append(1))
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda: None)
    got = []
    trace.enable()
    with trace.span("a", device=True, on_device=got.append):
        pass
    with trace.span("b", device=True):   # a's events not done: unread
        pass
    assert got == []
    done["flag"] = True
    with trace.span("host"):       # a host span reads no event
        pass
    assert got == []
    with trace.span("c", device=True):    # reads a's time, reuses its events
        pass
    assert got == [2.5] and Event.made == 4
    recs = {r.name: r for r in trace.records()}   # c's read here
    assert synced == [1]
    assert [recs[k].device_ms for k in "abc"] == [2.5] * 3
    assert recs["host"].device_ms is None


def test_nested_device_spans_take_the_outer_stream(monkeypatch):
    """A device span inside another records on that one's stream and
    reads no events; the next outermost one reads all the spans that
    ended before it on its stream with one query."""
    streams, recorded, queries = [], [], []

    class Event:
        def record(self, stream):
            recorded.append(stream)

        def query(self):
            queries.append(self)
            return True

        def elapsed_time(self, end):
            return 1.0

    def current_stream():
        streams.append(object())
        return streams[-1]

    monkeypatch.setattr(trace.torch.cuda, "Event",
                        lambda enable_timing: Event())
    monkeypatch.setattr(trace.torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda: None)
    trace.enable()
    for _ in range(2):
        with trace.span("outer", device=True):
            with trace.span("host"):
                with trace.span("inner", device=True):
                    pass
    assert len(streams) == 2 and len(queries) == 1
    assert recorded == [streams[0]] * 4 + [streams[1]] * 4
    recs = trace.records()
    assert [r.device_ms for r in recs if r.name != "host"] == [1.0] * 4
    assert [r.parent for r in recs[:3]] == ["host", "outer", None]


# -- the program's spans --------------------------------------------------------
def test_pm_step_spans():
    e = pm_engine()
    e.step(SimParams())
    trace.enable()
    e.step(SimParams())
    recs = trace.records()
    assert names(recs) == PM_STEP
    step = next(r for r in recs if r.name == "engine.step")
    for r in recs:
        if r.name != "engine.step":
            assert r.parent == "engine.step"
            assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
    # the span's clock reads are the step's one timer
    assert e.stats.update_ms > 0.0


def test_step_times_itself_when_tracing_stops_before_its_span(monkeypatch):
    # another thread's refresh may turn the flag off between this step's
    # refresh and its span: the step then takes the null span's branch
    monkeypatch.setattr(trace, "refresh", lambda: True)
    e = pm_engine()
    e.step(SimParams())
    assert e.stats.update_ms > 0.0 and trace.records() == []


def test_persistent_step_spans_and_a_forced_repair():
    e = pm_engine(pm_persist=True)
    e.step(SimParams())
    trace.enable()
    e.step(SimParams())
    assert names(trace.records()) == PM_STEP
    trace.reset()
    e._trigger.due = lambda: True
    e.step(SimParams())
    assert e.resorts == 1
    recs = trace.records()
    assert names(recs) == PM_STEP | {"persist.repair"}
    (rep,) = [r for r in recs if r.name == "persist.repair"]
    assert rep.parent == "engine.step" and rep.device_ms is None


def test_frame_stats_device_time_counts_no_step():
    s = FrameStats()
    s.record_device(10.0)
    assert s.steps_total == 0 and s.device_ms == pytest.approx(1.0)


def _ws_connect(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    key = base64.b64encode(b"0123456789abcdef").decode()
    sock.sendall((
        "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    return sock


def test_server_spans_and_counters():
    engine = Engine(particle_count=2048, device="cpu", method=Method.TORCH)
    srv = server.StreamServer(engine, port=0, target_fps=30)
    # the compact renderer (the one that reads its chunk count), which
    # "auto" picks only on a CUDA device
    engine.render_frame_device = functools.partial(
        engine.render_frame_device, renderer="compact")
    srv.wire_mode, srv.raster_size = 2, (256, 128)
    trace.enable()
    srv.start()
    sock = None
    try:
        sock = _ws_connect(srv.port)
        deadline = time.monotonic() + WAIT_S
        while (trace.counters().get("server.frames_sent", 0) < 3
               and time.monotonic() < deadline):
            sock.recv(1 << 20)
    finally:
        if sock is not None:
            sock.close()
        srv.stop()
    counts = trace.counters()
    assert counts["server.frames_sent"] >= 3
    assert counts["server.frames_built"] >= counts["server.frames_sent"]
    recs = trace.records()
    assert {"server.lock_wait", "server.frame_host", "render.kept_read",
            "engine.step"} <= names(recs)
    for r in recs:
        if r.name in ("server.lock_wait", "server.frame_host",
                      "render.kept_read"):
            assert r.parent is None and r.device_ms is None
    sim = {r.thread for r in recs if r.name in ("server.lock_wait",
                                                 "engine.step")}
    pack = {r.thread for r in recs if r.name in ("server.frame_host",
                                                  "render.kept_read")}
    assert len(sim) == 1 and len(pack) == 1 and sim != pack


@pytest.mark.parametrize("traced", [False, True])
def test_cli_stats_lines_keep_their_keys(traced, capsys):
    if traced:
        trace.enable()
    assert cli.main(["--device", "cpu", "--count", "2048", "--steps", "4",
                     "--stats-every", "2"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    keys = set(JFrameStats().snapshot())
    assert [set(line) for line in lines[:-1]] == [{"step"} | keys] * 2
    assert set(lines[-1]) == {"done", "steps", "wall_s",
                              "particle_steps_per_sec"} | keys
    assert lines[-1]["update_ms"] > 0.0
    assert (names(trace.records()) == {"engine.step"}) == traced
