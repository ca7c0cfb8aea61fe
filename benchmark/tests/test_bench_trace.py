"""The trace arithmetic on synthetic events: the union of the device
intervals, the idle gaps and what the host was in, and the attribution
of device operations to the span that launched them."""

import pytest

from benchmark import trace as tr
from benchmark.trace import HostEvent


def test_union_length_merges_overlaps_and_clips():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert tr.union_length(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert tr.union_length(iv, 1.5, 3.5) == pytest.approx(0.5 + 0.5)
    assert tr.union_length([], 0.0, 1.0) == 0.0


def test_gaps_are_the_complement():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert tr.gaps(iv, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    assert tr.gaps([(0.0, 8.0)], 0.0, 7.0) == []


def _view():
    # thread 1: two steps; thread 2: one render overlapping the second step
    spans = [HostEvent("Engine.step", 0.0, 1.0, 1),
             HostEvent("Engine.step", 2.0, 3.0, 1),
             HostEvent("Engine.render_frame_device", 2.5, 3.5, 2)]
    host = [HostEvent("aten::item", 4.0, 6.0, 1)]
    ops = [("pm_deposit_kernel<true>", 0.2, 0.6, "k1"),
           ("vector_fft<256u>", 0.6, 0.9, "k2"),
           ("pm_deposit_kernel<true>", 2.1, 2.3, "k3"),
           ("deposit_kernel", 2.6, 3.1, "k4"),
           ("orphan", 7.0, 7.5, "k5")]
    launches = {"k1": [(0.1, 1)], "k2": [(0.15, 1)], "k3": [(2.05, 1)],
                "k4": [(2.55, 2)], "k5": [(6.5, 1)]}
    return tr.build_view(ops, launches, spans, host, 0.0, 10.0)


def test_attribution_by_launch_time_and_thread():
    v = _view()
    assert [o.span for o in v.ops] == ["Engine.step", "Engine.step",
                                       "Engine.step",
                                       "Engine.render_frame_device", ""]
    secs, count = v.device_time("Engine.step", (r"pm_deposit_kernel",))
    assert (secs, count) == (pytest.approx(0.6), 2)
    assert v.device_time("Engine.render_frame_device")[1] == 1
    assert v.span_count("Engine.step") == 2


def test_idle_share_busy_and_breakdown():
    v = _view()
    busy = 0.4 + 0.3 + 0.2 + 0.5 + 0.5
    assert v.busy_s() == pytest.approx(busy)
    assert v.idle_pct() == pytest.approx(100.0 * (1.0 - busy / 10.0))
    assert v.top_gaps(3) == [["aten::item", pytest.approx(3.9)],
                             ["host idle", pytest.approx(2.5)],
                             ["host idle", pytest.approx(1.2)]]
    top = v.top_ops(2)
    assert top[0][0] == "Engine.step/pm_deposit_kernel<true>"
    assert top[0][1] == pytest.approx(0.6)


def test_a_launch_named_by_another_thread_id_falls_back_to_time():
    spans = [HostEvent("Engine.step", 0.0, 1.0, 7),
             HostEvent("Engine.render_frame_device", 1.0, 2.0, 8)]
    ops = [("pm_deposit_kernel", 0.5, 0.6, "a"), ("x", 1.5, 1.6, "b"),
           ("y", 3.0, 3.1, "c")]
    launches = {"a": [(0.4, 99)], "b": [(1.2, 99)], "c": [(2.5, 99)]}
    v = tr.build_view(ops, launches, spans, [], 0.0, 4.0)
    assert [o.span for o in v.ops] == ["Engine.step",
                                       "Engine.render_frame_device", ""]


def test_gap_named_by_the_span_open_at_its_middle():
    spans = [HostEvent("Engine.diagnostics", 0.0, 5.0, 1)]
    ops = [("a", 0.0, 1.0, "x"), ("b", 4.0, 5.0, "y")]
    v = tr.build_view(ops, {}, spans, [], 0.0, 5.0)
    assert v.top_gaps() == [["Engine.diagnostics", pytest.approx(3.0)]]


def test_no_device_ops_reads_nothing():
    v = tr.build_view([], {}, [], [], 0.0, 1.0)
    assert v.idle_pct() is None
    assert v.device_time("Engine.step") == (0.0, 0)


def test_dispatch_is_read_with_the_profiler_off(small, monkeypatch):
    """A traced headless run times one run of its mix with the profiler
    off before the window, and the dispatch metric reads that pass."""
    import time

    import torch

    from benchmark import harness, spec, traffic

    torch.set_num_threads(2)
    ranges = []
    record = torch.profiler.record_function

    def counted(name):
        ranges.append(name)
        return record(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    run = harness.Run("pm1m.headless", 3, 0.5, True, "cpu",
                      time.perf_counter(), small)
    traffic.headless(run)
    per_run = run.traffic["steps_per_run"]
    assert len(run.untraced["Engine.step"]) == per_run
    # ranges: the warm-up, the window and the check's two stages; none
    # for the untraced pass
    window = len(run.spans.durations["Engine.step"])
    assert window > 0
    assert ranges.count("bench:Engine.step") == (
        run.traffic["warmup_steps"] + window
        + 2 * run.cell["check"]["steps"])
    reader = spec.metric_reader("engine.dispatch_us.headless")
    assert reader.read(run) == pytest.approx(
        1e6 * sum(run.untraced["Engine.step"]) / per_run)
