"""The direct sum's spans and counters (ops/pairwise.py, ops/pairwise_cuda.py)
on the CPU: with the tracer on, a direct-sum engine records one
``pairwise.force`` and one ``pairwise.kick`` span a step, inside
``engine.step``, and counts capacity^2 ``pairwise.pairs`` a step; a
pmx difference pass counts ``pairwise.diff_pairs``; with the tracer off
nothing is recorded."""

import pytest
import torch

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

COUNT = 2048


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def direct_engine(masses=False):
    e = Engine(particle_count=COUNT, device="cpu", method=Method.TORCH,
               pairwise=PairwiseParams(1.0, 0.5))
    if masses:
        m = torch.ones(COUNT)
        m[0] = 1000.0
        e.set_masses(m.numpy())
    return e


def run(e, steps):
    for _ in range(steps):
        e.step(SimParams())


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("name", ["pairwise.force", "pairwise.kick"])
def test_one_span_a_step_inside_the_engine_step(name, masses):
    e = direct_engine(masses)
    trace.enable()
    run(e, 3)
    recs = [r for r in trace.records() if r.name == name]
    assert len(recs) == 3
    assert all(r.parent == "engine.step" for r in recs)
    assert all(r.device_ms is None for r in recs)   # CPU: no device time
    assert all(r.end_ns >= r.start_ns for r in recs)


@pytest.mark.parametrize("steps", [1, 4])
def test_pairs_count_capacity_squared_a_step(steps):
    e = direct_engine()
    trace.enable()
    run(e, steps)
    cap = e.state.capacity
    assert cap == COUNT
    counts = trace.counters()
    assert counts["pairwise.pairs"] == steps * cap * cap
    assert "pairwise.diff_pairs" not in counts


@pytest.mark.parametrize("accel_diff", [pairwise.pairwise_accel_diff,
                                        pairwise_cuda.pairwise_accel_diff],
                         ids=["plain", "wrapper"])
def test_a_difference_pass_counts_diff_pairs(accel_diff):
    g = torch.Generator().manual_seed(5)
    rec = torch.randn((300, 3), generator=g) * 10.0
    src = torch.randn((3, 700), generator=g) * 10.0
    trace.enable()
    accel_diff(rec, src, 650, 1.0, 0.5, 2.0, n_i=290, n_j=650)
    # the plain version's two passes are one difference pass, not pairs
    assert trace.counters() == {"pairwise.diff_pairs": 300 * 700}


@pytest.mark.parametrize("accel", [pairwise.pairwise_accel,
                                   pairwise_cuda.pairwise_accel],
                         ids=["plain", "wrapper"])
def test_a_rectangular_call_counts_its_shapes(accel):
    rec = torch.zeros((128, 3))
    src = torch.ones((3, 96))
    trace.enable()
    accel(rec, src, 96, 1.0, 0.5)
    accel(rec, src, 96, 1.0, 0.5, n_i=10, n_j=20)   # shapes, not counts
    assert trace.counters() == {"pairwise.pairs": 2 * 128 * 96}


def test_the_wrapper_step_records_the_same_names_on_the_cpu():
    e = direct_engine()
    st = e.state
    pv = e._param_vec(SimParams())
    pp = e._param_vec(e.pairwise.pack())
    trace.enable()
    pairwise_cuda.step_pairwise(st.pos.clone(), st.vel.clone(), pv, pp,
                                st.n_active)
    assert [r.name for r in trace.records()] == ["pairwise.force",
                                                 "pairwise.kick"]
    assert trace.counters() == {"pairwise.pairs": COUNT * COUNT}


@pytest.mark.parametrize("what", ["records", "counters"])
def test_nothing_with_tracing_off(what):
    e = direct_engine(masses=True)
    run(e, 2)
    pairwise_cuda.pairwise_accel_diff(torch.zeros((8, 3)), torch.ones(3, 8),
                                      8, 1.0, 0.5, 2.0)
    got = trace.records() if what == "records" else trace.counters()
    assert not got


def test_spans_leave_the_step_unchanged():
    """The spans wrap the same arithmetic: a traced step and an untraced
    one give the same bits."""
    a, b = direct_engine(masses=True), direct_engine(masses=True)
    run(a, 2)
    trace.enable()
    run(b, 2)
    for pa, pb in ((a.state.pos, b.state.pos), (a.state.vel, b.state.vel)):
        assert torch.equal(pa, pb)
