"""The refinement levels' spans (ops/pm2.py) and the persistent verdict's
(ops/pm_persist.py) on the CPU: with the tracer on, a multi-level step on
the kernel path records one ``pm2.windows`` span a step and one
``pm2.level`` a level, both inside ``engine.step``, and inside each
``pm2.level`` one ``pm2.deposit``, ``pm2.solve`` and ``pm2.gather`` in
that order; a persistent engine records one ``persist.verdict`` every
CHECK_EVERY-th step, inside ``engine.step``; the counter
``pm2.windows.fused`` counts the window kernel's passes only, so the
plain passes here count none; with the tracer off nothing
is recorded, and the spans leave the state's bits unchanged. The engines
take the kernels' wrappers (``Method.CUDA`` set after construction),
whose plain versions run here, on the persistent order and per frame."""

import pytest
import torch

from particle_sim_tpu_torch.core.params import Method, PMConfig, SimParams
from particle_sim_tpu_torch.core.state import LANE, ParticleState
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm_persist
from particle_sim_tpu_torch.ops.pm2 import PM2Config
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

COUNT = 4096
STEPS = 3
CFG = PMConfig(grid=32)
#: Tracked windows nested around a cluster of radius ~3, so that both
#: levels hold members.
LEVELS = {"one": (PM2Config(None, 32.0, 0.6),),
          "two": (PM2Config(None, 32.0, 0.6), PM2Config(None, 8.0, 0.2))}
MODES = [(levels, persist) for levels in LEVELS for persist in (True, False)]


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def level_engine(levels: str, persist: bool) -> Engine:
    lv = LEVELS[levels]
    e = Engine(particle_count=COUNT, device="cpu", method=Method.TORCH,
               pm=CFG, pm2=lv if len(lv) > 1 else lv[0],
               pm_persist=persist)
    e.method = Method.CUDA      # the wrappers, their plain versions here
    g = torch.Generator().manual_seed(21)
    pos = torch.randn((3, COUNT), generator=g) * 3.0 + 1.5
    rows = COUNT // LANE
    st = e.state
    e.state = ParticleState(pos=pos.view(3, rows, LANE),
                            vel=torch.zeros((3, rows, LANE)),
                            init_color=st.init_color, n_active=st.n_active)
    return e


def run(e, steps=STEPS):
    for _ in range(steps):
        e.step(SimParams())


@pytest.mark.parametrize("levels,persist", MODES)
def test_spans_nest_a_level_at_a_time(levels, persist):
    e = level_engine(levels, persist)
    trace.enable()
    run(e)
    recs = trace.records()
    k = len(LEVELS[levels])

    def named(name):
        return [r for r in recs if r.name == name]

    assert len(named("engine.step")) == STEPS
    assert len(named("pm2.windows")) == STEPS
    assert len(named("pm2.level")) == STEPS * k
    assert len(named("pm2.solve")) == STEPS * k
    for name, parent in (("pm2.windows", "engine.step"),
                         ("pm2.level", "engine.step"),
                         ("pm2.solve", "pm2.level")):
        assert all(r.parent == parent for r in named(name)), name
        assert all(r.device_ms is None for r in named(name))  # CPU
    # each solve lies inside a level span, each level after the windows
    for s in named("pm2.solve"):
        assert any(lv.start_ns <= s.start_ns and s.end_ns <= lv.end_ns
                   for lv in named("pm2.level"))


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("levels,persist", MODES)
def test_a_level_spans_its_deposit_solve_and_gather(levels, persist, steps):
    e = level_engine(levels, persist)
    trace.enable()
    run(e, steps)
    recs = trace.records()
    lv = [r for r in recs if r.name == "pm2.level"]
    assert len(lv) == steps * len(LEVELS[levels])
    for r in lv:
        inner = [s for s in recs if s.parent == "pm2.level"
                 and r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        assert [s.name for s in sorted(inner, key=lambda s: s.start_ns)] \
            == ["pm2.deposit", "pm2.solve", "pm2.gather"]


def plain_persistent_engine() -> Engine:
    e = Engine(particle_count=COUNT, device="cpu", method=Method.TORCH,
               pm=CFG, pm_persist=True)
    e.method = Method.CUDA
    return e


@pytest.mark.parametrize("steps", [1, pm_persist.CHECK_EVERY + 1])
@pytest.mark.parametrize("levels", [None, *LEVELS])
def test_the_verdict_spans_every_check(levels, steps):
    e = (plain_persistent_engine() if levels is None
         else level_engine(levels, True))
    trace.enable()
    run(e, steps)
    recs = trace.records()
    verdicts = [r for r in recs if r.name == "persist.verdict"]
    checks = sum(1 for i in range(steps) if i % pm_persist.CHECK_EVERY == 0)
    assert len(verdicts) == checks >= 1
    assert all(r.parent == "engine.step" and r.device_ms is None
               for r in verdicts)
    # the verdict computes its own window origins, outside pm2.windows
    assert not any(r.name == "pm2.windows" and r.parent == "persist.verdict"
                   for r in recs)


@pytest.mark.parametrize("steps", [1, pm_persist.CHECK_EVERY + 1])
@pytest.mark.parametrize("levels,persist", MODES)
def test_the_window_pass_counts_once_a_step_and_a_verdict(levels, persist,
                                                          steps):
    """One window pass a step inside ``pm2.windows``, and the verdicts and
    repairs of the persistent order; ``pm2.windows.fused`` counts the
    kernel's passes (one a step and one a verdict or repair on the card,
    tests/test_torch_windows.py), and the plain ones here not at all."""
    e = level_engine(levels, persist)
    trace.enable()
    run(e, steps)
    names = [r.name for r in trace.records()]
    keys = names.count("persist.verdict") + names.count("persist.repair")
    assert (keys >= 1) == persist
    assert names.count("pm2.windows") == steps
    assert "pm2.windows.fused" not in trace.counters()


@pytest.mark.parametrize("what", ["records", "counters"])
@pytest.mark.parametrize("levels,persist", MODES)
def test_nothing_with_tracing_off(levels, persist, what):
    run(level_engine(levels, persist), 2)
    got = trace.records() if what == "records" else trace.counters()
    assert not got


@pytest.mark.parametrize("levels,persist", MODES)
def test_spans_leave_the_step_unchanged(levels, persist):
    """The spans wrap the same arithmetic: a traced run and an untraced
    one give the same bits, with members in every level."""
    a, b = level_engine(levels, persist), level_engine(levels, persist)
    run(a)
    trace.enable()
    run(b)
    for pa, pb in ((a.state.pos, b.state.pos), (a.state.vel, b.state.vel)):
        assert torch.equal(pa, pb)
    assert bool((a.state.vel != 0).any())
