"""The exact window's spans and counters (ops/pmx.py) on the CPU: with the
tracer on, a step of the deep-zoom stack with its exact window records
inside ``engine.step`` one ``pmx.diff`` a step around the difference pass,
between two ``pmx.members`` (the flag sort and the compaction before it;
the scatter after it); the counters ``pmx.members`` and
``pmx.member_pairs`` sum the in-budget members and their squares over
the steps, read from the device once; the levels' one window pass a
step runs inside ``pm2.windows``, and its plain version here counts no
fused pass (``pm2.windows.fused``); with the tracer off nothing is
recorded, and the spans leave the state's bits unchanged. The engines take
the kernels' wrappers (``Method.CUDA`` set after construction), whose
plain versions run here, on the persistent order and per frame."""

import pytest
import torch

from particle_sim_tpu_torch.core.params import Method, PMConfig, SimParams
from particle_sim_tpu_torch.core.state import LANE, ParticleState
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm, pmx
from particle_sim_tpu_torch.ops.pm2 import PM2Config
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

COUNT = 4096
STEPS = 3
CFG = PMConfig(grid=32, softening=3.0)
LEVELS = (PM2Config(None, 32.0, 0.6), PM2Config(None, 8.0, 0.2))
#: The deep-zoom example's window; "small" holds fewer than the members.
WINDOWS = {"all": pmx.PMXConfig(2.0, 0.05, capacity=4096),
           "small": pmx.PMXConfig(2.0, 0.05, capacity=512)}
MODES = [(w, persist) for w in WINDOWS for persist in (True, False)]


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def exact_engine(window: str, persist: bool) -> Engine:
    """A cluster of radius ~1 inside a wider one, so that the levels and
    the 2-unit window hold members."""
    e = Engine(particle_count=COUNT, device="cpu", method=Method.TORCH,
               pm=CFG, pm2=LEVELS, pmx=WINDOWS[window], pm_persist=persist)
    e.method = Method.CUDA      # the wrappers, their plain versions here
    g = torch.Generator().manual_seed(23)
    pos = torch.randn((3, COUNT), generator=g)
    pos[:, COUNT // 2:] *= 4.0
    pos += torch.tensor([1.5, -0.5, 0.7])[:, None]
    rows = COUNT // LANE
    st = e.state
    e.state = ParticleState(pos=pos.view(3, rows, LANE),
                            vel=torch.zeros((3, rows, LANE)),
                            init_color=st.init_color, n_active=st.n_active)
    return e


def members_now(e: Engine, window: str) -> int:
    """The in-budget members of the step the engine would take next, as
    the window's own functions count them."""
    st = e._persist if e._identity_dirty else e.state
    pos = st.pos.reshape(3, -1)
    live = pm.live_mask(pos.shape[1], COUNT, pos.device)
    cfgx = WINDOWS[window]
    w = pmx.window_origin(pos, live, cfgx, LEVELS)
    n_m = int(pmx._member_mask(pos, w, cfgx, live).sum())
    return min(n_m, cfgx.capacity)


def run(e, steps=STEPS):
    for _ in range(steps):
        e.step(SimParams())


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("window,persist", MODES)
def test_the_pass_spans_between_its_bookkeeping(window, persist, steps):
    e = exact_engine(window, persist)
    trace.enable()
    run(e, steps)
    recs = trace.records()
    step = [r for r in recs if r.name == "engine.step"]
    assert len(step) == steps
    for s in step:
        inner = sorted((r for r in recs if r.name.startswith("pmx.")
                        and s.start_ns <= r.start_ns
                        and r.end_ns <= s.end_ns), key=lambda r: r.start_ns)
        assert [r.name for r in inner] == ["pmx.members", "pmx.diff",
                                           "pmx.members"]
        assert all(r.parent == "engine.step" and r.device_ms is None
                   for r in inner)   # CPU: no device time


@pytest.mark.parametrize("window,persist", MODES)
def test_the_counters_sum_the_members_and_their_squares(window, persist):
    e = exact_engine(window, persist)
    trace.enable()
    seen = []
    for _ in range(STEPS):
        seen.append(members_now(e, window))
        e.step(SimParams())
    got = trace.counters()
    assert got["pmx.members"] == sum(seen)
    assert got["pmx.member_pairs"] == sum(k * k for k in seen)
    assert min(seen) > 0
    if window == "small":
        assert max(seen) == WINDOWS["small"].capacity


@pytest.mark.parametrize("window,persist", MODES)
def test_the_window_comes_from_the_levels_pass(window, persist):
    """One window pass a step inside ``pm2.windows`` (on the card it finds
    the exact window too); here, on CPU tensors, the plain pass counts no
    fused pass and the exact window's origin comes from window_origin,
    once a step."""
    e = exact_engine(window, persist)
    calls = []
    origin = pmx.window_origin
    pmx.window_origin = lambda *a, **k: calls.append(1) or origin(*a, **k)
    trace.enable()
    try:
        run(e)
    finally:
        pmx.window_origin = origin
    recs = trace.records()
    names = [r.name for r in recs]
    keys = names.count("persist.verdict") + names.count("persist.repair")
    assert (keys >= 1) == persist
    assert "pm2.windows.fused" not in trace.counters()
    assert names.count("pm2.windows") == STEPS
    assert len(calls) == STEPS


@pytest.mark.parametrize("what", ["records", "counters"])
@pytest.mark.parametrize("window,persist", MODES)
def test_nothing_with_tracing_off(window, persist, what):
    run(exact_engine(window, persist), 2)
    got = trace.records() if what == "records" else trace.counters()
    assert not got


@pytest.mark.parametrize("window,persist", MODES)
def test_spans_leave_the_step_unchanged(window, persist):
    a, b = exact_engine(window, persist), exact_engine(window, persist)
    run(a)
    trace.enable()
    run(b)
    for pa, pb in ((a.state.pos, b.state.pos), (a.state.vel, b.state.vel)):
        assert torch.equal(pa, pb)
    assert bool((a.state.vel != 0).any())


def test_a_tally_stays_on_the_device_until_read():
    trace.enable()
    trace.tally("t", torch.tensor(3, dtype=torch.int32))
    trace.tally("t", torch.tensor(4, dtype=torch.int64))
    trace.count("c", 2)
    assert trace.counters() == {"t": 7, "c": 2}
    trace.disable()
    trace.tally("t", torch.tensor(5))
    assert trace.counters()["t"] == 7
    trace.reset()
    assert trace.counters() == {}
