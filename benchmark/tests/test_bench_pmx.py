"""The exact-core configuration (``deep_zoom_exact_500k``) and its cell
(``deep_zoom_exact500k.headless``): the documented command, the engine it
builds against the example's own ``--exact`` engine, the plain reference
against the port over the seeded scene, the precisions, the capacity,
the control and planted faults in the exact window and in the levels. On
the CPU at 4,096 particles of the example's scene (grid 32, the
configuration's own windows and softenings: the 2-unit window holds
~1,065 members, every one inside the capacity), and the cell itself at
that size; the control also on the card at the cell's own size
(``chip``).

The faults are planted in the kernel path (``ops/pmx.py``, which the card
runs; the engines here take the wrappers' plain versions): the exact
pass dropped, the correction not telescoped (g(eps_x) alone), eps_prev
taken from the coarse mesh (3) instead of the innermost level (0.2), the
window's origin not clamped into the innermost level, and the capacity
cut below the members; and ``test_bench_pmn.py``'s three faults in the
levels."""

import dataclasses
import functools
import gc
import shlex
import time

import pytest
import torch

from benchmark import check, harness, spec, state, traffic
from benchmark.reference import pmx as rpmx
from test_bench_pmn import FAULTS as LEVEL_FAULTS

CELL, CONFIG = "deep_zoom_exact500k.headless", "deep_zoom_exact_500k"
SEED = 2 ** 37 + 11
COUNT = 4096
SMALL_CLI = ["--count", str(COUNT), "--pm-grid", "32"]
STEPS = 3
#: The gaps of the sound port from the float64 reference over STEPS
#: steps at this size: positions within 1.2e-6 cells (the float32 ulp of
#: a coordinate near the scene's centre, 14, is 9.5e-7) and velocities
#: within 7e-6 of the reference's largest change (the float32 reference
#: itself reads 6.5e-6); 1e-4 leaves room for other seeds and orders
#: while the control (bfloat16) reads 0.031 and 0.23.
TOL = 1e-4


@pytest.fixture(autouse=True)
def two_threads():
    torch.set_num_threads(2)


def _small_config(**pmx):
    cfg = spec.config(CONFIG)
    cfg["count"] = COUNT
    cfg["pm"]["grid"] = 32
    cfg["cli_argv"] = [*cfg["cli_argv"], *SMALL_CLI]
    cfg["pmx"] = {**cfg["pmx"], **pmx}
    return cfg


def _scene(cfg, seed=SEED):
    """(pos, vel) f32[3, n] of the configuration's seeded scene."""
    init = state.initial(cfg, seed, "cpu")
    n = init.n
    return init.pos[:, :n].clone(), init.vel[:, :n].clone()


# -- the configuration --------------------------------------------------------
def test_cli_argv_is_the_examples_exact_cli_command():
    """The deep-zoom example's docstring gives this run's CLI form (the
    one with ``--pmx-size``), ``--device`` apart."""
    from particle_sim_tpu_torch.examples import deep_zoom

    doc = deep_zoom.__doc__.replace("\\\n", " ")
    line = next(ln for ln in doc.splitlines()
                if "particle_sim_tpu_torch.app.cli" in ln
                and "--pmx-size" in ln)
    words = shlex.split(line)
    argv = words[words.index("-m") + 2:]
    k = argv.index("--device")
    assert spec.config(CONFIG)["cli_argv"] == argv[:k] + argv[k + 2:]


def test_the_engine_is_the_configuration():
    from particle_sim_tpu_torch.ops.pm2 import PM2Config
    from particle_sim_tpu_torch.ops.pmx import PMXConfig

    bench = spec.load_spec()
    cfg = spec.config(CONFIG)
    args = traffic.cli_args(cfg, "cpu")
    assert (args.count, args.central_mass) == (cfg["count"],
                                               cfg["central_mass"])
    assert cfg["generation"] == "deep_zoom_scene" and cfg["reduced"] == []
    engine = traffic.build_engine(traffic.cli_args(_small_config(), "cpu"))
    pm = engine.pm
    assert {"grid": pm.grid, "box_min": list(pm.box_min),
            "box_size": pm.box_size, "softening": pm.softening,
            "boundary": pm.boundary, "gradient": pm.gradient,
            "auto_box": pm.auto_box} == {**cfg["pm"], "grid": 32}
    assert engine.pm2 == tuple(PM2Config(**lv) for lv in cfg["pm2"])
    assert engine.pmx == PMXConfig(**cfg["pmx"])
    assert engine.pm_persist is cfg["persist"] is True
    assert engine.persist_resolved()
    assert engine.pairwise.gravitational_constant == cfg["g_const"]
    assert engine.pairwise.softening == cfg["pm"]["softening"]
    cells = [w for w in bench["workloads"] if w["config"] == CONFIG]
    assert [(w["name"], w["chips"]) for w in cells] == [(CELL, 1)]
    tr = spec.traffic(cells[0]["traffic"])
    assert (tr["kind"], tr["steps_per_run"], tr["stats_every"],
            tr["diagnostics"]) == ("headless", args.steps,
                                   args.stats_every, args.diagnostics)


def test_the_engine_is_the_examples_exact_engine_but_its_capacity():
    """``cli_argv`` builds the engine of the example's ``build(args)``
    with ``--exact`` (the softenings, G, the levels, the window and the
    step's parameters); only the window's capacity differs (PERF.md), and
    the mouse's resting place, which pulls nothing without a drag."""
    from particle_sim_tpu_torch.examples import deep_zoom

    cfg = spec.config(CONFIG)
    args = traffic.cli_args(cfg, "cpu")
    ours = traffic.build_engine(args)
    theirs, params, _ = deep_zoom.build(deep_zoom.build_parser().parse_args(
        ["--count", str(cfg["count"]), "--exact", "--device", "cpu"]))
    for e in (ours, theirs):
        assert e.particle_count == cfg["count"]
    assert ours.pm == theirs.pm and ours.pm2 == theirs.pm2
    assert ours.pairwise == theirs.pairwise
    assert ours.pm_persist is theirs.pm_persist is True
    assert (ours.pmx.capacity, theirs.pmx.capacity) == (147456, 8192)
    assert ours.pmx == dataclasses.replace(theirs.pmx, capacity=147456)
    # the CLI's mouse sits at (0, 0, 48), the example's at the origin:
    # without a drag neither pulls
    ours_params = traffic.sim_params(args)
    assert not ours_params.is_mouse_dragging
    assert dataclasses.replace(
        ours_params, mouse_position=params.mouse_position) == params


def test_the_seeded_scene_fills_the_window_within_the_capacity():
    cfg = _small_config()
    pos, _ = _scene(cfg)
    x, m = pos.double(), torch.ones(COUNT, dtype=torch.float64)
    ref = rpmx.make(cfg, "cpu")
    levels = ref.windows(x, m)
    _, members = ref.exact_window(x, m, levels)
    got = [int(b.sum()) for _, b in levels] + [int(members.sum())]
    # the core is a quarter of the scene, inside the window
    assert got[0] > got[1] > got[2] > COUNT // 4
    assert got[2] <= cfg["pmx"]["capacity"]
    assert not bool((members & ~levels[1][1]).any())   # nested


# -- the reference ------------------------------------------------------------
def _engine(cfg, pos, vel, kernel_path: bool):
    """The configuration's engine (its documented command, small) with
    (pos, vel) installed; ``kernel_path``: the wrappers (their plain
    versions on the CPU) in place of the plain path."""
    from particle_sim_tpu_torch.core.params import Method

    args = traffic.cli_args(cfg, "cpu")
    eng = traffic.build_engine(args)
    init = state.Initial(pos, vel, torch.zeros_like(pos), pos.shape[1],
                         None)
    traffic.installer(eng, init)
    if kernel_path:
        eng.method = Method.CUDA
    return eng, traffic.sim_params(args)


def _steps(eng, params, steps: int = STEPS) -> tuple:
    for _ in range(steps):
        eng.step(params)
    st = eng.state
    n = COUNT
    return (st.pos.reshape(3, -1)[:, :n].clone(),
            st.vel.reshape(3, -1)[:, :n].clone())


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["plain", "wrappers"])
def test_steps_match_the_reference(kernel_path, seed):
    cfg = _small_config()
    pos, vel = _scene(cfg, seed)
    eng, params = _engine(cfg, pos, vel, kernel_path)
    p, v = _steps(eng, params)
    rp, rv, cell = rpmx.make(cfg, "cpu").steps(
        pos, vel, None, dataclasses.asdict(params), STEPS)
    dx = (p.double() - rp).abs().max() / cell
    dv = (v.double() - rv).abs().max() / (rv - vel.double()).abs().max()
    assert float(dx) < TOL and float(dv) < TOL


def test_the_window_moves_the_reference():
    """The exact correction is a large part of the members' field: the
    reference without it (pmn.py's) is far from itself there."""
    from benchmark.reference import pmn

    cfg = _small_config()
    pos, _ = _scene(cfg)
    x, m = pos.double(), torch.ones(COUNT, dtype=torch.float64)
    ref = rpmx.make(cfg, "cpu")
    full = ref.accel(x, m)[0]
    _, members = ref.exact_window(x, m, ref.windows(x, m))
    mesh = pmn.make(cfg, "cpu").accel(x, m)[0]
    rel = ((mesh - full)[:, members].abs().max()
           / full[:, members].abs().max())
    assert float(rel) > 0.1


@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
def test_the_precisions(precision):
    cfg = _small_config()
    pos, _ = _scene(cfg)
    ref = rpmx.make(cfg, "cpu", precision)
    a, cell = ref.accel(ref._cast(pos), ref._cast(torch.ones(COUNT)))
    assert a.dtype == (torch.float64 if precision == "float64"
                       else torch.float32)
    assert float(cell) == 128.0 / 32
    if precision == "bfloat16":
        assert torch.equal(a, a.to(torch.bfloat16).float())


def test_the_reference_raises_past_the_capacity():
    cfg = _small_config(capacity=512)
    pos, _ = _scene(cfg)
    ref = rpmx.make(cfg, "cpu")
    with pytest.raises(ValueError, match="capacity"):
        ref.accel(pos.double(), torch.ones(COUNT, dtype=torch.float64))


def test_the_reference_holds_nothing_of_the_program():
    assert harness.reference_leaks(spec.config(CONFIG)) == []


def test_the_reference_refuses_what_it_does_not_model():
    cfg = spec.config(CONFIG)
    with pytest.raises(ValueError):
        rpmx.make({**cfg, "pmx": {**cfg["pmx"],
                                  "window_min": [0.0, 0.0, 0.0]}}, "cpu")
    with pytest.raises(ValueError):
        rpmx.make({**cfg, "pm2": []}, "cpu")
    with pytest.raises(ValueError):
        rpmx.make(cfg, "cpu").diagnostics(None, None, None)


# -- planted faults -------------------------------------------------------------
def pass_dropped(setattr):
    from particle_sim_tpu_torch.ops import pmx

    exact = pmx.exact_accel

    def dropped(*a, **kw):
        corr, n_m = exact(*a, **kw)
        return torch.zeros_like(corr), n_m

    setattr(pmx, "exact_accel", dropped)


def not_telescoped(setattr):
    """g(eps_x) alone: the subtracted softening so wide that its term is
    0 (g(r; 1e6) ~ 1e-18)."""
    from particle_sim_tpu_torch.ops import pmx

    setattr(pmx, "_eps_prev", lambda cfg, levels: 1.0e6)


def eps_prev_of_the_coarse_mesh(setattr):
    from particle_sim_tpu_torch.ops import pmx

    setattr(pmx, "_eps_prev", lambda cfg, levels: float(cfg.softening))


def origin_not_clamped(setattr):
    from particle_sim_tpu_torch.ops import pm2, pmx

    def unclamped(pos_flat, live, cfgx, levels=(), *, masses=None,
                  coll=None):
        wmins = pm2._nested_wmins(pos_flat, live, None, levels, masses)
        inner = levels[-1]
        lv_live = (pm2._in_window(pos_flat, wmins[-1], inner.window_size,
                                  inner.margin) & live)
        return pm2.window_min(pos_flat, None, cfgx, masses, live=lv_live)

    setattr(pmx, "window_origin", unclamped)


def capacity_cut(setattr):
    """The engine's window holds about half of the members."""
    from particle_sim_tpu_torch.ops import pmx

    exact = pmx.exact_accel

    def cut(pos_flat, live, cfgx, *a, **kw):
        return exact(pos_flat, live, dataclasses.replace(cfgx, capacity=512),
                     *a, **kw)

    setattr(pmx, "exact_accel", cut)


WINDOW_FAULTS = [pass_dropped, not_telescoped, eps_prev_of_the_coarse_mesh,
                 capacity_cut]


def end_numbers(cfg, pos, vel, params, out) -> dict:
    """The end stage's numbers of ``out`` (STEPS steps from (pos, vel))
    by the cell's statistics, against the reference."""
    stats = spec.cell(CELL)["check"]["stats"]["end"]
    pdict = dataclasses.asdict(params)
    rp, rv, cell = rpmx.make(cfg, "cpu").steps(pos, vel, None, pdict, STEPS)
    wit = rpmx.make(cfg, "cpu", "float32").steps(pos, vel, None, pdict,
                                                  STEPS)[:2]
    return check.step_numbers("end", out, (rp, rv), vel, cell, stats, wit)


def start_numbers(cfg, pos, vel, params, out) -> dict:
    stats = spec.cell(CELL)["check"]["stats"]["start"]
    rp, rv, cell = rpmx.make(cfg, "cpu").steps(
        pos, vel, None, dataclasses.asdict(params), STEPS)
    return check.step_numbers("start", out, (rp, rv), vel, cell, stats)


def _verdict(nums) -> bool:
    limits = spec.cell(CELL)["check"]["limits"]
    return check.verdict(nums, {k: limits[k] for k in nums})[0]


def _stages(cfg, pos, vel, plant=None, setattr=None) -> tuple:
    eng, params = _engine(cfg, pos, vel, kernel_path=True)
    if plant is not None:
        plant(setattr)
    out = _steps(eng, params)
    return (start_numbers(cfg, pos, vel, params, out),
            end_numbers(cfg, pos, vel, params, out))


#: The cell's limits are set at 500,000, where the sound start stage reads
#: ~2e-4 cells and every planted fault reads false by them there, but the
#: unclamped origin, whose clamp never binds in that scene (PERF.md §2).
#: At 4,096 the sound gaps are ~100 x smaller and the unmasked gather moves
#: the numbers less (end.vel_vs_f32 ~1.1e4-1.4e4 against 17,000), so here
#: a fault is caught when it lifts a number of each stage to FAULT_RATIO
#: times the sound program's on the same scene (the weakest, the unmasked
#: gather, reads 2,910 x at the start and 9,250 x at the end; the others
#: 8e4-6e5 x).
FAULT_RATIO = 100.0


@functools.lru_cache(maxsize=None)
def _sound(scene: str) -> tuple:
    cfg = _small_config()
    return _stages(cfg, *SCENES[scene]())


def _caught(sound: dict, fault: dict) -> bool:
    return max(fault[k] / max(sound[k], 1e-30) for k in sound) >= FAULT_RATIO


def test_the_sound_kernel_path_reads_true():
    for nums in _sound("scene"):
        assert _verdict(nums), nums


@pytest.mark.parametrize("plant", WINDOW_FAULTS + LEVEL_FAULTS,
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_caught_at_both_stages(plant, monkeypatch):
    sound = _sound("scene")          # before the fault is planted
    cfg = _small_config()
    faulty = _stages(cfg, *_scene(cfg), plant, monkeypatch.setattr)
    for ok, fault in zip(sound, faulty):
        assert _caught(ok, fault), (ok, fault)


def off_centre(n: int = COUNT) -> tuple:
    """(pos, vel): two balls of radius 1 on the x axis, balanced about the
    origin (3,110 at 3.8, 986 at -12), so that the levels centre on the
    origin and level 2's face (x = 4) cuts the first ball: level 2's
    members lie within half the exact window of that face, and the clamp
    moves the window's origin by ~0.45."""
    g = torch.Generator().manual_seed(29)
    k = 3110

    def ball(count, x):
        d = torch.randn((3, count), generator=g)
        d = d / d.norm(dim=0, keepdim=True)
        r = torch.rand(count, generator=g) ** (1.0 / 3.0)
        return d * r + torch.tensor([x, 0.0, 0.0])[:, None]

    pos = torch.cat([ball(k, 3.8), ball(n - k, -12.0)], dim=1)
    return pos, torch.zeros_like(pos)


def test_the_clamp_binds_where_the_core_leans_on_a_face():
    from particle_sim_tpu_torch.ops import pm, pmx

    cfg = _small_config()
    pos, _ = off_centre()
    eng, _ = _engine(cfg, pos, torch.zeros_like(pos), kernel_path=True)
    live = pm.live_mask(COUNT, COUNT, pos.device)
    got = pmx.window_origin(pos, live, eng.pmx, eng.pm2)
    unclamped = {}
    origin_not_clamped(lambda obj, name, fn: unclamped.update(fn=fn))
    free = unclamped["fn"](pos, live, eng.pmx, eng.pm2)
    assert float((free - got).abs().max()) > 0.1


def test_the_unclamped_origin_is_caught_where_the_clamp_binds(monkeypatch):
    sound = _sound("off_centre")
    for nums in sound:
        assert _verdict(nums), nums
    faulty = _stages(_small_config(), *off_centre(), origin_not_clamped,
                     monkeypatch.setattr)
    for ok, fault in zip(sound, faulty):
        assert _caught(ok, fault), (ok, fault)


SCENES = {"scene": lambda: _scene(_small_config()), "off_centre": off_centre}


# -- the metrics ------------------------------------------------------------------
class _Run:
    def __init__(self, view):
        self.trace = view


def test_the_roofline_reader_counts_member_pairs():
    """22 flops a member pair at 67 TFLOP/s over the pair kernel's and the
    slice sum's time inside Engine.step; nothing without the program's
    counter (a tree before it) or without those kernels."""
    from particle_sim_tpu_torch.utils import trace as ptrace

    from benchmark import roofline_pmx
    from benchmark import trace as tr

    pairs = 10 ** 10
    secs = roofline_pmx.diff_flops(pairs) / roofline_pmx.FP32_FLOPS_PER_S
    ops = [("void pairwise_kernel<true>", 0.0, 1.5 * secs, "a"),
           ("void slice_sum_kernel", 1.0, 1.0 + 0.5 * secs, "b"),
           ("void pm_deposit_kernel<false>", 2.0, 2.5, "c")]
    spans = [tr.HostEvent("Engine.step", 0.0, 3.0, 1)]
    view = tr.build_view(ops, {k: [(0.5, 1)] for k in "abc"}, spans, [],
                         0.0, 3.0)
    read = spec.metric_reader("pmx_diff_roofline").read
    ptrace.reset()
    try:
        assert read(_Run(view)) is None
        ptrace.enable()
        ptrace.tally("pmx.member_pairs", torch.tensor(pairs))
        assert read(_Run(view)) == pytest.approx(50.0)
        empty = tr.build_view(ops[2:], {"c": [(0.5, 1)]}, spans, [], 0.0,
                              3.0)
        assert read(_Run(empty)) is None
        assert read(_Run(None)) is None
    finally:
        ptrace.disable()
        ptrace.reset()


# -- the cell ---------------------------------------------------------------------
SMALL = {"count": COUNT, "pm.grid": 32, "cli_argv": SMALL_CLI}


def _readings(device, seconds, overrides=None):
    run = harness.Run(CELL, 2 ** 35 + 17, seconds, False, device,
                      time.perf_counter(), overrides)
    traffic.DRIVERS[run.traffic["kind"]](run)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    nums, cnums = check.judge(run.config, run.cell["check"], run.init,
                              run.params, run.outputs, device,
                              with_control=True)
    return run.cell["check"]["limits"], nums, cnums


def test_the_control_fails_on_the_cpu():
    limits, nums, cnums = _readings("cpu", 1.0, SMALL)
    assert set(nums) == set(limits)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums


@pytest.mark.chip
def test_the_control_fails_on_the_card(card):
    limits, nums, cnums = _readings("cuda", 2.0)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums
