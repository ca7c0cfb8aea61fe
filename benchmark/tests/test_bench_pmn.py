"""The multi-level configuration (``deep_zoom_16m``) and its cell
(``deep_zoom16m.headless``): the documented command, the engine it
builds, the plain reference against the port's plain multi-level step, the
precisions, the control and planted faults in the levels. On the CPU at
4,096 particles on a clustered state made here (grid 32, the
configuration's own windows and softenings: both levels hold members),
and the cell itself at the shared small size; the control also on the
card at the cell's own size (``chip``).

The faults are planted in the kernel path (``ops/pm2.py``
``fine_accel_fast``, which the card runs; the engines here take the
wrappers' plain versions): the second level dropped, the second level's
difference kernel taken against the coarse softening instead of its
parent's (no telescoping), and a level's gather not masked to its
members."""

import dataclasses
import gc
import shlex
import time

import pytest
import torch

from benchmark import check, harness, spec, state, traffic
from benchmark.reference import pmn

CELL, CONFIG = "deep_zoom16m.headless", "deep_zoom_16m"
SEED = 2 ** 36 + 29
COUNT = 4096
SMALL_CLI = ["--count", str(COUNT), "--pm-grid", "32"]
STEPS = 3


@pytest.fixture(autouse=True)
def two_threads():
    torch.set_num_threads(2)


def _small_config():
    cfg = spec.config(CONFIG)
    cfg["count"] = COUNT
    cfg["pm"]["grid"] = 32
    cfg["cli_argv"] = [*cfg["cli_argv"], *SMALL_CLI]
    return cfg


# -- the configuration --------------------------------------------------------
def _docstring_command() -> list:
    """The flags of the deep-zoom example's documented CLI command (its
    module docstring), without ``--device``."""
    from particle_sim_tpu_torch.examples import deep_zoom

    doc = deep_zoom.__doc__.replace("\\\n", " ")
    line = next(ln for ln in doc.splitlines()
                if "particle_sim_tpu_torch.app.cli" in ln)
    words = shlex.split(line)
    argv = words[words.index("-m") + 2:]
    k = argv.index("--device")
    return argv[:k] + argv[k + 2:]


def test_cli_argv_is_the_docstring_command_less_the_device():
    cfg = spec.config(CONFIG)
    assert cfg["cli_argv"] == _docstring_command()
    words = shlex.split(cfg["source"].split(":", 1)[1])
    argv = words[words.index("-m") + 2:]
    k = argv.index("--device")
    assert cfg["cli_argv"] == argv[:k] + argv[k + 2:]
    assert cfg["reduced"] == [] and cfg["assumed"] == {}


def test_the_engine_is_the_configuration():
    from particle_sim_tpu_torch.ops.pm2 import PM2Config

    bench = spec.load_spec()
    cfg = spec.config(CONFIG)
    args = traffic.cli_args(cfg, "cpu")
    assert (args.count, args.central_mass) == (cfg["count"],
                                               cfg["central_mass"])
    engine = traffic.build_engine(traffic.cli_args(_small_config(), "cpu"))
    pm = engine.pm
    assert {"grid": pm.grid, "box_min": list(pm.box_min),
            "box_size": pm.box_size, "softening": pm.softening,
            "boundary": pm.boundary, "gradient": pm.gradient,
            "auto_box": pm.auto_box} == {**cfg["pm"], "grid": 32}
    assert engine.pm2 == tuple(PM2Config(**lv) for lv in cfg["pm2"])
    assert engine.pmx is None
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


def test_the_seeded_state_has_unit_masses():
    init = state.initial(_small_config(), SEED, "cpu")
    assert init.n == COUNT and init.masses is None


# -- the reference ------------------------------------------------------------
def clustered(n: int = COUNT, seed: int = 17) -> tuple:
    """(pos, vel) f32[3, n]: a Gaussian cluster of radius ~3 off the
    origin, at rest, so that both windows hold members."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn((3, n), generator=g) * 3.0
    pos += torch.tensor([1.5, -2.0, 0.7])[:, None]
    return pos, torch.zeros_like(pos)


def _engine(cfg, pos, vel, kernel_path: bool):
    """The configuration's engine (its documented command, small) with
    (pos, vel) installed; ``kernel_path``: the wrappers (their plain
    versions on the CPU) in place of the plain multi-level path."""
    from particle_sim_tpu_torch.core.params import Method

    args = traffic.cli_args(cfg, "cpu")
    eng = traffic.build_engine(args)
    n = pos.shape[1]
    init = state.Initial(pos, vel, torch.zeros_like(pos), n, None)
    traffic.installer(eng, init)
    if kernel_path:
        eng.method = Method.CUDA
    return eng, traffic.sim_params(args)


def _steps(eng, params, steps: int = STEPS) -> tuple:
    for _ in range(steps):
        eng.step(params)
    st = eng.state
    n = st.pos.reshape(3, -1).shape[1]
    return (st.pos.reshape(3, -1)[:, :n].clone(),
            st.vel.reshape(3, -1)[:, :n].clone())


def test_both_levels_hold_members_of_the_cluster():
    pos, _ = clustered()
    x, m = pos.double(), torch.ones(COUNT, dtype=torch.float64)
    got = [int(members.sum()) for _, members
           in pmn.make(_small_config(), "cpu").windows(x, m)]
    assert len(got) == 2 and got[0] > got[1] > COUNT // 4


@pytest.mark.parametrize("kernel_path", [False, True],
                         ids=["plain", "wrappers"])
def test_steps_match_the_plain_multi_level_engine(kernel_path):
    cfg = _small_config()
    pos, vel = clustered()
    eng, params = _engine(cfg, pos, vel, kernel_path)
    p, v = _steps(eng, params)
    ref = pmn.make(cfg, "cpu")
    rp, rv, cell = ref.steps(pos, vel, None, dataclasses.asdict(params),
                             STEPS)
    dx = (p.double() - rp).abs().max() / cell
    dv = (v.double() - rv).abs().max() / rv.abs().max()
    assert float(dx) < 1e-4 and float(dv) < 1e-4


def test_the_levels_move_the_reference():
    """The levels are a large part of the members' field: the reference
    without its second level, or with neither, is far from itself."""
    cfg = _small_config()
    pos, _ = clustered()
    x, m = pos.double(), torch.ones(COUNT, dtype=torch.float64)
    full = pmn.make(cfg, "cpu").accel(x, m)[0]
    for keep in (1, 0):
        cut = pmn.make({**cfg, "pm2": cfg["pm2"][:keep]}, "cpu").accel(x, m)
        rel = (cut[0] - full).abs().max() / full.abs().max()
        assert float(rel) > 0.05, keep


@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
def test_the_precisions(precision):
    cfg = _small_config()
    pos, _ = clustered()
    ref = pmn.make(cfg, "cpu", precision)
    a, cell = ref.accel(ref._cast(pos), ref._cast(torch.ones(COUNT)))
    assert a.dtype == (torch.float64 if precision == "float64"
                       else torch.float32)
    assert float(cell) == 128.0 / 32
    if precision == "bfloat16":
        assert torch.equal(a, a.to(torch.bfloat16).float())


def test_the_reference_holds_nothing_of_the_program():
    assert harness.reference_leaks(spec.config(CONFIG)) == []


def test_the_reference_refuses_what_it_does_not_model():
    cfg = spec.config(CONFIG)
    for lv in ({"window_min": [0.0, 0.0, 0.0]}, {"gradient": "fd"}):
        bad = {**cfg, "pm2": [{**cfg["pm2"][0], **lv}]}
        with pytest.raises(ValueError):
            pmn.make(bad, "cpu")
    with pytest.raises(ValueError):
        pmn.make(cfg, "cpu").diagnostics(None, None, None)


# -- planted faults -------------------------------------------------------------
def drop_the_second_level(setattr):
    from particle_sim_tpu_torch.ops import pm2

    fine = pm2.fine_accel_fast

    def dropped(pos_flat, live, n_active, cfg, cfg2, **kw):
        out = fine(pos_flat, live, n_active, cfg, cfg2, **kw)
        return torch.zeros_like(out) if cfg2.window_size == 8.0 else out

    setattr(pm2, "fine_accel_fast", dropped)


def no_telescoping(setattr):
    from particle_sim_tpu_torch.ops import pm2

    fine = pm2.fine_accel_fast

    def against_the_coarse(pos_flat, live, n_active, cfg, cfg2, **kw):
        if cfg2.window_size == 8.0:
            kw["eps_outer"] = cfg.softening
        return fine(pos_flat, live, n_active, cfg, cfg2, **kw)

    setattr(pm2, "fine_accel_fast", against_the_coarse)


def gather_unmasked(setattr):
    from particle_sim_tpu_torch.ops import pm2, pm_cuda

    class Unmasked:
        """pm_cuda as ops/pm2.py sees it, with a gather to every slot."""

        def __getattr__(self, name):
            return getattr(pm_cuda, name)

        @staticmethod
        def gather(grids, pos, n_active, box_min, cell, *, periodic,
                   live=None):
            return pm_cuda.gather(grids, pos, n_active, box_min, cell,
                                  periodic=periodic)

    setattr(pm2, "pm_cuda", Unmasked())


FAULTS = [drop_the_second_level, no_telescoping, gather_unmasked]


def end_numbers(cfg, pos, vel, params, out) -> dict:
    """The end stage's numbers of ``out`` (STEPS steps from (pos, vel))
    by the cell's statistics, against the reference."""
    stats = spec.cell(CELL)["check"]["stats"]["end"]
    pdict = dataclasses.asdict(params)
    rp, rv, cell = pmn.make(cfg, "cpu").steps(pos, vel, None, pdict, STEPS)
    wit = pmn.make(cfg, "cpu", "float32").steps(pos, vel, None, pdict,
                                                 STEPS)[:2]
    return check.step_numbers("end", out, (rp, rv), vel, cell, stats, wit)


def _verdict(nums) -> bool:
    limits = spec.cell(CELL)["check"]["limits"]
    return check.verdict(nums, {k: limits[k] for k in nums})[0]


def test_the_sound_kernel_path_reads_true_where_the_levels_hold_members():
    cfg = _small_config()
    pos, vel = clustered()
    eng, params = _engine(cfg, pos, vel, kernel_path=True)
    nums = end_numbers(cfg, pos, vel, params, _steps(eng, params))
    assert _verdict(nums), nums


@pytest.mark.parametrize("plant", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_in_the_levels_reads_false(plant, monkeypatch):
    cfg = _small_config()
    pos, vel = clustered()
    eng, params = _engine(cfg, pos, vel, kernel_path=True)
    plant(monkeypatch.setattr)
    nums = end_numbers(cfg, pos, vel, params, _steps(eng, params))
    assert not _verdict(nums), nums


# -- the cell ---------------------------------------------------------------------
SMALL = {"count": 16384, "pm.grid": 32,
         "cli_argv": ["--count", "16384", "--pm-grid", "32"]}


def _readings(device, seconds, overrides=None):
    run = harness.Run(CELL, 2 ** 34 + 21, seconds, False, device,
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
