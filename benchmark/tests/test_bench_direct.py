"""The direct-sum configuration (``direct_65k``) and its cell
(``direct65k.headless``): the plain reference against a float64 double
loop, the documented command, the engine it builds, a sound run, the
control and planted faults. On the CPU at 2,048 particles (the shared
``small`` fixture sets ``pm.grid``, which this configuration has no key
for); the control also on the card at the cell's own size (``chip``)."""

import dataclasses
import gc
import math
import shlex
import time

import pytest
import torch

from benchmark import check, harness, spec, state, traffic
from benchmark.reference import direct

CELL, CONFIG = "direct65k.headless", "direct_65k"
SMALL = {"count": 2048, "cli_argv": ["--count", "2048"]}
SEED = 2 ** 35 + 17
RENDER_FLAGS = {"--renderer": "sorted", "--render-every": "100",
                "--render-dir": "frames"}


@pytest.fixture(autouse=True)
def two_threads():
    torch.set_num_threads(2)


def _run(overrides=SMALL):
    return harness.run_cell(CELL, SEED, 1.0, False, device="cpu",
                            overrides=overrides)


# -- the reference ----------------------------------------------------------
def _double_loop(x, m, g, eps):
    """a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^1.5, in
    Python floats (float64), one pair at a time."""
    n = len(x)
    out = []
    for i in range(n):
        ax = ay = az = 0.0
        xi, yi, zi = x[i]
        for j in range(n):
            dx, dy, dz = x[j][0] - xi, x[j][1] - yi, x[j][2] - zi
            w = g * m[j] / math.pow(dx * dx + dy * dy + dz * dz + eps * eps,
                                    1.5)
            ax += w * dx
            ay += w * dy
            az += w * dz
        out.append((ax, ay, az))
    return torch.tensor(out, dtype=torch.float64).T


def test_the_reference_force_is_the_double_loop(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    n = 512
    x = (torch.rand((3, n), generator=gen, dtype=torch.float64) - 0.5) * 40.0
    m = torch.rand(n, generator=gen, dtype=torch.float64) + 0.5
    m[0] = 1000.0
    cfg = {**spec.config(CONFIG), "g_const": 0.7, "softening": 0.4}
    # several receiver blocks, the last one short
    monkeypatch.setattr(direct, "BLOCK_PAIRS", 200 * n)
    a, unit = direct.make(cfg, "cpu").accel(x, m)
    want = _double_loop(x.T.tolist(), m.tolist(), 0.7, 0.4)
    assert unit == 0.4
    assert float((a - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_the_reference_steps_kick_by_the_force_and_keep_the_unit():
    cfg = {**spec.config(CONFIG), "count": SMALL["count"]}
    init = state.initial(cfg, SEED, "cpu")
    n = init.n
    params = dataclasses.asdict(traffic.sim_params(
        traffic.cli_args({**cfg, "cli_argv": [*cfg["cli_argv"],
                                              *SMALL["cli_argv"]]}, "cpu")))
    ref = direct.make(cfg, "cpu")
    p, v, unit = ref.steps(init.pos[:, :n], init.vel[:, :n], init.masses,
                           params, 1)
    a, _ = ref.accel(init.pos[:, :n].double(), init.masses[:n].double())
    # from rest with no mouse drag and no gravity: v = a dt damped
    dt, damping = params["delta_time"], params["damping"]
    assert unit == cfg["softening"]
    assert torch.allclose(v, a * dt * damping, rtol=1e-12, atol=0.0)
    assert torch.allclose(p, init.pos[:, :n].double() + a * dt * dt,
                          rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
def test_the_precisions(precision):
    cfg = {**spec.config(CONFIG), "count": 256}
    init = state.initial(cfg, SEED, "cpu")
    ref = direct.make(cfg, "cpu", precision)
    a, _ = ref.accel(ref._cast(init.pos), ref._cast(init.masses))
    assert a.dtype == (torch.float64 if precision == "float64"
                       else torch.float32)
    if precision == "bfloat16":
        assert torch.equal(a, a.to(torch.bfloat16).float())


def test_the_reference_holds_nothing_of_the_program():
    assert harness.reference_leaks(spec.config(CONFIG)) == []


def test_the_reference_takes_no_diagnostics():
    with pytest.raises(ValueError):
        direct.make(spec.config(CONFIG), "cpu").diagnostics(None, None, None)


# -- the configuration --------------------------------------------------------
def test_cli_argv_is_the_readme_command_less_the_render_flags():
    cfg = spec.config(CONFIG)
    words = shlex.split(cfg["source"].split(":", 1)[1])
    argv = words[words.index("python") + 3:]
    k = argv.index("--device")
    argv = argv[:k] + argv[k + 2:]
    for flag, value in RENDER_FLAGS.items():
        k = argv.index(flag)
        assert argv[k + 1] == value
        argv = argv[:k] + argv[k + 2:]
    assert cfg["cli_argv"] == argv
    assert set(cfg["assumed"]) == {"render_flags"}
    assert cfg["reduced"] == []


def test_the_engine_is_the_configuration():
    bench = spec.load_spec()
    cfg = spec.config(CONFIG)
    args = traffic.cli_args(cfg, "cpu")
    assert (args.count, args.central_mass) == (cfg["count"],
                                               cfg["central_mass"])
    assert (args.pairwise_g, args.pairwise_softening) == (cfg["g_const"],
                                                          cfg["softening"])
    assert "pm" not in cfg
    engine = traffic.build_engine(traffic.cli_args(
        {**cfg, "cli_argv": [*cfg["cli_argv"], *SMALL["cli_argv"]]}, "cpu"))
    assert engine.pm is None and engine.pm2 is None and engine.pmx is None
    assert (engine.pairwise.gravitational_constant,
            engine.pairwise.softening) == (1.0, 0.5)
    cells = [w for w in bench["workloads"] if w["config"] == CONFIG]
    assert [w["name"] for w in cells] == [CELL]
    tr = spec.traffic(cells[0]["traffic"])
    assert (tr["kind"], tr["steps_per_run"], tr["stats_every"],
            tr["diagnostics"]) == ("headless", args.steps,
                                   args.stats_every, args.diagnostics)


def test_the_seeded_state_carries_the_central_mass():
    init = state.initial({**spec.config(CONFIG), **SMALL}, SEED, "cpu")
    assert init.n == 2048 and init.pos.shape == (3, 2048)
    assert float(init.masses[0]) == 1000.0
    assert float(init.masses[1:].sum()) == 2047.0


# -- runs ------------------------------------------------------------------
def test_sound_cpu_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["check"]) == set(spec.cell(CELL)["check"]["limits"])


def _readings(device, seconds, overrides=None):
    run = harness.Run(CELL, 2 ** 34 + 9, seconds, False, device,
                      time.perf_counter(), overrides)
    traffic.DRIVERS[run.traffic["kind"]](run)
    gc.collect()
    nums, cnums = check.judge(run.config, run.cell["check"], run.init,
                              run.params, run.outputs, device,
                              with_control=True)
    return run.cell["check"]["limits"], nums, cnums


def test_the_control_fails_on_the_cpu():
    limits, nums, cnums = _readings("cpu", 1.0, SMALL)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums


@pytest.mark.chip
def test_the_control_fails_on_the_card(card):
    limits, nums, cnums = _readings("cuda", 2.0)
    assert check.verdict(nums, limits)[0], nums
    assert not check.verdict(cnums, limits)[0], cnums


def _drop_central_mass(monkeypatch):
    from particle_sim_tpu_torch.engine import Engine

    monkeypatch.setattr(Engine, "_masses_for_capacity", lambda self: None)


def _leave_out_half_the_sources(monkeypatch):
    from particle_sim_tpu_torch.ops import pairwise

    accel = pairwise.pairwise_accel

    def half(x_nx3, x_3xn, *args, n_j=None, **kwargs):
        return accel(x_nx3, x_3xn, *args, n_j=x_3xn.shape[1] // 2, **kwargs)

    monkeypatch.setattr(pairwise, "pairwise_accel", half)


def _return_the_state_unchanged(monkeypatch):
    from particle_sim_tpu_torch.engine import Engine

    monkeypatch.setattr(Engine, "step",
                        lambda self, params: self.stats.frame_tick())


@pytest.mark.parametrize("plant", [_drop_central_mass,
                                   _leave_out_half_the_sources,
                                   _return_the_state_unchanged],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_reads_false(plant, monkeypatch):
    plant(monkeypatch)
    assert not _run()["correct"]
