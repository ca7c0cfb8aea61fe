"""The port's particle-mesh path as a whole — Engine(pm=...), checkpoints,
the CLI's --pm and --diagnostics, the server's "pm" solver event — against
the JAX package's, on the plain CPU path (after tests/test_pm_engine.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import checkpoint as jckpt

from particle_sim_tpu_torch.app import cli, server
from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.io import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PMConfig(grid=32, softening=4.0)


def make_engine(n=2048, **kw):
    return Engine(particle_count=n, device="cpu", method=Method.TORCH, **kw)


def test_engine_pm_collapses_cloud():
    e = make_engine(4096, generation_mode=SphereGeneration.FILLED,
                    pairwise=PairwiseParams(2.0, CFG.softening), pm=CFG)
    params = SimParams(delta_time=0.02)
    r0 = np.linalg.norm(e.state.positions(), axis=1).mean()
    for _ in range(15):
        e.step(params)
    r1 = np.linalg.norm(e.state.positions(), axis=1).mean()
    assert np.isfinite(r1) and r1 < r0


def test_engine_pm_defaults_pairwise():
    e = make_engine(1024, pm=CFG)
    assert e.pairwise == PairwiseParams(1.0, CFG.softening)
    assert e.pm_persist == "auto" and e.persist_resolved() is False
    assert make_engine(1024, pm=CFG, pm_persist=False).pm_persist is False
    with pytest.raises(ValueError, match="pm_persist"):
        make_engine(1024, pm=CFG, pm_persist="always")


@pytest.mark.parametrize("cfg,masses,substeps", [
    (PMConfig(grid=32, softening=4.0), False, 1),
    (PMConfig(grid=32, softening=4.0, boundary="periodic", gradient="fd"),
     True, 2),
    (PMConfig(grid=32, softening=2.0, auto_box=True), True, 1),
    (PMConfig(grid=48, softening=4.0), False, 1)])
def test_engine_pm_matches_jax(cfg, masses, substeps):
    """Engine(pm=..., masses=...) steps to the JAX engine's state."""
    n = 3000
    m = None
    if masses:
        m = np.ones(n, np.float32)
        m[0] = 500.0
    je = JEngine(particle_count=n, method=JMethod.JNP, substeps=substeps,
                 pairwise=JPairwise(1.5, cfg.softening),
                 pm=JPM(**cfg.__dict__), masses=m)
    te = make_engine(n, substeps=substeps,
                     pairwise=PairwiseParams(1.5, cfg.softening), pm=cfg,
                     masses=m)
    jp = JSimParams(delta_time=0.02, gravity=0.3)
    tp = SimParams(delta_time=0.02, gravity=0.3)
    for _ in range(3):
        je.step(jp)
        te.step(tp)
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.state.velocities(), je.state.velocities(),
                               rtol=1e-4, atol=1e-5)


def test_engine_pm_grid_without_kernels_and_resize():
    """A grid the TPU kernels do not take (48) steps on the same path as
    any other; masses stay across resizes; the solver may be swapped
    between steps."""
    e = make_engine(1500, pm=PMConfig(grid=48, softening=4.0),
                    masses=np.full(1500, 2.0, np.float32))
    e.step(SimParams(delta_time=0.02))
    e.resize(2500)
    assert float(e.masses[0]) == 2.0 and float(e.masses[2000]) == 1.0
    e.step(SimParams(delta_time=0.02))
    e.pm = None
    e.step(SimParams(delta_time=0.02))                 # the direct sum
    assert np.isfinite(e.state.positions()).all()


def test_engine_diagnostics_matches_jax():
    n = 2000
    je = JEngine(particle_count=n, method=JMethod.JNP,
                 generation_mode=SphereGeneration.FILLED,
                 pairwise=JPairwise(0.5, 3.0), pm=JPM(grid=32, softening=3.0))
    te = make_engine(n, generation_mode=SphereGeneration.FILLED,
                     pairwise=PairwiseParams(0.5, 3.0),
                     pm=PMConfig(grid=32, softening=3.0))
    for _ in range(2):
        je.step(JSimParams(delta_time=0.01))
        te.step(SimParams(delta_time=0.01))
    jd = je.diagnostics(potential=True).as_dict()
    td = te.diagnostics(potential=True).as_dict()
    for k in ("kinetic", "potential", "total_energy", "mean_radius",
              "max_speed"):
        assert td[k] == pytest.approx(jd[k], rel=1e-4), k
    assert make_engine(300).diagnostics(potential=True).potential is None


# -- checkpoints ---------------------------------------------------------------------
def test_checkpoint_pm_jax_to_port(tmp_path):
    path = str(tmp_path / "j.npz")
    cfg = JPM(grid=32, softening=3.0, boundary="periodic", gradient="fd",
              box_min=(-60.0, -50.0, -70.0), box_size=130.0)
    je = JEngine(particle_count=777, method=JMethod.JNP, pm=cfg)
    je.step(JSimParams())
    jckpt.save(path, je, step_index=5)
    te, idx = ckpt.load(path, device="cpu")
    assert idx == 5 and te.pm == PMConfig(**cfg.__dict__)
    assert te.pairwise == PairwiseParams(1.0, 3.0)
    np.testing.assert_array_equal(te.state.positions(), je.state.positions())
    je.step(JSimParams())
    te.step(SimParams())          # the resumed engine steps with the pm solver
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               atol=1e-5)


def test_checkpoint_pm_port_to_jax(tmp_path):
    path_t, path_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    m = np.linspace(0.5, 2.0, 900).astype(np.float32)
    te = make_engine(900, pm=PMConfig(grid=64, softening=3.0, auto_box=True),
                     pairwise=PairwiseParams(0.7, 3.0), masses=m)
    te.step(SimParams())
    ckpt.save(path_t, te, step_index=1)
    je, idx = jckpt.load(path_t)
    assert idx == 1 and je.pm == JPM(grid=64, softening=3.0, auto_box=True)
    assert je.pairwise == JPairwise(0.7, 3.0)
    jckpt.save(path_j, je, step_index=1)
    meta = [json.loads(str(np.load(p)["meta"])) for p in (path_t, path_j)]
    assert meta[0] == meta[1] and meta[0]["pm"]["auto_box"] is True
    te2, _ = ckpt.load(path_t, device="cpu")
    assert te2.pm == te.pm and te2.pm_persist == "auto"
    np.testing.assert_array_equal(te2.masses[:900].numpy(), m)


# -- the CLI -----------------------------------------------------------------------------
def test_cli_pm_run(tmp_path, capsys):
    path = str(tmp_path / "c.npz")
    rc = cli.main(["--device", "cpu", "--count", "2000", "--steps", "3",
                   "--pm", "--pm-grid", "32", "--pairwise-g", "1.0",
                   "--pm-softening", "4.0", "--stats-every", "0",
                   "--checkpoint-every", "3", "--checkpoint", path])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["done"] is True and final["steps"] == 3
    e, _ = ckpt.load(path, device="cpu")
    assert e.pm == PMConfig(grid=32, softening=4.0)
    assert e.pairwise == PairwiseParams(1.0, 4.0)


@pytest.mark.parametrize("flags", [
    ["--pairwise", "--pairwise-g", "0.5", "--pairwise-softening", "3.0"],
    ["--pm", "--pm-auto-box", "--pm-grid", "32", "--pairwise-g", "0.08",
     "--dt", "0.004"],
    ["--pm", "--pm-grid", "32", "--central-mass", "100", "--pm-boundary",
     "periodic", "--pm-gradient", "fd"]])
def test_cli_diagnostics_line(flags, capsys):
    """--diagnostics adds the physics observables to the stats lines: the
    direct potential at 1500 particles, the mesh one at 13,000."""
    count = "13000" if "--pm" in flags else "1500"
    rc = cli.main(["--device", "cpu", "--count", count, "--steps", "4",
                   "--stats-every", "2", "--diagnostics", *flags])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    stats = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in stats] == [2, 4]
    for ln in stats:
        assert ln["kinetic"] > 0 and ln["total_energy"] is not None
        assert ln["potential"] < 0 and len(ln["momentum"]) == 3
    assert lines[-1]["done"] is True


def test_port_pm_path_imports_no_jax(tmp_path):
    """The PM CLI path, diagnostics, the server's pm event and the pm2 /
    pmx paths (the CLI's flags, the server's stack and window fields, a
    checkpoint of both) run without importing jax."""
    script = (
        "import sys\n"
        "from particle_sim_tpu_torch.app import cli, server\n"
        "from particle_sim_tpu_torch.ops import diagnostics, pm, pm_cuda\n"
        "from particle_sim_tpu_torch.ops import pm2, pmx\n"
        "from particle_sim_tpu_torch.io import checkpoint\n"
        "s = server.make_server(['--device', 'cpu', '--count', '1024',"
        " '--pm'])\n"
        "s.handle_event({'type': 'solver', 'name': 'pm', 'g': 1.0,"
        " 'softening': 3.0})\n"
        "assert s.hello()['solver'] == 'pm'\n"
        "s.handle_event({'type': 'solver', 'name': 'pm', 'g': 1.0,"
        " 'softening': 3.0, 'pm2_sizes': [32], 'pm2_softenings': [0.75],"
        " 'pmx_size': 8})\n"
        "assert s.hello()['pm2_sizes'] == [32.0]\n"
        "assert s.hello()['pmx_size'] == 8.0\n"
        "cli.main(['--device', 'cpu', '--count', '1024', '--steps', '2',"
        " '--pm', '--pm-grid', '32', '--diagnostics', '--stats-every', '2'])\n"
        "cli.main(['--device', 'cpu', '--count', '1024', '--steps', '2',"
        " '--pm-grid', '32', '--pm-softening', '3', '--pm2-size', '32', '8',"
        " '--pm2-softening', '0.75', '0.25', '--pmx-size', '4',"
        " '--pmx-capacity', '1024', '--stats-every', '0',"
        " '--checkpoint-every', '2', '--checkpoint', 'c.npz'])\n"
        "e, _ = checkpoint.load('c.npz', device='cpu')\n"
        "assert len(e.pm2) == 2 and e.pmx.window_size == 4.0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'particle_sim_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout


# -- the server -------------------------------------------------------------------------
def test_server_pm_event_over_the_wire(monkeypatch):
    """A "pm" solver event with a seq switches the running server's engine
    to the particle mesh; a later frame reflects the seq, the engine steps
    under PM gravity, and a new client's hello says "pm". (The event's
    solver takes the default 128^3 grid, ~1.3 s a step on one CPU core;
    the test builds it at 32^3.)"""
    import functools

    from test_torch_server import WsClient, header, wait_for_frame

    monkeypatch.setattr(server, "PMConfig",
                        functools.partial(PMConfig, grid=32))
    eng = make_engine(2048)
    srv = server.StreamServer(eng, port=0, target_fps=30)
    srv.start()
    try:
        c = WsClient(srv.port)
        assert c.text()["solver"] == "off"
        c.binary()
        c.send({"type": "solver", "name": "pm", "g": 1.0, "softening": 3.0,
                "seq": 4})
        frame = wait_for_frame(c, lambda f: header(f)[7] >= 4)
        assert header(frame)[7] == 4
        c.close()
        assert eng.pm == PMConfig(grid=32, softening=3.0)
        c2 = WsClient(srv.port)
        hello = c2.text()
        c2.close()
        assert hello["solver"] == "pm" and hello["solver_softening"] == 3.0
    finally:
        srv.stop()
    assert np.isfinite(eng.state.positions()).all()
