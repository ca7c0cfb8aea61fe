"""Engine(pm_persist=...) in the port against the JAX package's, on the CPU:
the port's side of tests/test_engine_persist.py (its three mesh tests are
in tests/test_torch_engine_mesh.py). Outputs stay in
identity order, lifecycle changes drop the sorted mirror, the frame and
the stream read the sorted planes without an un-sort, checkpoints cross
between the packages, and the flags reach the CLI and the server. On the
CPU the engine runs the plain path (Method.TORCH); the kernels' side is
chip_smoke.py phase 19. G = 32, 2,000 particles."""

import json

import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import checkpoint as jckpt

from particle_sim_tpu_torch.app import cli, server
from particle_sim_tpu_torch.core.params import Method, PMConfig, SimParams
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.engine import engine as eng_mod
from particle_sim_tpu_torch.io import checkpoint as ckpt
from particle_sim_tpu_torch.ops import pm2, pm_persist, pmx
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

CFG = PMConfig(grid=32, softening=4.0)
PARAMS = SimParams(delta_time=0.016, gravity=0.0)


def engine(persist, n=2000, **kw):
    return Engine(particle_count=n, device="cpu", pm=CFG,
                  pm_persist=persist, **kw)


def test_trajectory_matches_jax_and_per_frame():
    """Three persistent frames against the JAX persistent engine
    (interpret mode; 5e-3 as tests/test_engine_persist.py: the TPU
    kernels' quantization per kick) and the port's per-frame engine (the
    same f32 arithmetic: 1e-5)."""
    e_per, e_ref = engine(True), engine(False)
    je = JEngine(particle_count=2000, method=JMethod.PALLAS,
                 pm=JPM(grid=32, softening=4.0), interpret=True,
                 pm_persist=True)
    p0 = e_per.state.positions().copy()
    jp = JSimParams(delta_time=0.016, gravity=0.0)
    for _ in range(3):
        e_per.step(PARAMS)
        e_ref.step(PARAMS)
        je.step(jp)
    assert e_per.persist_resolved() and e_per._identity_dirty
    p_per = e_per.state.positions()          # rebuilds the identity order
    assert not e_per._identity_dirty
    moved = np.abs(e_ref.state.positions() - p0).max()
    assert moved > 0.0
    np.testing.assert_allclose(p_per, e_ref.state.positions(), rtol=0,
                               atol=1e-5)
    err = np.abs(p_per - je.state.positions()).max()
    assert err < 5e-3 and err < 0.25 * moved


def test_frame_arrays_pairing():
    """The stream comes from the sorted planes (no un-sort), each point
    with its own colour: undone by the mirror's ids it equals the
    identity-order stream."""
    e_per, e_ref = engine(True), engine(False)
    e_per.step(PARAMS)
    e_ref.step(PARAMS)
    pos_p, rgba_p = e_per.frame_arrays(PARAMS)
    pos_r, rgba_r = e_ref.frame_arrays(PARAMS)
    assert e_per._identity_dirty             # no un-sort was paid
    n = pos_p.shape[1]
    ids = e_per._persist.ids.numpy()[:n]
    assert sorted(ids) == list(range(n))     # live slots are a prefix
    pos_pi = np.zeros_like(pos_p)
    pos_pi[:, ids] = pos_p
    rgba_pi = np.zeros_like(rgba_p)
    rgba_pi[ids] = rgba_p
    np.testing.assert_allclose(pos_pi, pos_r, rtol=0, atol=1e-5)
    assert np.abs(rgba_pi.astype(int) - rgba_r.astype(int)).max() <= 1


def test_resize_and_reset_invalidate_mirror():
    e = engine(True)
    e.step(PARAMS)
    assert e._persist is not None
    e.resize(2600)
    assert e._persist is None and e.particle_count == 2600
    e.step(PARAMS)
    assert e._persist is not None
    e.reset()
    assert e._persist is None
    e.step(PARAMS)
    e.set_masses(np.ones(2600, np.float32))
    assert e._persist is None
    e.step(PARAMS)
    e.state = e.state                        # assignment drops it too
    assert e._persist is None
    assert torch.isfinite(e.state.pos).all()


def test_solver_switch_falls_back():
    """Clearing the PM mid-run (the server's "off" event) rebuilds the
    identity order once and goes on with the attractor."""
    e = engine(True)
    e.step(PARAMS)
    before = e.state.positions().copy()
    e._identity_dirty = True                 # the mirror is current
    e.pm = None
    e.step(SimParams(delta_time=0.0))
    assert not e._identity_dirty and e._persist is None
    np.testing.assert_array_equal(e.state.positions(), before)


def test_checkpoint_roundtrip_identity(tmp_path):
    e = engine(True)
    e.step(PARAMS)
    path = str(tmp_path / "per.npz")
    ckpt.save(path, e, step_index=1)
    e2, step = ckpt.load(path, device="cpu")
    assert step == 1 and e2.pm_persist is True
    np.testing.assert_array_equal(e2.state.positions(),
                                  e.state.positions())
    e2.step(PARAMS)
    assert e2.persist_resolved()


def test_checkpoint_across_packages(tmp_path):
    """A "pm_persist": true checkpoint from either package resumes in the
    other."""
    path_j, path_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    je = JEngine(particle_count=1500, method=JMethod.JNP,
                 pm=JPM(grid=32, softening=4.0), pm_persist=True)
    jckpt.save(path_j, je, step_index=4)
    te, idx = ckpt.load(path_j, device="cpu")
    assert idx == 4 and te.pm_persist is True and te.pm == CFG
    np.testing.assert_array_equal(te.state.positions(),
                                  je.state.positions())
    te.step(PARAMS)
    ckpt.save(path_t, te, step_index=5)
    je2, idx2 = jckpt.load(path_t)
    assert idx2 == 5 and je2.pm_persist is True
    np.testing.assert_array_equal(je2.state.positions(),
                                  te.state.positions())


def test_two_tier_flag_plumbs(tmp_path, capsys):
    """two_tier rides the engine, checkpoints, the CLI and the server
    (every repair of the port is the full sort: the flag selects no
    path)."""
    e_full = engine(True, two_tier=False)
    assert engine(True).two_tier and not e_full.two_tier
    path = str(tmp_path / "full.npz")
    ckpt.save(path, e_full, step_index=0)
    e2, _ = ckpt.load(path, device="cpu")
    assert e2.two_tier is False and e2.pm_persist is True
    out = str(tmp_path / "cli.npz")
    assert cli.main(["--device", "cpu", "--count", "1500", "--steps", "2",
                     "--pm-persist", "--pm-grid", "32", "--no-two-tier",
                     "--stats-every", "0", "--checkpoint-every", "2",
                     "--checkpoint", out]) == 0
    with np.load(out) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["two_tier"] is False and meta["pm_persist"] is True
    srv = server.make_server(["--device", "cpu", "--count", "1024",
                              "--pm-persist", "--no-two-tier"])
    assert srv.hello()["two_tier"] is False
    srv.handle_event({"type": "solver", "name": "pm_persist",
                      "two_tier": True})
    assert srv.engine.two_tier is True and srv.engine.pm_persist is True


def test_two_tier_false_matches_trajectory():
    e_tt, e_full = engine(True), engine(True, two_tier=False)
    for _ in range(2):
        e_tt.step(PARAMS)
        e_full.step(PARAMS)
    np.testing.assert_array_equal(e_full.state.positions(),
                                  e_tt.state.positions())


def test_pm_persist_auto_crossover(monkeypatch):
    """"auto" resolves from the count against PERSIST_AUTO_MIN_N (the
    H100's crossover), re-evaluated every step; never with pm2 or pmx;
    never when the threshold is None."""
    e = Engine(particle_count=2000, device="cpu", pm=CFG)
    assert e.pm_persist == "auto" and not e.persist_resolved()
    assert eng_mod.PERSIST_AUTO_MIN_N > 2000
    e.step(PARAMS)
    assert e._persist is None
    monkeypatch.setattr(eng_mod, "PERSIST_AUTO_MIN_N", 1500)
    assert e.persist_resolved()
    e.step(PARAMS)
    assert e._persist is not None
    e.resize(1024)
    assert not e.persist_resolved()
    e.step(PARAMS)
    assert e._persist is None
    e.set_pm2(pm2.PM2Config(window_min=None, window_size=32.0,
                            softening=1.0))
    e.resize(2000)
    assert not e.persist_resolved()            # auto never runs pm2
    monkeypatch.setattr(eng_mod, "PERSIST_AUTO_MIN_N", None)
    e.set_pm2(None)
    assert not e.persist_resolved()
    assert torch.isfinite(e.state.pos).all()


@pytest.mark.parametrize("kw, match", [
    (dict(pm=None), "PMConfig"),
    (dict(pm=PMConfig(grid=32, softening=2.0, auto_box=True)),
     "static box"),
    (dict(pm=PMConfig(grid=48, softening=2.0)), "grid"),
    (dict(pm=CFG, pmx=pmx.PMXConfig(window_size=4.0, softening=0.1,
                                    capacity=1024)), "MULTI-level"),
])
def test_rejects_bad_config(kw, match):
    with pytest.raises(ValueError, match=match):
        Engine(particle_count=1000, device="cpu", pm_persist=True, **kw)


def test_swaps_keep_the_pmx_rule():
    """With pm_persist=True an exact window needs a multi-level stack at
    every swap, as the JAX engine checks."""
    lv = (pm2.PM2Config(None, 32.0, 1.0), pm2.PM2Config(None, 8.0, 0.4))
    window = pmx.PMXConfig(window_size=4.0, softening=0.1, capacity=1024)
    e = engine(True, pm2=lv, pmx=window)
    with pytest.raises(ValueError, match="MULTI-level"):
        e.set_pm2(lv[0])
    assert e.pm2 == lv
    e.set_pmx(None)
    e.set_pm2(lv[0])
    with pytest.raises(ValueError, match="MULTI-level"):
        e.set_pmx(window)


def test_multi_level_pmx_engine_matches_per_frame():
    """The examples/deep_zoom.py composition (a pm2 tuple, pm_persist,
    pmx) steps like the per-frame pmn / pmx engine, and reports the
    same member counts."""
    lv = (pm2.PM2Config(None, 32.0, 1.0), pm2.PM2Config(None, 8.0, 0.4))
    window = pmx.PMXConfig(window_size=4.0, softening=0.1, capacity=2048)
    e_per = engine(True, pm2=lv, pmx=window)
    e_ref = engine(False, pm2=lv, pmx=window)
    assert e_ref.pm_persist is False
    for _ in range(2):
        e_per.step(PARAMS)
        e_ref.step(PARAMS)
    assert e_per.persist_resolved() and e_per._persist.fine_b.shape == (2,)
    assert e_per.pmx_member_count() == e_ref.pmx_member_count()
    np.testing.assert_allclose(e_per.state.positions(),
                               e_ref.state.positions(), rtol=0, atol=1e-5)


def test_multi_level_pmx_engine_matches_jax():
    """The examples/deep_zoom.py composition against the JAX engine with
    the same stack, window and pm_persist=True (interpret mode), two
    frames from a clump in a halo: the member counts equal; velocities
    within 0.02 of the velocity change and positions within 0.02 of the
    velocity change times the elapsed time (tests/test_torch_pmx.py's
    engine bars: the TPU kernels' quantization of the mesh force)."""
    from particle_sim_tpu.core.state import ParticleState as JState
    from particle_sim_tpu.ops import pm2 as jpm2
    from particle_sim_tpu.ops import pmx as jpmx

    from particle_sim_tpu_torch.core.state import ParticleState

    rng = np.random.default_rng(17)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + np.float32(off)

    pos = np.concatenate([ball(700, 3.0, (5.0, 4.0, -3.0)),
                          ball(1300, 40.0, (0.0, 0.0, 0.0))])
    lv = ((32.0, 1.0), (8.0, 0.4))
    window = dict(window_size=4.0, softening=0.1, capacity=1024)
    je = JEngine(particle_count=2000, method=JMethod.PALLAS,
                 pm=JPM(grid=32, softening=4.0), interpret=True,
                 pm2=tuple(jpm2.PM2Config(None, w, s) for w, s in lv),
                 pmx=jpmx.PMXConfig(**window), pm_persist=True)
    je.state = JState.from_arrays(pos, np.zeros_like(pos),
                                  np.full_like(pos, 0.5),
                                  capacity=je.capacity)
    e = engine(True, pm2=tuple(pm2.PM2Config(None, w, s) for w, s in lv),
               pmx=pmx.PMXConfig(**window))
    e.state = ParticleState.from_arrays(pos, np.zeros_like(pos),
                                        np.full_like(pos, 0.5),
                                        device="cpu", capacity=e.capacity)
    jp = JSimParams(delta_time=0.016, gravity=0.0)
    for _ in range(2):
        je.step(jp)
        e.step(PARAMS)
    assert e.persist_resolved() and je.persist_resolved()
    n_mem, n_corr = e.pmx_member_count()
    assert 0 < n_mem == n_corr and (n_mem, n_corr) == je.pmx_member_count()
    jv = je.state.velocities()
    dv = np.abs(jv).max()
    assert dv > 0.0
    assert np.abs(e.state.velocities() - jv).max() <= 0.02 * dv
    assert np.abs(e.state.positions() - je.state.positions()).max() \
        <= 0.02 * dv * 2 * PARAMS.delta_time


def test_repair_fires_one_check_late(monkeypatch):
    """The engine decides repairs without waiting for the device: a
    verdict measured after a frame's step is read at a later frame. With
    a check every frame, a scrambled mirror steps once unrepaired, and
    the next frame repairs it."""
    monkeypatch.setattr(pm_persist, "CHECK_EVERY", 1)
    e = engine(True)
    e.step(PARAMS)                         # makes the mirror, sorted
    assert e.resorts == 0
    st = e._persist
    perm = torch.from_numpy(np.random.default_rng(3).permutation(
        st.pos.shape[1]))
    e._persist = st._replace(pos=st.pos[:, perm], vel=st.vel[:, perm],
                             ids=st.ids[perm], col24=st.col24[perm])
    e.step(PARAMS)                         # the verdict read was clean
    assert e.resorts == 0
    e.step(PARAMS)                         # this one reads "scrambled"
    assert e.resorts == 1
    keys = pm_persist.state_keys(e._persist, e.particle_count, CFG)
    assert int(pm_persist.disorder(keys)) < 0.01 * e.particle_count


def test_multi_level_mirror_starts_in_class_order():
    """With levels the mirror is made in the class order: its first frame
    needs no repair."""
    lv = (pm2.PM2Config(None, 32.0, 1.0), pm2.PM2Config(None, 8.0, 0.4))
    e = engine(True, pm2=lv)
    e.step(PARAMS)
    assert e.resorts == 0 and e._persist.fine_b.shape == (2,)
    keys = pm_persist.state_keys(e._persist, e.particle_count, CFG, lv)
    assert int(pm_persist.disorder(keys)) < 0.05 * e.particle_count


def test_torch_method_persist_runs():
    """Method.TORCH (the plain path; a checkpoint resumed on the CPU)
    steps the persistent mode."""
    e = engine(True)
    assert e.method == Method.TORCH
    e.step(PARAMS)
    e.step(PARAMS)
    assert e._persist is not None and torch.isfinite(e.state.pos).all()


def test_cli_pm_persist_implies_pm(capsys):
    rc = cli.main(["--device", "cpu", "--count", "1500", "--steps", "2",
                   "--pm-persist", "--pm-grid", "32", "--stats-every", "0"])
    assert rc == 0
    done = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert done["done"] is True and done["steps"] == 2


def test_server_pm_persist_event(caplog):
    """The "pm_persist" event runs the persistent PM; the hello says so;
    a "pm" event goes back to the per-frame path."""
    srv = server.StreamServer(Engine(particle_count=1500, device="cpu"),
                              port=0)
    eng = srv.engine
    srv.handle_event({"type": "solver", "name": "pm_persist", "g": 1.0,
                      "softening": 4.0})
    assert eng.pm_persist is True and srv.hello()["solver"] == "pm_persist"
    eng.step(PARAMS)
    assert eng._persist is not None
    srv.handle_event({"type": "solver", "name": "pm", "g": 1.0,
                      "softening": 4.0})
    assert eng.pm_persist is False and srv.hello()["solver"] == "pm"
    eng.step(PARAMS)
    assert eng._persist is None and not eng._identity_dirty


def test_render_from_sorted_planes_skips_unsort():
    """Velocity colours render straight from the sorted planes within one
    u8 level of the identity render (the mirror stays dirty); colour mode
    0 reads the mirror's col24, within 3 u8 levels (u8 colour
    quantization on top of the additive blend)."""
    cam = Camera(aspect=1.0)
    pv_vel = SimParams(delta_time=0.016, gravity=0.0, color_mode=1)
    e = engine(True)
    for _ in range(2):
        e.step(pv_vel)
    img_fast = e.render_frame(cam, pv_vel, width=64, height=64)
    assert e._identity_dirty
    e.ensure_identity_order()
    img_ref = e.render_frame(cam, pv_vel, width=64, height=64)
    assert np.abs(img_fast.astype(int) - img_ref.astype(int)).max() <= 1
    assert img_ref[..., :3].sum() > 0
    e2, e3 = engine(True), engine(False)
    e2.step(pv_vel)
    e3.step(pv_vel)
    pv0 = SimParams(delta_time=0.016, gravity=0.0, color_mode=0)
    img0 = e2.render_frame(cam, pv0, width=64, height=64)
    assert e2._identity_dirty
    img0_ref = e3.render_frame(cam, pv0, width=64, height=64)
    assert np.abs(img0.astype(int) - img0_ref.astype(int)).max() <= 3


def test_diagnostics_and_colors_read_identity_order():
    e_per, e_ref = engine(True), engine(False)
    e_per.step(PARAMS)
    e_ref.step(PARAMS)
    d_per, d_ref = e_per.diagnostics(), e_ref.diagnostics()
    assert d_per.kinetic == pytest.approx(d_ref.kinetic, rel=1e-6)
    np.testing.assert_allclose(e_per.colors_rgba(PARAMS),
                               e_ref.colors_rgba(PARAMS), atol=1e-6)


def test_port_persist_path_imports_no_jax(tmp_path):
    """The persistent PM's CLI path with a pm2 stack, its checkpoint, the
    server's "pm_persist" event, the debug checks, the profiling helpers
    and tools/pm_profile.py run without importing jax."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys\n"
        "from particle_sim_tpu_torch.app import cli, server\n"
        "from particle_sim_tpu_torch.io import checkpoint\n"
        "from particle_sim_tpu_torch.ops import pm_persist\n"
        "from particle_sim_tpu_torch.tools import pm_profile\n"
        "from particle_sim_tpu_torch.utils import debug, profiling\n"
        "cli.main(['--device', 'cpu', '--count', '1024', '--steps', '2',"
        " '--pm-persist', '--pm-grid', '32', '--pm-softening', '3',"
        " '--pm2-size', '32', '8', '--pm2-softening', '0.75', '0.25',"
        " '--stats-every', '0', '--checkpoint-every', '2',"
        " '--checkpoint', 'c.npz'])\n"
        "e, _ = checkpoint.load('c.npz', device='cpu')\n"
        "assert e.pm_persist is True and len(e.pm2) == 2\n"
        "e.debug_checks = True\n"
        "from particle_sim_tpu_torch import SimParams\n"
        "e.step(SimParams())\n"
        "s = server.make_server(['--device', 'cpu', '--count', '1024'])\n"
        "s.handle_event({'type': 'solver', 'name': 'pm_persist', 'g': 1.0,"
        " 'softening': 3.0})\n"
        "assert s.hello()['solver'] == 'pm_persist'\n"
        "profiling.device_time(lambda: e.step(SimParams()), reps=1)\n"
        "pm_profile.main(['2048', '--grid', '32', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'particle_sim_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout
