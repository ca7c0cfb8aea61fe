"""The port's slice as a whole — Engine, checkpoints, CLI — against the JAX
package's, on the plain CPU path."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import checkpoint as jckpt
from particle_sim_tpu.render.camera import Camera as JCamera

from particle_sim_tpu_torch.app import cli
from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, SimParams, SphereGeneration,
)
from particle_sim_tpu_torch.engine import Engine, available_methods
from particle_sim_tpu_torch.io import checkpoint as ckpt
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 256, 128


def make_engine(n=2000, **kw):
    return Engine(particle_count=n, device="cpu", method=Method.TORCH, **kw)


def orbit_params(cls, i, **kw):
    """The CLI's scripted attractor (``--drag --orbit-mouse``) at frame i."""
    ang = i * 0.02
    return cls(is_mouse_dragging=True, color_mode=1, mouse_position=(
        40.0 * np.cos(ang), 10.0 * np.sin(ang * 2.3), 40.0 * np.sin(ang)),
        **kw)


def read_png(path):
    """uint8[H, W, C] of a PNG written by utils/png.py (filter 0 rows)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, idat = 8, b""
    while off < len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        off += 12 + length
    ch = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, 1 + w * ch)[:, 1:].reshape(h, w, ch)


# -- the slice as a whole ------------------------------------------------------
def test_slice_matches_jax_engine():
    """Same generated state, 20 frames of the CLI's orbiting mouse through
    both engines' plain paths; states at 1e-5, compact frames within one
    u8 level (bf16 colour words can round the other way when a weight
    differs in its last bit)."""
    n = 4096
    je = JEngine(particle_count=n, method=JMethod.JNP)
    te = Engine(particle_count=n, device="cpu", method=0)
    np.testing.assert_array_equal(te.state.positions(), je.state.positions())
    for i in range(20):
        je.step(orbit_params(JSimParams, i))
        te.step(orbit_params(SimParams, i))
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.state.velocities(), je.state.velocities(),
                               rtol=1e-5, atol=1e-5)
    jf = je.render_frame(JCamera(aspect=W / H), orbit_params(JSimParams, 19),
                         width=W, height=H, renderer="compact")
    tf = te.render_frame(Camera(aspect=W / H), orbit_params(SimParams, 19),
                         width=W, height=H, renderer="compact")
    assert tf.shape == jf.shape == (H, W, 4) and tf.dtype == np.uint8
    assert (jf[..., :3].sum(-1) > 0).sum() > 100
    diff = np.abs(tf.astype(np.int16) - np.asarray(jf).astype(np.int16))
    assert diff.max() <= 1


# -- lifecycle, mirroring tests/test_engine.py ------------------------------------
def test_default_count_and_method_on_cpu():
    e = Engine(device="cpu")
    assert e.method == Method.TORCH
    assert e.particle_count == 100_000


def test_available_methods():
    assert Method.TORCH in available_methods("cpu")
    assert Method.CUDA not in available_methods("cpu")
    if not torch.cuda.is_available():
        assert available_methods("cuda") == [Method.TORCH]


def test_pause_gates_stepping():
    e = make_engine()
    p0 = e.state.pos
    e.set_paused(True)
    e.step(SimParams(gravity=5.0))
    assert e.state.pos is p0
    e.set_paused(False)
    e.step(SimParams(gravity=5.0))
    assert e.state.pos is not p0


def test_reset_regenerates():
    e = make_engine()
    before = e.state.positions()
    for _ in range(3):
        e.step(SimParams(gravity=3.0))
    assert not np.allclose(before, e.state.positions())
    cap = e.capacity
    e.reset()
    assert e.capacity == cap
    np.testing.assert_array_equal(e.state.positions(), before)


def test_filled_reset_bit_identical():
    e = make_engine(generation_mode=SphereGeneration.FILLED)
    a = e.state.positions().copy()
    e.step(SimParams(gravity=1.0))
    e.reset()
    np.testing.assert_array_equal(e.state.positions(), a)


def test_shrink_keeps_capacity_and_state():
    e = make_engine(n=3000)
    cap = e.capacity
    head = e.state.positions()[:500]
    e.resize(500)
    assert e.particle_count == 500 and e.capacity == cap
    np.testing.assert_array_equal(e.state.positions(), head)


def test_grow_appends_preserving_state():
    e = make_engine(n=1000)
    e.step(SimParams(gravity=2.0, delta_time=0.1))
    evolved = e.state.positions()
    e.resize(2500)
    assert e.particle_count == 2500
    np.testing.assert_array_equal(e.state.positions()[:1000], evolved)
    assert (e.state.velocities()[1000:] == 0).all()


def test_resize_to_one_clamped():
    e = make_engine(n=100)
    e.resize(0)
    assert e.particle_count == 1


def test_generation_mode_change_regenerates():
    e = make_engine(n=1000)
    e.step(SimParams(gravity=2.0))
    e.resize(1000, generation_mode=SphereGeneration.FILLED)
    assert e.generation_mode == SphereGeneration.FILLED
    assert (e.state.velocities() == 0).all()


def test_set_method():
    e = make_engine(n=1500)
    e.set_paused(True)
    pos = e.state.pos
    e.set_method(Method.TORCH)              # same method: nothing changes
    assert e.state.pos is pos and e.is_paused()
    with pytest.raises(ValueError):
        e.set_method(Method.CUDA)           # needs a CUDA device
    with pytest.raises(ValueError):
        Engine(particle_count=10, device="cpu", method=Method.CUDA)


def test_trajectory_matches_plain_stepper():
    from particle_sim_tpu_torch.ops import step_ref
    e = make_engine(n=800)
    p = SimParams(gravity=1.5, is_mouse_dragging=True,
                  mouse_position=(0, 0, 10), mouse_force=30.0)
    ep, ev = e.state.pos.clone(), e.state.vel.clone()
    for _ in range(5):
        e.step(p)
        ep, ev = step_ref.step(ep, ev, torch.from_numpy(p.pack()))
    assert torch.equal(e.state.pos, ep) and torch.equal(e.state.vel, ev)


def test_substeps_engine():
    e1 = make_engine(n=1000, substeps=3)
    e2 = make_engine(n=1000)
    p = SimParams(gravity=1.0)
    e1.step(p)
    for _ in range(3):
        e2.step(p)
    np.testing.assert_array_equal(e1.state.positions(), e2.state.positions())


def test_stats_update():
    e = make_engine()
    e.step_synced(SimParams())
    snap = e.stats.snapshot()
    assert snap["steps_total"] == 2 and snap["device_ms"] > 0


def test_colors_rgba():
    e = make_engine(n=300)
    c = e.colors_rgba(SimParams())
    assert c.shape == (300, 4) and (c[:, 3] == 1.0).all()
    np.testing.assert_allclose(c[:, :3], e.state.init_colors_rgba()[:, :3])


@pytest.mark.parametrize("renderer", ["auto", "scatter", "compact"])
def test_render_frame(renderer):
    e = make_engine(n=2000)
    for _ in range(2):
        e.step(SimParams(gravity=2.0, delta_time=0.05))
    img = e.render_frame(Camera(aspect=2.0), SimParams(color_mode=2),
                         width=W, height=H, renderer=renderer)
    assert img.shape == (H, W, 4) and img.dtype == np.uint8
    assert img[..., :3].sum() > 0


def test_render_frame_renderers_agree():
    e = make_engine(n=3000)
    e.step(SimParams(gravity=2.0, delta_time=0.05))
    cam, p = Camera(aspect=2.0), SimParams(color_mode=1)
    a = e.render_frame(cam, p, width=W, height=H, renderer="scatter")
    b = e.render_frame(cam, p, width=W, height=H, renderer="compact")
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 2


def test_sorted_renderer_matches_scatter():
    e = make_engine(n=3000)
    e.step(SimParams(gravity=2.0, delta_time=0.05))
    cam, p = Camera(aspect=2.0), SimParams(color_mode=1)
    a = e.render_frame(cam, p, width=W, height=H, renderer="scatter")
    b = e.render_frame(cam, p, width=W, height=H, renderer="sorted")
    assert (a[..., :3].sum(-1) > 0).sum() > 100
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
    with pytest.raises(ValueError, match="renderer"):
        e.render_frame(cam, p, width=W, height=H, renderer="nope")


# -- direct-sum gravity and masses ------------------------------------------------
@pytest.mark.parametrize("masses,substeps", [(False, 1), (True, 1),
                                             (True, 2)])
def test_engine_pairwise_matches_jax(masses, substeps):
    """Engine(pairwise=..., masses=...) steps to the JAX engine's state."""
    n = 1500
    m = np.ones(n, np.float32)
    m[0] = 200.0
    kw = dict(masses=m) if masses else {}
    je = JEngine(particle_count=n, method=JMethod.JNP, substeps=substeps,
                 pairwise=JPairwise(2.0, 0.5), **kw)
    te = make_engine(n=n, substeps=substeps,
                     pairwise=PairwiseParams(2.0, 0.5), **kw)
    for i in range(4):
        je.step(orbit_params(JSimParams, i))
        te.step(orbit_params(SimParams, i))
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.state.velocities(), je.state.velocities(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(te.state.velocities(),
                           make_engine(n=n).state.velocities())


def test_pairwise_switches_between_steps():
    """The server's solver events assign engine.pairwise between steps."""
    e = make_engine(n=1024)
    ref = make_engine(n=1024)
    p = SimParams(delta_time=0.05)
    e.pairwise = PairwiseParams(1.0, 0.5)
    e.step(p)
    ref.step(p)
    assert not torch.equal(e.state.vel, ref.state.vel)   # gravity pulled
    e.pairwise = None
    e.state = ref.state
    e.step(p)
    ref2 = make_engine(n=1024)
    ref2.step(p)
    ref2.step(p)
    assert torch.equal(e.state.pos, ref2.state.pos)


def test_masses_kept_across_resize():
    """Masses follow the JAX engine through shrink and grow: kept ones
    stay, grown particles get mass 1, padding is 1."""
    m = np.arange(1, 1501, dtype=np.float32)
    je = JEngine(particle_count=1500, method=JMethod.JNP,
                 pairwise=JPairwise(), masses=m)
    te = make_engine(n=1500, pairwise=PairwiseParams(), masses=m)
    for count in (700, 2600, 5000):
        je.resize(count)
        te.resize(count)
        jm = np.asarray(je._masses_for_capacity())
        tm = te._masses_for_capacity().numpy()
        assert tm.shape == (te.capacity,) == jm.shape
        np.testing.assert_array_equal(tm, jm)
    assert te.masses is not None and float(te.masses[0]) == 1.0
    assert (te.masses[700:].numpy() == 1.0).all()
    with pytest.raises(ValueError, match="masses length"):
        te.set_masses(np.ones(3))


@pytest.mark.parametrize("max_points", [0, 700])
def test_frame_arrays_match_jax(max_points):
    """The stream pack (positions and brightness-premultiplied rgba8)
    equals the JAX engine's, stride subsample included."""
    je = JEngine(particle_count=2000, method=JMethod.JNP)
    te = make_engine(n=2000)
    for i in range(3):
        je.step(orbit_params(JSimParams, i))
        te.step(orbit_params(SimParams, i))
    jp, jc = je.frame_arrays(orbit_params(JSimParams, 2), max_points)
    tp, tc = te.frame_arrays(orbit_params(SimParams, 2), max_points)
    assert tp.shape == jp.shape and tc.shape == jc.shape
    assert tp.flags.c_contiguous and tc.flags.c_contiguous
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
    assert np.abs(tc.astype(np.int16) - jc.astype(np.int16)).max() <= 1
    dp, dc = te.frame_arrays_device(orbit_params(SimParams, 2), max_points)
    assert dp.device == te.device and dc.dtype == torch.uint8


# -- what is not ported, and devices ---------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(pm=object()), dict(pm2=object()), dict(pmx=object()),
    dict(pm_persist=True), dict(mesh=object())])
def test_engine_not_ported_raises(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Engine(particle_count=10, device="cpu", **kw)


def test_engine_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        assert Engine(particle_count=1024, device="cuda").method == Method.CUDA
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(particle_count=1024, device="cuda")


# -- checkpoints cross between the packages ------------------------------------------
def test_checkpoint_jax_save_port_load(tmp_path):
    path = str(tmp_path / "j.npz")
    je = JEngine(particle_count=1000, method=JMethod.JNP, substeps=2)
    jp = JSimParams(gravity=2.0, is_mouse_dragging=True,
                    mouse_position=(0, 0, 20), mouse_force=30.0)
    for _ in range(5):
        je.step(jp)
    je.set_paused(True)
    jckpt.save(path, je, step_index=5)

    te, idx = ckpt.load(path, device="cpu")
    assert idx == 5 and te.is_paused() and te.substeps == 2
    assert te.method == Method.TORCH and te.particle_count == 1000
    np.testing.assert_array_equal(te.state.positions(), je.state.positions())
    np.testing.assert_array_equal(te.state.velocities(),
                                  je.state.velocities())
    np.testing.assert_array_equal(te.state.init_colors_rgba(),
                                  je.state.init_colors_rgba())
    te.set_paused(False)
    je.set_paused(False)
    tp = SimParams(gravity=2.0, is_mouse_dragging=True,
                   mouse_position=(0, 0, 20), mouse_force=30.0)
    for _ in range(5):
        je.step(jp)
        te.step(tp)
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_port_save_jax_load(tmp_path):
    path_t, path_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    te = make_engine(n=1200, generation_mode=SphereGeneration.FILLED)
    for _ in range(3):
        te.step(SimParams(gravity=1.0))
    te.set_paused(True)
    ckpt.save(path_t, te, step_index=3)

    je, idx = jckpt.load(path_t)
    assert idx == 3 and je.is_paused()
    assert je.generation_mode == int(SphereGeneration.FILLED)
    np.testing.assert_array_equal(je.state.positions(), te.state.positions())
    np.testing.assert_array_equal(je.state.velocities(),
                                  te.state.velocities())
    # the JAX package writes the same meta for the same engine
    jckpt.save(path_j, je, step_index=3)
    meta = [json.loads(str(np.load(p)["meta"])) for p in (path_t, path_j)]
    assert meta[0] == meta[1]
    with np.load(path_t) as zt, np.load(path_j) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in ("positions", "velocities", "init_colors"):
            np.testing.assert_array_equal(zt[k], zj[k])


def test_checkpoint_roundtrip_preserves_trajectory(tmp_path):
    path = str(tmp_path / "c.npz")
    e1 = make_engine(n=1000)
    p = SimParams(gravity=2.0, is_mouse_dragging=True,
                  mouse_position=(0, 0, 20), mouse_force=30.0)
    for _ in range(5):
        e1.step(p)
    ckpt.save(path, e1, step_index=5)
    for _ in range(5):
        e1.step(p)
    e2, idx = ckpt.load(path, device="cpu")
    for _ in range(5):
        e2.step(p)
    assert idx == 5
    np.testing.assert_array_equal(e2.state.positions(), e1.state.positions())


def test_checkpoint_with_solver_not_ported(tmp_path):
    """A particle-mesh checkpoint still raises on load."""
    from particle_sim_tpu.core.params import PMConfig as JPM

    path = str(tmp_path / "pm.npz")
    je = JEngine(particle_count=256, method=JMethod.JNP,
                 pairwise=JPairwise(3.0, 0.7), pm=JPM(grid=32))
    jckpt.save(path, je)
    with pytest.raises(NotImplementedError, match="pm"):
        ckpt.load(path, device="cpu")


def test_checkpoint_pairwise_masses_jax_to_port(tmp_path):
    path = str(tmp_path / "pw.npz")
    m = np.ones(1200, np.float32)
    m[0] = 400.0
    je = JEngine(particle_count=1200, method=JMethod.JNP,
                 pairwise=JPairwise(3.0, 0.7), masses=m)
    for i in range(3):
        je.step(orbit_params(JSimParams, i))
    jckpt.save(path, je, step_index=3)
    te, idx = ckpt.load(path, device="cpu")
    assert idx == 3 and te.pairwise == PairwiseParams(3.0, 0.7)
    np.testing.assert_array_equal(te.masses[:1200].numpy(), m)
    np.testing.assert_array_equal(te.state.positions(), je.state.positions())
    for i in range(3, 6):
        je.step(orbit_params(JSimParams, i))
        te.step(orbit_params(SimParams, i))
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_pairwise_masses_port_to_jax(tmp_path):
    path_t, path_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    m = np.linspace(0.5, 3.0, 1100).astype(np.float32)
    te = make_engine(n=1100, pairwise=PairwiseParams(1.5, 0.4), masses=m)
    te.step(SimParams(gravity=1.0))
    te.resize(1500)                      # grown particles: mass 1
    ckpt.save(path_t, te, step_index=1)
    je, idx = jckpt.load(path_t)
    assert idx == 1 and je.pairwise == JPairwise(1.5, 0.4)
    want = np.concatenate([m, np.ones(400, np.float32)])
    np.testing.assert_array_equal(
        np.asarray(je._masses_for_capacity())[:1500], want)
    jckpt.save(path_j, je, step_index=1)
    meta = [json.loads(str(np.load(p)["meta"])) for p in (path_t, path_j)]
    assert meta[0] == meta[1]
    with np.load(path_t) as zt, np.load(path_j) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in ("positions", "velocities", "init_colors", "masses"):
            np.testing.assert_array_equal(zt[k], zj[k])


# -- the CLI ----------------------------------------------------------------------
def test_cli_headless_run_writes_frames(tmp_path, capsys):
    frames = tmp_path / "frames"
    rc = cli.main(["--device", "cpu", "--count", "4096", "--steps", "20",
                   "--render-every", "10", "--width", "256", "--height",
                   "128", "--render-dir", str(frames), "--drag",
                   "--orbit-mouse", "--color-mode", "1", "--stats-every",
                   "10"])
    assert rc == 0
    pngs = sorted(os.listdir(frames))
    assert pngs == ["frame_000010.png", "frame_000020.png"]
    for name in pngs:
        img = read_png(str(frames / name))
        assert img.shape == (128, 256, 4)
        assert img[..., :3].sum() > 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["step"] for l in lines[:-1]] == [10, 20]
    done = lines[-1]
    assert done["done"] is True and done["steps"] == 20
    assert done["particle_steps_per_sec"] > 0
    assert set(done) == {"done", "steps", "wall_s", "particle_steps_per_sec",
                         "fps", "update_ms", "device_ms", "steps_total"}


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    path = str(tmp_path / "c.npz")
    assert cli.main(["--device", "cpu", "--count", "2048", "--steps", "6",
                     "--checkpoint-every", "3", "--checkpoint", path,
                     "--stats-every", "0", "--gravity", "1.0"]) == 0
    assert cli.main(["--device", "cpu", "--resume", path, "--steps", "2",
                     "--stats-every", "0"]) == 0
    capsys.readouterr()
    e, idx = ckpt.load(path, device="cpu")
    assert idx == 6 and e.particle_count == 2048


def test_cli_pairwise_central_mass_sorted(tmp_path, capsys):
    """--pairwise --central-mass with the sorted renderer on the CPU:
    frames are written and the checkpoint holds the masses."""
    frames, path = tmp_path / "frames", str(tmp_path / "c.npz")
    rc = cli.main(["--device", "cpu", "--pairwise", "--central-mass", "1000",
                   "--pairwise-g", "0.5", "--count", "2048", "--steps", "4",
                   "--renderer", "sorted", "--render-every", "2", "--width",
                   "256", "--height", "128", "--render-dir", str(frames),
                   "--checkpoint-every", "4", "--checkpoint", path,
                   "--stats-every", "0", "--gravity", "1.0"])
    assert rc == 0
    pngs = sorted(os.listdir(frames))
    assert pngs == ["frame_000002.png", "frame_000004.png"]
    assert read_png(str(frames / pngs[-1]))[..., :3].sum() > 0
    done = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert done["done"] is True and done["steps"] == 4
    e, _ = ckpt.load(path, device="cpu")
    assert e.pairwise == PairwiseParams(0.5, 0.5)
    assert float(e.masses[0]) == 1000.0 and float(e.masses[1:].max()) == 1.0
    assert np.isfinite(e.state.positions()).all()


@pytest.mark.parametrize("flags", [
    ["--pm"], ["--pm-persist"], ["--pm2-size", "24"], ["--pmx-size", "6"],
    ["--mesh", "auto"], ["--diagnostics"]])
def test_cli_not_ported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--device", "cpu", "--count", "1024", "--steps", "1",
                  *flags])


def test_cli_cuda_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda runs")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--count", "1024", "--steps", "1"])


def test_port_imports_no_jax(tmp_path):
    """The package, its engine and its CLI run without importing jax."""
    script = (
        "import sys\n"
        "import particle_sim_tpu_torch\n"
        "from particle_sim_tpu_torch.engine import Engine\n"
        "from particle_sim_tpu_torch.app import cli\n"
        "from particle_sim_tpu_torch.ops import pairwise_cuda, step_cuda\n"
        "from particle_sim_tpu_torch.render import raster_compact\n"
        "from particle_sim_tpu_torch.render import raster_sorted\n"
        "from particle_sim_tpu_torch.io import checkpoint, packer\n"
        "from particle_sim_tpu_torch.app import server\n"
        "packer.pack_f16(*server.StreamServer(Engine(1024, device='cpu'))"
        ".engine.frame_arrays(particle_sim_tpu_torch.SimParams()))\n"
        f"cli.main(['--device', 'cpu', '--count', '1024', '--steps', '2',"
        f" '--render-every', '2', '--width', '256', '--height', '128',"
        f" '--render-dir', {str(tmp_path)!r}, '--stats-every', '0',"
        f" '--pairwise', '--central-mass', '10', '--renderer', 'sorted'])\n"
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
