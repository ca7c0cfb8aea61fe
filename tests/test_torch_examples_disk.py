"""The port's Kepler disk (particle_sim_tpu_torch/examples/disk.py)
against the JAX package's examples/disk.py on the CPU."""

import json
import os

import numpy as np
import pytest

from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import PMConfig as JPMConfig
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.engine import Engine as JEngine

from particle_sim_tpu_torch.examples import disk
from torch_examples_common import jax_example, run_both
from test_torch_engine_cli import read_png


def test_make_disk_is_the_jax_scripts():
    """The port's copy of make_disk gives the JAX script's arrays bit for
    bit (the same numpy generator and seed)."""
    want = jax_example("disk").make_disk(5000, 50_000.0, 1.0, 2.0)
    got = disk.make_disk(5000, 50_000.0, 1.0, 2.0)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_state_capacity_masses_and_mode_follow_the_assignment():
    """Engine(particle_count=1) given the disk's n + 1 particles: the
    count, the capacity (the JAX engine's), the masses buffer (the centre
    first, 1 past the live count) and the per-frame PM mode follow the
    assigned state."""
    args = disk.build_parser().parse_args(["--count", "3000",
                                           "--device", "cpu"])
    engine, params, _ = disk.build(args)
    pos, vel, masses = disk.make_disk(3000, 50_000.0, 1.0, 2.0)
    je = JEngine(particle_count=1, pairwise=JPairwise(1.0, 2.0),
                 pm=JPMConfig(softening=2.0))
    je.state = JState.from_arrays(pos, vel, np.full_like(pos, 0.6))
    je.set_masses(masses)
    assert engine.particle_count == je.particle_count == 3001
    assert engine.capacity == je.capacity == engine.state.capacity
    m = engine.masses.numpy()
    assert m.shape == (engine.capacity,)
    np.testing.assert_array_equal(m, np.asarray(je.masses))
    assert m[0] == 50_000.0 and (m[3001:] == 1.0).all()
    assert engine.pm.softening == 2.0 and not engine.persist_resolved()
    assert params.damping == 1.0 and params.delta_time == 0.002


def test_disk_matches_jax(tmp_path):
    """4 steps at 3,000 (+ the centre), a stats line and a frame every 2:
    the same keys in the same order, mean_radius and max_speed at rtol
    1e-4 (the engine-parity bar of test_torch_pm_engine.py, one order
    looser for the diagnostics' reductions); the same frame files, lit."""
    args = ["--count", "3000", "--steps", "4", "--render-every", "2"]
    want, got = run_both(disk, "disk", args + ["--out", str(tmp_path / "t")],
                         jax_args=args + ["--out", str(tmp_path / "j")])
    want = [json.loads(ln) for ln in want]
    got = [json.loads(ln) for ln in got]
    assert [w["step"] for w in want] == [g["step"] for g in got] == [2, 4]
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k in ("mean_radius", "max_speed"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "d_00002.png", "d_00004.png"]
    for name in names:
        img = read_png(str(tmp_path / "t" / name))
        assert img.shape[:2] == (720, 1280) and img[..., :3].max() > 0
