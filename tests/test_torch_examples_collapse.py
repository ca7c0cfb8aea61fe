"""The port's collapse (particle_sim_tpu_torch/examples/collapse.py)
against the JAX package's examples/collapse.py on the CPU."""

import json
import os

import numpy as np
import pytest

from particle_sim_tpu_torch.core.params import SphereGeneration
from particle_sim_tpu_torch.examples import collapse
from torch_examples_common import run_both


def test_collapse_builds_the_jax_scripts_engine():
    """A filled sphere, the PM solver with the auto box (per frame: the
    persistent PM needs a static box), G and softening from the
    arguments, undamped."""
    engine, params, camera = collapse.build(collapse.build_parser()
                                            .parse_args(["--count", "2048",
                                                         "--device", "cpu"]))
    assert engine.generation_mode == SphereGeneration.FILLED
    assert engine.pm.auto_box and engine.pm.softening == 4.0
    assert engine.pairwise.gravitational_constant == 0.08
    assert not engine.persist_resolved()
    assert params.damping == 1.0 and params.delta_time == 0.004
    assert camera.aspect == pytest.approx(16 / 9)


def test_collapse_matches_jax(tmp_path):
    """4 steps at 3,000, the diagnostics with the potential and a frame
    every 2: the same keys in the same order; mean_radius, max_speed and
    the energies at rtol 1e-4 (test_torch_pm_engine.py's engine-parity
    bar, one order looser for the diagnostics' reductions), the momentum
    at test_torch_pm.py's bar; the same frame files."""
    args = ["--count", "3000", "--steps", "4", "--render-every", "2"]
    want, got = run_both(collapse, "collapse",
                         args + ["--out", str(tmp_path / "t")],
                         jax_args=args + ["--out", str(tmp_path / "j")])
    want = [json.loads(ln) for ln in want]
    got = [json.loads(ln) for ln in got]
    assert [w["step"] for w in want] == [g["step"] for g in got] == [2, 4]
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k in ("kinetic", "potential", "total_energy", "mean_radius",
                  "max_speed"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
        assert g["potential"] < 0.0
        np.testing.assert_allclose(g["momentum"], w["momentum"], rtol=1e-4,
                                   atol=1e-3)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["c_00002.png", "c_00004.png"]
