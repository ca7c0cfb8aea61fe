"""The port's worked examples (particle_sim_tpu_torch/examples/) on the
CPU: the attractor against the JAX package's examples/attractor.py, the
refusal of a CUDA run without CUDA, and that none of the five imports
JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from particle_sim_tpu_torch.examples import (
    attractor, cluster_core, collapse, deep_zoom, disk,
)
from torch_examples_common import REPO, run_both

MODULES = {"attractor": attractor, "disk": disk, "collapse": collapse,
           "cluster_core": cluster_core, "deep_zoom": deep_zoom}


def test_attractor_matches_jax():
    """100 steps at 3,000 (one stats line, every 100 steps as in the JAX
    script): the same keys in the same order, mean_radius and max_speed
    at rtol 1e-4; the timings (fps, update_ms, device_ms) are not
    compared."""
    want, got = run_both(attractor, "attractor",
                         ["--count", "3000", "--steps", "100"])
    want = [json.loads(ln) for ln in want]
    got = [json.loads(ln) for ln in got]
    assert [w["step"] for w in want] == [g["step"] for g in got] == [100]
    for w, g in zip(want, got):
        assert list(g) == list(w)
        assert g["steps_total"] == w["steps_total"]
        for k in ("mean_radius", "max_speed"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k


def test_orbit_is_the_jax_scripts():
    """orbit(base, i) places the attractor where the JAX script's loop
    does at step i."""
    _, params, camera = attractor.build(
        attractor.build_parser().parse_args(["--count", "1024",
                                             "--device", "cpu"]))
    assert camera is None and params.mouse_force == 50.0
    for i in (0, 1, 77, 599):
        ang = i * 0.02
        np.testing.assert_array_equal(
            attractor.orbit(params, i).mouse_position,
            (40 * np.cos(ang), 10 * np.sin(2.3 * ang), 40 * np.sin(ang)))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_cuda_without_cuda_raises(name, monkeypatch):
    """--device cuda (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MODULES[name].main(["--count", "1024", "--steps", "1"])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_arguments_are_the_jax_scripts(name):
    """Each example takes the JAX script's arguments with its defaults,
    plus --device (default cuda), and nothing else."""
    src = open(os.path.join(REPO, "examples", f"{name}.py")).read()
    ns = MODULES[name].build_parser().parse_args([])
    want = dict(ns.__dict__)
    assert want.pop("device") == "cuda"
    for flag in want:
        assert f'"--{flag.replace("_", "-")}"' in src, flag
    assert src.count('ap.add_argument("--') == len(want)


def test_examples_import_no_jax(tmp_path):
    """The five examples run on the CPU without loading jax, jaxlib, the
    JAX package or the repository's examples/."""
    runs = [
        ("attractor", ["--count", "1024", "--steps", "2"]),
        ("disk", ["--count", "1023", "--steps", "1", "--render-every", "1",
                  "--out", str(tmp_path / "disk")]),
        ("collapse", ["--count", "1024", "--steps", "1", "--render-every",
                      "1", "--out", str(tmp_path / "collapse")]),
        ("cluster_core", ["--count", "1024", "--steps", "1",
                          "--stats-every", "1"]),
        ("deep_zoom", ["--count", "1024", "--steps", "1", "--stats-every",
                       "1", "--exact"]),
    ]
    script = (
        "import sys\n"
        "import importlib\n"
        f"for name, argv in {runs!r}:\n"
        "    mod = importlib.import_module("
        "'particle_sim_tpu_torch.examples.' + name)\n"
        "    assert mod.main(argv + ['--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'particle_sim_tpu', 'examples'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout
    assert sorted(os.listdir(tmp_path / "disk")) == ["d_00001.png"]
    assert sorted(os.listdir(tmp_path / "collapse")) == ["c_00001.png"]
