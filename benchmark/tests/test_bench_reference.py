"""The plain reference against the port's plain path, at a small size on
the CPU: the PM step (static box with masses, auto box), the
diagnostics and the frame."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import spec, state, traffic
from benchmark.reference import pm as ref_pm


def _small(name, small):
    cfg = spec.config(name)
    cfg["count"] = small["count"]
    cfg["pm"]["grid"] = small["pm.grid"]
    cfg["cli_argv"] = [*cfg["cli_argv"], *small["cli_argv"]]
    return cfg


def _engine(cfg):
    args = traffic.cli_args(cfg, "cpu")
    return traffic.build_engine(args), traffic.sim_params(args)


def _live(planes, n):
    return planes.reshape(3, -1)[:, :n]


@pytest.mark.parametrize("name", ["pm_persist_16m", "pm_autobox_1m"])
def test_steps_match_the_plain_engine(name, small):
    torch.set_num_threads(2)
    cfg = _small(name, small)
    eng, params = _engine(cfg)
    init = state.initial(cfg, 2 ** 40 + 7, "cpu")
    restart = traffic.installer(eng, init)
    restart()
    for _ in range(3):
        eng.step(params)
    st = eng.state
    ref = ref_pm.make(cfg, "cpu")
    n = init.n
    rp, rv, cell = ref.steps(init.pos[:, :n], init.vel[:, :n], init.masses,
                             dataclasses.asdict(params), 3)
    dx = (_live(st.pos, n).double() - rp).abs().max() / cell
    dv = (_live(st.vel, n).double() - rv).abs().max() / rv.abs().max()
    assert float(dx) < 1e-4 and float(dv) < 1e-4


def test_diagnostics_match_the_engine(small):
    torch.set_num_threads(2)
    cfg = _small("pm_autobox_1m", small)
    eng, params = _engine(cfg)
    init = state.initial(cfg, 11, "cpu")
    traffic.installer(eng, init)
    for _ in range(5):
        eng.step(params)
    d = eng.diagnostics(potential=True).as_dict()
    st = eng.state
    r = ref_pm.make(cfg, "cpu").diagnostics(_live(st.pos, init.n),
                                            _live(st.vel, init.n), None)
    assert d["kinetic"] == pytest.approx(r["kinetic"], rel=1e-5)
    assert d["potential"] == pytest.approx(r["potential"], rel=1e-5)
    assert np.allclose(d["momentum"], r["momentum"],
                       atol=1e-5 * r["momentum_scale"])


def _state_with_speed(n, seed):
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand((3, n), generator=g) - 0.5) * 100.0
    vel = torch.randn((3, n), generator=g) * 0.3
    col = torch.rand((3, n), generator=g)
    return pos, vel, col


def test_frame_matches_the_scatter_renderer(small):
    from particle_sim_tpu_torch.core.params import SimParams
    from particle_sim_tpu_torch.render import raster
    from particle_sim_tpu_torch.render.camera import Camera

    n, w, h = 4096, 256, 128
    pos, vel, col = _state_with_speed(n, 3)
    cam = Camera(aspect=w / h)
    params = SimParams()
    pv = torch.from_numpy(params.pack())
    vp = torch.from_numpy(cam.view_proj())
    fb = raster.to_rgba8(raster.render(
        pos.view(3, -1, 128), vel.view(3, -1, 128), col.view(3, -1, 128),
        pv, vp, torch.tensor(n, dtype=torch.int32), width=w, height=h))
    cfg = _small("pm_autobox_1m", small)
    got = ref_pm.make(cfg, "cpu").frame(pos, vel, col,
                                        dataclasses.asdict(params),
                                        cam.view_proj(), w, h)
    assert int((got.int() - fb.int()).abs().max()) <= 1
    assert int(fb[..., :3].int().sum()) > 0
