"""Port steppers (ops/step_ref.py, ops/step_cuda.py on CPU tensors) against
the JAX package's jnp stepper, its Pallas kernel in interpret mode, and the
independent NumPy oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.ops import step_jnp, step_pallas

from particle_sim_tpu_torch.core.params import SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.ops import step_cuda, step_ref

from reference_oracle import reference_color, reference_step

torch.set_num_threads(1)

# the parameter sets of tests/test_step_pallas.py
PARAMS = [
    dict(),
    dict(gravity=2.0),
    dict(is_mouse_dragging=True, mouse_position=(3.0, -7.0, 20.0),
         mouse_force=80.0, mouse_radius=30.0, gravity=0.7),
]
# tolerances of tests/test_step_pallas.py: one step, and 5 substeps
TOL_1 = dict(rtol=1e-6, atol=1e-6)
TOL_5 = dict(rtol=1e-5, atol=1e-5)


def both_states(n, seed=0):
    """The same state in both packages, velocities from a numpy seed."""
    pos, _, col = G.generate(n)
    vel = np.random.default_rng(seed).normal(size=pos.shape)
    vel = vel.astype(np.float32) * 3.0
    js = JState.from_arrays(pos, vel, col)
    ts = ParticleState.from_arrays(pos, vel, col, device="cpu")
    return js, ts


def pvs(kw):
    return (jnp.asarray(JSimParams(**kw).pack()),
            torch.from_numpy(SimParams(**kw).pack()))


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("n", [100, 5000])
def test_step_matches_jnp(kw, n):
    js, ts = both_states(n)
    jpv, tpv = pvs(kw)
    ep, ev = step_jnp.step(js.pos, js.vel, jpv)
    gp, gv = step_ref.step(ts.pos, ts.vel, tpv)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ep), **TOL_1)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ev), **TOL_1)


@pytest.mark.parametrize("kw", PARAMS)
def test_step_matches_pallas_interpret(kw):
    js, ts = both_states(5000, seed=1)
    jpv, tpv = pvs(kw)
    ep, ev = step_pallas.step(js.pos, js.vel, jpv, interpret=True)
    gp, gv = step_ref.step(ts.pos, ts.vel, tpv)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ep), **TOL_1)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ev), **TOL_1)


@pytest.mark.parametrize("kw", PARAMS)
def test_substeps_match_pallas_interpret(kw):
    js, ts = both_states(2000, seed=2)
    jpv, tpv = pvs(kw)
    ep, ev = step_pallas.step(js.pos, js.vel, jpv, substeps=5,
                              interpret=True)
    gp, gv = step_cuda.step(ts.pos.clone(), ts.vel.clone(), tpv, substeps=5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ep), **TOL_5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ev), **TOL_5)


@pytest.mark.parametrize("kw", PARAMS)
def test_step_n_matches_jnp(kw):
    js, ts = both_states(1500, seed=3)
    jpv, tpv = pvs(kw)
    ep, ev = step_jnp.step_n_jit(jnp.array(js.pos), jnp.array(js.vel), jpv, 5)
    gp, gv = step_ref.step_n(ts.pos, ts.vel, tpv, 5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ep), **TOL_5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ev), **TOL_5)


def test_trajectory_matches_reference_oracle():
    # tests/test_step_jnp.py::test_multi_step_trajectory's bound
    pos, vel, col = G.generate(64)
    ts = ParticleState.from_arrays(pos, vel, col, device="cpu")
    kw = dict(gravity=1.0, is_mouse_dragging=True,
              mouse_position=(0.0, 0.0, 48.0), mouse_force=50.0)
    p = SimParams(**kw)
    tpv = torch.from_numpy(p.pack())
    tp, tv = ts.pos, ts.vel
    exp_pos, exp_vel = pos, vel
    for _ in range(25):
        tp, tv = step_ref.step(tp, tv, tpv)
        exp_pos, exp_vel = reference_step(
            exp_pos, exp_vel, dt=p.delta_time, gravity=p.gravity,
            mouse_force=p.mouse_force, mouse_radius=p.mouse_radius,
            damping=p.damping, mouse_position=p.mouse_position,
            dragging=True)
    got_p = tp.reshape(3, -1)[:, :64].numpy().T
    got_v = tv.reshape(3, -1)[:, :64].numpy().T
    np.testing.assert_allclose(got_p, exp_pos, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_v, exp_vel, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dragging", [False, True])
@pytest.mark.parametrize("gravity", [0.0, 2.5])
def test_step_matches_reference_math(dragging, gravity):
    # tests/test_step_jnp.py::test_step_matches_reference_math's bound
    pos, _, _ = G.generate(300)
    vel = np.random.default_rng(0).normal(size=pos.shape).astype(np.float32)
    vel *= 2.0
    ts = ParticleState.from_arrays(pos, vel, np.zeros_like(pos), device="cpu")
    p = SimParams(gravity=gravity, mouse_force=30.0, mouse_radius=25.0,
                  is_mouse_dragging=dragging, mouse_position=(5.0, -3.0, 40.0))
    gp, gv = step_ref.step(ts.pos, ts.vel, torch.from_numpy(p.pack()))
    exp_pos, exp_vel = reference_step(
        pos, vel, dt=p.delta_time, gravity=p.gravity,
        mouse_force=p.mouse_force, mouse_radius=p.mouse_radius,
        damping=p.damping, mouse_position=p.mouse_position,
        dragging=dragging)
    np.testing.assert_allclose(gp.reshape(3, -1)[:, :300].numpy().T, exp_pos,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gv.reshape(3, -1)[:, :300].numpy().T, exp_vel,
                               rtol=2e-5, atol=2e-5)


def test_dt_zero_keeps_positions_and_damps_velocity():
    _, ts = both_states(1000, seed=4)
    p = SimParams(delta_time=0.0, gravity=3.0, is_mouse_dragging=True,
                  mouse_position=(0.0, 0.0, 45.0), mouse_force=50.0)
    gp, gv = step_ref.step(ts.pos, ts.vel, torch.from_numpy(p.pack()))
    assert torch.equal(gp, ts.pos)
    np.testing.assert_array_equal(gv.numpy(),
                                  (ts.vel * np.float32(0.99)).numpy())


def test_mouse_on_particle_is_finite():
    pos = np.array([[1.0, 2.0, 3.0]], np.float32)
    ts = ParticleState.from_arrays(pos, np.zeros_like(pos),
                                   np.zeros_like(pos), device="cpu")
    p = SimParams(is_mouse_dragging=True, mouse_position=(1.0, 2.0, 3.0))
    gp, gv = step_ref.step(ts.pos, ts.vel, torch.from_numpy(p.pack()))
    assert torch.isfinite(gp).all() and torch.isfinite(gv).all()
    # zero force on the particle at the mouse (padding slots at the origin
    # are inside the reach and are pulled)
    assert float(gv.reshape(3, -1)[:, 0].abs().max()) == 0.0


def test_attractor_cutoff_and_falloff():
    r, F, dt = 10.0, 5.0, 0.016
    pos = np.array([[2 * r, 0, 0], [r, 0, 0], [0.5, 0, 0]], np.float32)
    ts = ParticleState.from_arrays(pos, np.zeros_like(pos),
                                   np.zeros_like(pos), device="cpu")
    p = SimParams(is_mouse_dragging=True, mouse_position=(0, 0, 0),
                  mouse_radius=r, mouse_force=F)
    _, gv = step_ref.step(ts.pos, ts.vel, torch.from_numpy(p.pack()))
    v = gv.reshape(3, -1)[:, :3].numpy().T
    assert v[0, 0] == 0.0                                 # at cutoff
    assert v[1, 0] == pytest.approx(-(1 - 0.5) ** 2 * 2 * F * dt * 0.99,
                                    rel=1e-5)
    assert v[2, 0] < 0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_colors_match_jnp_and_oracle(mode):
    js, ts = both_states(200, seed=5)
    jpv, tpv = pvs(dict(color_mode=mode, max_dist_for_color=50.0))
    exp = np.asarray(step_jnp.colors(js.pos, js.vel, js.init_color, jpv))
    got = step_ref.colors(ts.pos, ts.vel, ts.init_color, tpv).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
    pos, vel = js.positions(), js.velocities()
    col = js.init_colors_rgba()[:, :3]
    oracle = reference_color(pos, vel, col, color_mode=mode, max_dist=50.0)
    np.testing.assert_allclose(got.reshape(3, -1)[:, :200].T, oracle,
                               rtol=1e-5, atol=1e-5)


def test_step_cuda_on_cpu_takes_plain_version_in_place():
    _, ts = both_states(3000, seed=6)
    tpv = torch.from_numpy(SimParams(**PARAMS[2]).pack())
    ep, ev = step_ref.step_n(ts.pos, ts.vel, tpv, 3)
    pos, vel = ts.pos.clone(), ts.vel.clone()
    before = step_cuda.LAUNCHES
    gp, gv = step_cuda.step(pos, vel, tpv, substeps=3)
    assert gp is pos and gv is vel              # updated in place
    assert step_cuda.LAUNCHES == before         # no kernel on the CPU
    assert torch.equal(gp, ep) and torch.equal(gv, ev)


@pytest.mark.parametrize("case", ["dtype", "shape", "params", "substeps",
                                  "noncontig"])
def test_step_cuda_rejects_bad_input(case):
    pos = torch.zeros((3, 8, 128))
    vel = torch.zeros((3, 8, 128))
    pv = torch.from_numpy(SimParams().pack())
    sub = 1
    if case == "dtype":
        vel = vel.double()
    elif case == "shape":
        vel = torch.zeros((3, 16, 128))
    elif case == "params":
        pv = pv[:8]
    elif case == "substeps":
        sub = 0
    else:
        pos = torch.zeros((3, 128, 8)).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        step_cuda.step(pos, vel, pv, substeps=sub)
