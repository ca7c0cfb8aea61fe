"""Port core (params, generate, state) against the JAX package's core."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as jgen
from particle_sim_tpu.core import params as jparams
from particle_sim_tpu.core import state as jstate
from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.engine import Engine as JEngine

from particle_sim_tpu_torch.core import generate as tgen
from particle_sim_tpu_torch.core import params as tparams
from particle_sim_tpu_torch.core import state as tstate
from particle_sim_tpu_torch.engine import Engine as TEngine

torch.set_num_threads(1)

PARAMS = [
    {},
    dict(gravity=2.0),
    dict(is_mouse_dragging=True, mouse_position=(3.0, -7.0, 20.0),
         mouse_force=80.0, mouse_radius=30.0, gravity=0.7),
    dict(color_mode=2, max_dist_for_color=12.5, damping=0.5,
         delta_time=0.004),
]


@pytest.mark.parametrize("kw", PARAMS)
def test_pack_vectors_equal(kw):
    a = jparams.SimParams(**kw).pack()
    b = tparams.SimParams(**kw).pack()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_param_slots_equal():
    names = [n for n in dir(jparams) if n.startswith("P_")]
    assert names
    for name in names + ["PARAM_VEC_SIZE", "SPHERE_RADIUS", "FILLED_SEED"]:
        assert getattr(tparams, name) == getattr(jparams, name), name


@pytest.mark.parametrize("enum_name", ["ColorMode", "SphereGeneration"])
def test_enum_values_equal(enum_name):
    j = {m.name: int(m) for m in getattr(jparams, enum_name)}
    t = {m.name: int(m) for m in getattr(tparams, enum_name)}
    assert j == t


def test_method_values_equal():
    # same integers, port names: 0 = plain path, 1 = kernels
    assert int(tparams.Method.TORCH) == int(JMethod.JNP) == 0
    assert int(tparams.Method.CUDA) == int(JMethod.PALLAS) == 1


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("count", [0, 1, 333, 5000])
def test_generator_bit_identical(mode, count):
    a = jgen.generate(count, jparams.SphereGeneration(mode))
    b = tgen.generate(count, tparams.SphereGeneration(mode))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1024, 1025, 100_000])
@pytest.mark.parametrize("row_multiple", [8, 32])
def test_capacity_rows_equal(n, row_multiple):
    assert (tstate.capacity_rows(n, row_multiple)
            == jstate.capacity_rows(n, row_multiple))


@pytest.mark.parametrize("counts", [(3000, 500, 2500, 9000),
                                    (1000, 2500, 1, 1024)])
def test_grow_shrink_capacities_equal(counts):
    je = JEngine(particle_count=counts[0], method=JMethod.JNP)
    te = TEngine(particle_count=counts[0], device="cpu")
    for n in counts[1:]:
        je.resize(n)
        te.resize(n)
        assert te.capacity == je.capacity
        assert te.particle_count == je.particle_count
        np.testing.assert_array_equal(te.state.positions(),
                                      je.state.positions())


def test_grow_state_matches_jax():
    pos, vel, col = jgen.generate(1000)
    tail = [a[:300] + 1.0 for a in (pos, vel, col)]
    js = jstate.grow_state(jstate.ParticleState.from_arrays(pos, vel, col),
                           *tail, 1300)
    ts = tstate.grow_state(
        tstate.ParticleState.from_arrays(pos, vel, col, device="cpu"),
        *tail, 1300)
    assert int(ts.n_active) == int(js.n_active) == 1300
    for a, b in ((ts.pos, js.pos), (ts.vel, js.vel),
                 (ts.init_color, js.init_color)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_from_planes_roundtrip():
    pos, _, col = jgen.generate(2000)
    vel = np.random.default_rng(0).normal(size=pos.shape).astype(np.float32)
    js = jstate.ParticleState.from_arrays(pos, vel, col)
    ts = tstate.ParticleState.from_planes(
        np.asarray(js.pos), np.asarray(js.vel), np.asarray(js.init_color),
        np.asarray(js.n_active), device="cpu")
    assert ts.n_active.dtype == torch.int32 and ts.n_active.ndim == 0
    assert ts.capacity == js.capacity and ts.rows == js.rows
    np.testing.assert_array_equal(ts.positions(), js.positions())
    np.testing.assert_array_equal(ts.velocities(), js.velocities())
    np.testing.assert_array_equal(ts.init_colors_rgba(), js.init_colors_rgba())
    # and back: the port's planes build the same JAX state
    back = jstate.ParticleState(
        pos=jnp.asarray(ts.pos.numpy()), vel=jnp.asarray(ts.vel.numpy()),
        init_color=jnp.asarray(ts.init_color.numpy()),
        n_active=jnp.asarray(int(ts.n_active), jnp.int32))
    np.testing.assert_array_equal(back.positions(), pos)


def test_from_planes_copies_input():
    planes = np.zeros((3, 8, 128), np.float32)
    ts = tstate.ParticleState.from_planes(planes, planes, planes, 5,
                                          device="cpu")
    planes[0, 0, 0] = 7.0
    assert float(ts.pos[0, 0, 0]) == 0.0
    ts.pos[1, 0, 0] = 3.0
    assert float(ts.vel[1, 0, 0]) == 0.0    # independent buffers


@pytest.mark.parametrize("bad", [(3, 8, 64), (2, 8, 128), (3, 1024)])
def test_from_planes_rejects_bad_shape(bad):
    planes = np.zeros(bad, np.float32)
    with pytest.raises(ValueError):
        tstate.ParticleState.from_planes(planes, planes, planes, 0,
                                         device="cpu")


def test_from_arrays_matches_jax_padding():
    n = 333
    pos, vel, col = jgen.generate(n)
    js = jstate.ParticleState.from_arrays(pos, vel, col)
    ts = tstate.ParticleState.from_arrays(pos, vel, col, device="cpu")
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.init_color.numpy(),
                                  np.asarray(js.init_color))
    with pytest.raises(ValueError):
        tstate.ParticleState.from_arrays(pos, vel, col, device="cpu",
                                         capacity=128)

