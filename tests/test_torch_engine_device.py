"""The engine refuses a state or masses placed on another device than its
own (the kernel wrappers would send CPU tensors of a CUDA engine to their
plain versions, so such a state would step on the CPU or fail deep in a
step)."""

import numpy as np
import pytest
import torch

from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.engine import Engine


def meta_state(cap=1024, n=1000):
    planes = [torch.zeros((3, cap // 128, 128), device="meta")
              for _ in range(3)]
    return ParticleState(*planes, n_active=torch.tensor(
        n, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("bad", ["pos", "vel", "init_color", "n_active"])
def test_state_on_another_device_is_refused(bad):
    """Any of the four tensors on the meta device raises ValueError naming
    both devices; the engine keeps its state."""
    e = Engine(particle_count=1000, device="cpu")
    before = e.state
    good = ParticleState.from_arrays(np.ones((1000, 3), np.float32),
                                     np.zeros((1000, 3), np.float32),
                                     np.ones((1000, 3), np.float32),
                                     device="cpu")
    st = ParticleState(**{**good.__dict__,
                          bad: getattr(meta_state(), bad)})
    with pytest.raises(ValueError, match="meta.*cpu"):
        e.state = st
    assert e.state is before and e.particle_count == 1000


def test_state_on_the_engine_device_is_taken():
    e = Engine(particle_count=1000, device="cpu")
    pos = np.random.default_rng(0).normal(size=(3000, 3)).astype(np.float32)
    e.state = ParticleState.from_arrays(pos, np.zeros_like(pos),
                                        np.ones_like(pos), device="cpu")
    assert e.particle_count == 3000 and e.capacity >= 3000
    np.testing.assert_array_equal(e.state.positions(), pos)


def test_masses_on_another_device_are_refused():
    """set_masses takes a host array or a tensor on the engine's device;
    a tensor elsewhere raises ValueError and leaves the masses unset."""
    e = Engine(particle_count=1000, device="cpu")
    with pytest.raises(ValueError, match="meta.*cpu"):
        e.set_masses(torch.ones(1000, device="meta"))
    assert e.masses is None
    e.set_masses(torch.full((1000,), 2.0))
    np.testing.assert_array_equal(e.masses.numpy()[:1000], 2.0)
    e.set_masses(np.full(1000, 3.0, np.float32))
    np.testing.assert_array_equal(e.masses.numpy()[:1000], 3.0)
