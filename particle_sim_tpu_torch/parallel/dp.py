"""Data-parallel (particle-sharded) attractor stepping.

Counterpart of ``particle_sim_tpu/parallel/dp.py``. The state planes are
row-sharded over the ``dp`` mesh (parallel/mesh.py) and every rank steps
its own shard with the single-device stepper: the step kernel
(csrc/step.cu through ops/step_cuda.py, in place) or the plain
ops/step_ref.py. The attractor force depends on a particle's own state
and the broadcast parameters only, so the step calls no collective;
:func:`make_global_mean_speed` shows the all-reduce diagnostics pattern.
"""

from __future__ import annotations

import torch

from ..ops import step_cuda, step_ref
from .mesh import Collectives


def make_sharded_step(mesh, *, use_kernels: bool, substeps: int = 1):
    """-> fn(pos, vel, param_vec) -> (pos, vel) on this rank's (3, R/n_dev,
    LANE) shard: ``substeps`` steps of the step kernel, in place
    (``use_kernels``), or of the plain step_ref.step_n (new tensors).
    No communication."""
    del mesh   # every shard steps alone

    def step(pos, vel, param_vec):
        if use_kernels:
            return step_cuda.step(pos, vel, param_vec, substeps=substeps)
        return step_ref.step_n(pos, vel, param_vec, substeps)

    return step


def make_global_mean_speed(mesh):
    """-> fn(vel) -> 0-d f32: the mean |v| over every rank's shard (one
    all-reduce of the local sum and count)."""
    coll = Collectives(mesh)

    def mean_speed(vel: torch.Tensor) -> torch.Tensor:
        speed = torch.sqrt(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2)
        sc = torch.stack([speed.sum(), torch.tensor(
            float(speed.numel()), dtype=torch.float32, device=vel.device)])
        s, n = coll.sum_(sc)
        return s / n

    return mean_speed
