"""Particle-mesh gravity over the mesh: local deposit, grid all-reduce,
solve on every rank, local gather.

Counterpart of ``particle_sim_tpu/parallel/pm_dp.py``. The shards couple
only through the G^3 mass grid, so one all-reduce of the grid (8 MB at
G = 128) replaces the ring's n_dev - 1 rotations (parallel/ring.py). Per
step, on every rank (ops/pm_cuda.py ``step_pm_planes`` with ``coll``):

  1. CIC-deposit the local shard onto a full local grid (the deposit
     kernel, csrc/pm.cu): the grid is dense, every shard reaches every
     cell;
  2. all-reduce SUM the grids: the one large collective;
  3. solve the Poisson convolution (cuFFT) on every rank: replicated
     work beats a sharded FFT at these grids;
  4. gather the accelerations of the local shard only (the gather
     kernel), then clean the momentum globally: the sums kernel, one
     all-reduce of the three weighted sums and the weight, and the clean,
     the G scale and the kick inside the step kernel's launch
     (``pm_cuda.step_pm_planes``). With ``cfg.auto_box`` the box comes
     from an all-reduce MIN and MAX of the local extents.

The communication is O(G^3), independent of N. The global padding is
masked by each shard's local live count: shards hold contiguous rows, so
it is ``clip(n_active - rank * local_n, 0, local_n)``.
"""

from __future__ import annotations

import torch

from ..core import params as Pm
from ..ops import physics, pm_cuda
from .mesh import Collectives


def make_pm_step(mesh, cfg: "Pm.PMConfig", *, use_kernels: bool = False,
                 with_masses: bool = False):
    """-> fn(pos, vel, param_vec, pair_vec, n_active[, masses]) -> (pos,
    vel). ``pos``/``vel``: this rank's (3, R/n_dev, LANE) shard;
    ``n_active``: the GLOBAL active count; ``masses``: this rank's f32
    source masses (the grid all-reduce makes them global).
    ``use_kernels``: the deposit and gather kernels and the step kernel,
    in place; else their plain versions and physics.kick_and_step_planes
    (new tensors). The static box's spectra come from pm's device cache,
    as on one device."""
    coll = Collectives(mesh)

    def step(pos, vel, param_vec, pair_vec, n_active, masses=None):
        if with_masses != (masses is not None):
            raise ValueError("masses given against with_masses")
        shape = pos.shape
        local_n = shape[1] * shape[2]
        local_active = torch.clamp(
            torch.as_tensor(n_active, device=pos.device)
            - coll.rank * local_n, 0, local_n)
        if use_kernels:
            return pm_cuda.step_pm_planes(pos, vel, param_vec, pair_vec[0],
                                          local_active, cfg, masses=masses,
                                          coll=coll)
        acc = pm_cuda.pm_accel(pos.reshape(3, -1), local_active,
                               pair_vec[0], cfg, masses=masses, coll=coll,
                               plain=True)
        return physics.kick_and_step_planes(pos, vel, acc.reshape(shape),
                                            param_vec)

    return step
