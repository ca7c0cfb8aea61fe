"""All-pairs gravity on the hand-written CUDA kernel (csrc/pairwise.cu).

Counterpart of ``particle_sim_tpu/ops/pairwise_pallas.py`` (its
``pairwise_accel`` and ``step_pairwise``), with the same arguments.
:func:`pairwise_accel` takes the plain version (ops/pairwise.py) for CPU
tensors, and on CUDA tensors launches the kernel or raises.

:func:`step_pairwise` is the direct-sum step: the kernel's accelerations,
then a plain ``vel += acc*dt``, then the attractor step kernel
(ops/step_cuda.py) — the order of ``physics.kick_and_step_planes``. Like
the step kernel it updates ``pos`` and ``vel`` IN PLACE.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.params import P_DT
from ..utils import cuda_build
from . import pairwise, step_cuda

#: Kernel launches made by :func:`pairwise_accel` in this process.
LAUNCHES = 0


def _check(x_nx3, x_3xn, masses) -> None:
    for name, t in (("x_nx3", x_nx3), ("x_3xn", x_3xn), ("masses", masses)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x_nx3.device:
            raise ValueError(f"{name} on {t.device}, x_nx3 on "
                             f"{x_nx3.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x_nx3.ndim != 2 or x_nx3.shape[1] != 3:
        raise ValueError(f"x_nx3 must be [Ni, 3], got {tuple(x_nx3.shape)}")
    if x_3xn.ndim != 2 or x_3xn.shape[0] != 3:
        raise ValueError(f"x_3xn must be [3, Nj], got {tuple(x_3xn.shape)}")
    if masses is not None and masses.shape != (x_3xn.shape[1],):
        raise ValueError(f"masses must be [{x_3xn.shape[1]}], got "
                         f"{tuple(masses.shape)}")


def pairwise_accel(x_nx3: torch.Tensor, x_3xn: torch.Tensor, n_active,
                   g_const, softening, *, j_base: int = 0,
                   masses=None) -> torch.Tensor:
    """f32[Ni, 3] accelerations of the receivers ``x_nx3`` (f32[Ni, 3])
    from the sources ``x_3xn`` (f32[3, Nj], global index j_base + j).
    ``n_active``, ``g_const`` and ``softening`` may be Python numbers or
    tensors on the device (then nothing is read back to the host)."""
    global LAUNCHES
    _check(x_nx3, x_3xn, masses)
    dev = x_nx3.device
    if dev.type == "cpu":
        return pairwise.pairwise_accel(x_nx3, x_3xn, n_active, g_const,
                                       softening, j_base=j_base,
                                       masses=masses)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_i, n_j = x_nx3.shape[0], x_3xn.shape[1]
    if max(n_i, n_j) * 3 >= 2 ** 31:
        raise ValueError(f"{n_i} x {n_j} pairs: too many for int32 indexing")
    xi, xj = x_nx3.contiguous(), x_3xn.contiguous()
    gv = pairwise.source_weights(n_j, n_active, g_const, j_base=j_base,
                                 masses=masses, device=dev).contiguous()
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    eps_sq = (eps * eps).reshape(1)
    out = torch.empty((n_i, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.psim_pairwise(xi.data_ptr(), xj.data_ptr(), gv.data_ptr(),
                                eps_sq.data_ptr(), out.data_ptr(), n_i, n_j,
                                stream)
    LAUNCHES += 1
    cuda_build.check(err, "pairwise")
    return out


def step_pairwise(pos: torch.Tensor, vel: torch.Tensor,
                  param_vec: torch.Tensor, pair_vec: torch.Tensor,
                  n_active: torch.Tensor, masses=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direct-sum step on (3, R, LANE) planes, in place.
    -> (pos, vel), the same tensors."""
    if pos.device.type == "cpu":
        p, v = pairwise.step_pairwise(pos, vel, param_vec, pair_vec,
                                      n_active, masses=masses)
        pos.copy_(p)
        vel.copy_(v)
        return pos, vel
    flat = pos.reshape(3, -1)
    acc = pairwise_accel(flat.T, flat, n_active, pair_vec[0], pair_vec[1],
                         masses=masses)
    vel.add_(acc.T.reshape(vel.shape) * param_vec[P_DT])
    return step_cuda.step(pos, vel, param_vec)
