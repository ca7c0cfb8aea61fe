"""Attractor step on the hand-written CUDA kernel (csrc/step.cu).

Counterpart of ``particle_sim_tpu/ops/step_pallas.py``. :func:`step` runs
``substeps`` fused attractor steps in one launch and updates ``pos`` and
``vel`` IN PLACE (the JAX version donates them): a caller that keeps the
old tensors sees them change, so clone first where the old state is
needed. On CPU tensors it runs the plain version (ops/step_ref.py), also
in place; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.params import PARAM_VEC_SIZE
from ..utils import cuda_build
from . import step_ref

#: Kernel launches made by :func:`step` in this process.
LAUNCHES = 0


def step_plain(pos, vel, param_vec, *, substeps: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, with the same in-place
    contract."""
    p, v = step_ref.step_n(pos, vel, param_vec, substeps)
    pos.copy_(p)
    vel.copy_(v)
    return pos, vel


def _check(pos, vel, param_vec, substeps: int) -> None:
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    for name, t in (("pos", pos), ("vel", vel), ("param_vec", param_vec)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != pos.device:
            raise ValueError(f"{name} on {t.device}, pos on {pos.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pos.ndim < 2 or pos.shape[0] != 3 or vel.shape != pos.shape:
        raise ValueError(f"pos/vel must be matching (3, ...) planes, got "
                         f"{tuple(pos.shape)} and {tuple(vel.shape)}")
    if param_vec.shape != (PARAM_VEC_SIZE,):
        raise ValueError(f"param_vec must be float32[{PARAM_VEC_SIZE}], got "
                         f"{tuple(param_vec.shape)}")


def step(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor, *,
         substeps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``substeps`` attractor steps on (3, ...) planes, in place.
    -> (pos, vel), the same tensors."""
    global LAUNCHES
    _check(pos, vel, param_vec, substeps)
    if pos.device.type == "cpu":
        return step_plain(pos, vel, param_vec, substeps=substeps)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    lib = cuda_build.library()
    n = pos.numel() // 3
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    with torch.cuda.device(pos.device):
        err = lib.psim_step(pos.data_ptr(), vel.data_ptr(),
                            param_vec.data_ptr(), n, substeps, stream)
    LAUNCHES += 1
    cuda_build.check(err, "step")
    return pos, vel
