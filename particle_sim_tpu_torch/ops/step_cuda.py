"""Attractor step on the hand-written CUDA kernel (csrc/step.cu).

Counterpart of ``particle_sim_tpu/ops/step_pallas.py``. :func:`step` runs
``substeps`` fused attractor steps in one launch and updates ``pos`` and
``vel`` IN PLACE (the JAX version donates them): a caller that keeps the
old tensors sees them change, so clone first where the old state is
needed. On CPU tensors it runs the plain version (ops/step_ref.py), also
in place; on CUDA tensors it launches the kernel or raises.

:func:`kick_step` is the kernel's kicked form: one step after ``vel +=
a * dt``, where ``a`` is an acceleration optionally cleaned of a mean
(the particle mesh's momentum clean) and scaled, all in the one launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.params import PARAM_VEC_SIZE
from ..utils import cuda_build
from . import physics, step_ref

#: Kernel launches made by :func:`step` and :func:`kick_step` in this
#: process.
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


def kick_plain(pos, vel, acc, param_vec, *, mean=None, live=None,
               scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`kick_step`, in the plain PM
    path's operations: ``(acc - mean) * live``, then ``scale * acc``, then
    physics.kick_and_step_planes; copied into ``pos`` and ``vel``."""
    if mean is not None:
        acc = (acc - mean[:, None]) * live.to(torch.float32)[None]
    if scale is not None:
        acc = scale * acc
    p, v = physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)
    pos.copy_(p)
    vel.copy_(v)
    return pos, vel


def _check_operand(name, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype}{list(shape)} on {device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(name, t, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    _check_operand(name, t.reshape(-1), dtype, (1,), device)


def kick_step(pos: torch.Tensor, vel: torch.Tensor, acc: torch.Tensor,
              param_vec: torch.Tensor, *, mean=None, live=None,
              n_active=None, g=None, cell=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vel += a * dt``, then one attractor step, in place on (3, ...)
    planes, in one launch. ``acc``: float32[3, N] contiguous, N the
    particles of ``pos``. ``mean`` (float32[3]): ``a = (acc - mean) *
    live`` first, ``live`` bool[N] or else ``arange(N) < n_active``
    (int32[1] or 0-d). ``g`` (a 0-d or one-element float32): ``a = scale *
    a``, scale ``g``, or ``g / (cell * cell)`` with ``cell`` (the same).
    Every tensor on pos's device. On CPU tensors: :func:`kick_plain`.
    -> (pos, vel), the same tensors."""
    global LAUNCHES
    _check(pos, vel, param_vec, 1)
    n = pos.numel() // 3
    dev = pos.device
    _check_operand("acc", acc, torch.float32, (3, n), dev)
    if mean is not None:
        _check_operand("mean", mean, torch.float32, (3,), dev)
        if live is not None:
            _check_operand("live", live, torch.bool, (n,), dev)
        elif n_active is None:
            raise ValueError("a mean needs live or n_active")
        else:
            _check_scalar("n_active", n_active, torch.int32, dev)
    if g is not None:
        _check_scalar("g", g, torch.float32, dev)
    if cell is not None:
        if g is None:
            raise ValueError("cell scales g: give g")
        _check_scalar("cell", cell, torch.float32, dev)
    if dev.type == "cpu":
        if mean is not None and live is None:
            live = torch.arange(n, dtype=torch.int32) < n_active
        scale = g if cell is None else g / (cell * cell)
        return kick_plain(pos, vel, acc, param_vec, mean=mean, live=live,
                          scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.psim_kick_step(
            pos.data_ptr(), vel.data_ptr(), param_vec.data_ptr(), n,
            acc.data_ptr(), ptr(mean), ptr(live),
            None if mean is None or live is not None else n_active.data_ptr(),
            ptr(g), ptr(cell), stream)
    LAUNCHES += 1
    cuda_build.check(err, "kick step")
    return pos, vel
