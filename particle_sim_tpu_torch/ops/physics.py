"""Shared per-particle physics and color math, in plain PyTorch.

Counterpart of ``particle_sim_tpu/ops/physics.py``, with the same
operation order, so the plain stepper (ops/step_ref.py), the rasterizers
and the CUDA step kernel (csrc/step.cu, which transcribes
:func:`attractor_step` line for line) agree to float32 rounding.
Functions take per-component tensors of any broadcast-compatible shape;
scalars may be Python floats or 0-d float32 tensors (slots of the packed
parameter vector).

  1. gravity:   v.y -= g * dt
  2. attractor: if dragging and |m - p| < 2*r:
                  f = normalize(m - p) * F * (1 - d/(2r))^2 * 2
                  v += f * dt
  3. integrate: p += v * dt        — position BEFORE damping
  4. damping:   v *= damping

``normalize`` is taken around one clamped reciprocal square root,
``rsqrt(max(d^2, 1e-24))``, so a particle exactly at the mouse gets zero
force instead of NaN.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import params as P

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _norm(x, y, z) -> torch.Tensor:
    """|(x, y, z)| in float32, with a correctly rounded square root on every
    device: the sqrt is taken in float64 and rounded once to float32. (The
    CPU build's vectorised float32 sqrt is not correctly rounded, and an
    ulp of brightness would move a pixel against the JAX package.)"""
    return torch.sqrt((x * x + y * y + z * z).double()).float()


def attractor_step(
    px, py, pz, vx, vy, vz,
    *, dt, gravity, mouse_force, mouse_radius, damping,
    mouse_x, mouse_y, mouse_z, dragging,
) -> Tuple[torch.Tensor, ...]:
    """One physics step -> (px, py, pz, vx, vy, vz).

    ``dragging`` is a float (0.0/1.0): the attractor's ``if`` is a
    multiply by a select, so the step is branchless.
    """
    # 1. gravity (y only)
    vy = vy - gravity * dt

    # 2. mouse attractor with quadratic falloff, around one rsqrt: dist and
    # 1/dist both come from rsqrt(dist^2); the cutoff compares squares
    dx = mouse_x - px
    dy = mouse_y - py
    dz = mouse_z - pz
    dist_sq = dx * dx + dy * dy + dz * dz
    reach = mouse_radius * 2.0
    inv_dist = torch.rsqrt(torch.clamp_min(dist_sq, 1e-24))  # safe normalize
    norm_dist = dist_sq * inv_dist * (1.0 / reach)           # = dist / reach
    t = 1.0 - norm_dist
    within = (dist_sq < reach * reach).to(torch.float32) * dragging
    scale = within * (mouse_force * 2.0 * dt) * t * t * inv_dist
    vx = vx + dx * scale
    vy = vy + dy * scale
    vz = vz + dz * scale

    # 3. integrate position BEFORE damping
    px = px + vx * dt
    py = py + vy * dt
    pz = pz + vz * dt

    # 4. damping
    vx = vx * damping
    vy = vy * damping
    vz = vz * damping
    return px, py, pz, vx, vy, vz


def color_rgb(
    px, py, pz, vx, vy, vz, cr, cg, cb,
    *, color_mode, max_dist_for_color,
) -> Vec3:
    """Per-particle RGB by color mode (alpha is 1).

    ``color_mode`` (0/1/2) is selected branchlessly; mode 0 and any
    unknown mode give the initial color.
    """
    # mode 1: speed — s = clamp(|v|/5, 0, 1) -> (s, 0.5 - s/2, 1 - s)
    s = torch.clamp(_norm(vx, vy, vz) * 0.2, 0.0, 1.0)

    # mode 2: distance from origin — d = clamp(|p|/max(max_dist, 0.01), 0, 1)
    d = torch.clamp(_norm(px, py, pz) / torch.clamp_min(max_dist_for_color, 0.01),
                    0.0, 1.0)

    is1 = (torch.abs(color_mode - 1.0) < 0.5).to(torch.float32)
    is2 = (torch.abs(color_mode - 2.0) < 0.5).to(torch.float32)
    is0 = 1.0 - is1 - is2

    r = is0 * cr + is1 * s + is2 * d
    g = is0 * cg + is1 * (0.5 - s * 0.5)
    b = is0 * cb + is1 * (1.0 - s) + is2 * (1.0 - d)
    return r, g, b


def brightness(vx, vy, vz) -> torch.Tensor:
    """Fragment brightness = min(2*|v|, 1)."""
    return torch.clamp_max(_norm(vx, vy, vz) * 2.0, 1.0)


def kick_and_step_planes(pos, vel, acc, param_vec):
    """Shared tail of the interaction solvers: accumulate an external
    acceleration into velocity (``vel = vel + acc*dt``, two rounded ops),
    then run :func:`attractor_step`, on ``(3, ...)`` component planes.
    ``acc`` must broadcast to ``pos.shape``; ``param_vec`` is the packed
    SimParams vector. -> (pos, vel), new tensors."""
    dt = param_vec[P.P_DT]
    vel = vel + acc * dt
    px, py, pz, vx, vy, vz = attractor_step(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2],
        dt=dt, gravity=param_vec[P.P_GRAVITY],
        mouse_force=param_vec[P.P_MOUSE_FORCE],
        mouse_radius=param_vec[P.P_MOUSE_RADIUS],
        damping=param_vec[P.P_DAMPING],
        mouse_x=param_vec[P.P_MOUSE_X], mouse_y=param_vec[P.P_MOUSE_Y],
        mouse_z=param_vec[P.P_MOUSE_Z], dragging=param_vec[P.P_DRAGGING],
    )
    return torch.stack([px, py, pz]), torch.stack([vx, vy, vz])
