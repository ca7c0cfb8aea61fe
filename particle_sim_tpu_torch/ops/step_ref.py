"""Plain PyTorch stepper: the reference the CUDA step kernel is held to.

Counterpart of ``particle_sim_tpu/ops/step_jnp.py``. The same math as
ops/physics.py over ``(3, ...)`` component planes on any device; every
parameter is a slot of the packed float32 vector (a tensor on the
planes' device), so parameter edits cost nothing. Returns new tensors;
the inputs are left as they were.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import params as P
from . import physics


def _unpack(pv: torch.Tensor) -> dict:
    return dict(
        dt=pv[P.P_DT], gravity=pv[P.P_GRAVITY],
        mouse_force=pv[P.P_MOUSE_FORCE], mouse_radius=pv[P.P_MOUSE_RADIUS],
        damping=pv[P.P_DAMPING],
        mouse_x=pv[P.P_MOUSE_X], mouse_y=pv[P.P_MOUSE_Y],
        mouse_z=pv[P.P_MOUSE_Z], dragging=pv[P.P_DRAGGING],
    )


def step(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attractor step on (3, ...) component planes."""
    px, py, pz, vx, vy, vz = physics.attractor_step(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2], **_unpack(param_vec))
    return torch.stack([px, py, pz]), torch.stack([vx, vy, vz])


def step_n(pos, vel, param_vec, n_steps: int):
    """``n_steps`` steps with constant parameters."""
    for _ in range(n_steps):
        pos, vel = step(pos, vel, param_vec)
    return pos, vel


def colors(pos, vel, init_color, param_vec) -> torch.Tensor:
    """RGB planes (3, ...) for the current state."""
    r, g, b = physics.color_rgb(
        pos[0], pos[1], pos[2], vel[0], vel[1], vel[2],
        init_color[0], init_color[1], init_color[2],
        color_mode=param_vec[P.P_COLOR_MODE],
        max_dist_for_color=param_vec[P.P_MAX_DIST],
    )
    return torch.stack([r, g, b])
