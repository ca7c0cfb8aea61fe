"""The initial state of a run, made from ``--seed`` on the run's device.

The hollow sphere of the reference application (the golden-angle
spiral: ``y_i = 1 - 2 i / (n - 1)``, ``r_y = sqrt(1 - y^2)``,
``theta_i = pi (3 - sqrt(5)) i``, radius 50), computed here in float64
on the device, then turned by a rotation drawn from the seed: every seed
gets the same sphere, the same sizes and the same work, in another
orientation against the PM grid. Velocities are 0 and the colour is the
generation rule ``(pos / radius + 1) / 2``. The optional central mass
sits on particle 0, as the CLI's ``--central-mass`` puts it.

The benchmark hands these planes to the program (``engine.state``,
``engine.set_masses``) and the same planes to the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

LANE = 128
#: The capacity of a state is a multiple of this (8 rows of 128 lanes).
CAPACITY_MULTIPLE = 1024
GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


class Initial(NamedTuple):
    """Planes f32[3, capacity] (dead slots 0) and the live count."""

    pos: torch.Tensor
    vel: torch.Tensor
    col: torch.Tensor
    n: int
    masses: Optional[torch.Tensor]   # f32[capacity] or None (unit masses)


def rotation(seed: int) -> np.ndarray:
    """A rotation matrix (float64[3, 3]) uniform over the rotations, from
    a unit quaternion drawn from ``seed``."""
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def capacity(n: int) -> int:
    return max(-(-n // CAPACITY_MULTIPLE), 1) * CAPACITY_MULTIPLE


def hollow_sphere(n: int, radius: float, rot: np.ndarray,
                  device) -> torch.Tensor:
    """f32[3, n]: the golden-angle sphere turned by ``rot``."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    y = 1.0 - (i / max(n - 1, 1)) * 2.0
    r_y = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    theta = GOLDEN_ANGLE * i
    pos = torch.stack([torch.cos(theta) * r_y, y, torch.sin(theta) * r_y])
    rot_t = torch.as_tensor(rot, dtype=torch.float64, device=device)
    return (rot_t @ (pos * radius)).to(torch.float32)


def initial(config: dict, seed: int, device) -> Initial:
    """The seeded initial state of ``config`` on ``device``."""
    if config["generation"] != "hollow":
        raise ValueError(f"generation {config['generation']!r}: only the "
                         "hollow sphere is made here")
    n, radius = int(config["count"]), float(config["radius"])
    cap = capacity(n)
    pos = torch.zeros((3, cap), dtype=torch.float32, device=device)
    pos[:, :n] = hollow_sphere(n, radius, rotation(seed), device)
    col = torch.zeros_like(pos)
    col[:, :n] = (pos[:, :n] / radius + 1.0) * 0.5
    masses = None
    if config.get("central_mass", 0.0) > 0.0:
        masses = torch.ones((cap,), dtype=torch.float32, device=device)
        masses[0] = float(config["central_mass"])
    return Initial(pos, torch.zeros_like(pos), col, n, masses)
