"""The initial state of a run, made from ``--seed`` on the run's device.

The configuration's ``generation`` names the scene. Every scene is
turned by a rotation drawn from the seed, so every seed gets the same
scene, the same sizes and the same work, in another orientation against
the PM grid. Dead slots are 0.

  * ``"hollow"``: the reference application's hollow sphere (the
    golden-angle spiral: ``y_i = 1 - 2 i / (n - 1)``,
    ``r_y = sqrt(1 - y^2)``, ``theta_i = pi (3 - sqrt(5)) i``) of the
    configuration's ``radius``, computed in float64 on the device, then
    turned and cast.
  * ``"filled"``: the reference application's filled sphere (the CLI's
    ``--generation filled``), uniform in the ball of ``radius``:
    ``r = radius cbrt(u1)``, ``theta = 2 pi u2``, ``phi = acos(2 u3 - 1)``
    from numpy's PCG64 stream of the fixed seed 69, in float64, cast to
    float32, then turned.
  * ``"deep_zoom_scene"``: the deep-zoom example's scene
    (``examples/deep_zoom.py``'s ``make_scene(n, seed=13)``, value for
    value): a core of n // 4 particles of radius 0.8 and a cluster of
    n // 4 of radius 4, both around (14, 6, -4) and spinning as a solid
    body (``vx = -0.25 rel_z``, ``vz = 0.25 rel_x``), and a halo of the
    rest, of radius 40 at the origin and at rest; made in float32, then
    positions and velocities turned. Colour 0.7, as the example sets it.

The spheres start at rest, coloured by the generation rule
``(pos / radius + 1) / 2``. The filled sphere and the scene are made and
turned on the host (:func:`turn`), so every device gets the same bits.
The optional central mass sits on particle 0, as the CLI's
``--central-mass`` puts it; the other masses are 1.

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
#: The scenes made here; the spheres are the CLI's ``--generation``.
SPHERES = ("hollow", "filled")
GENERATIONS = (*SPHERES, "deep_zoom_scene")
#: The filled sphere's fixed seed (the reference application's).
FILLED_SEED = 69
#: The deep-zoom example's scene: its seed, the centre of its cluster and
#: core, their spin rate, and the colour of every particle.
SCENE_SEED = 13
SCENE_CENTRE = (14.0, 6.0, -4.0)
SCENE_SPIN = 0.25
SCENE_COLOUR = 0.7


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


def filled_sphere(n: int, radius: float) -> np.ndarray:
    """f32[3, n]: the filled sphere, unturned."""
    u = np.random.default_rng(FILLED_SEED).random((3, n), dtype=np.float64)
    r = radius * np.cbrt(u[0])
    theta = u[1] * 2.0 * np.pi
    phi = np.arccos(u[2] * 2.0 - 1.0)
    sin_phi = np.sin(phi)
    return np.stack([r * sin_phi * np.cos(theta), r * np.cos(phi),
                     r * sin_phi * np.sin(theta)]).astype(np.float32)


def deep_zoom_scene(n: int) -> tuple:
    """(pos, vel) f32[n, 3]: the example's core, cluster and halo, in
    that order, unturned."""
    rng = np.random.default_rng(SCENE_SEED)
    n_core, n_cl = n // 4, n // 4
    centre = np.array(SCENE_CENTRE, dtype=np.float32)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + off

    pos = np.concatenate([ball(n_core, 0.8, centre),
                          ball(n_cl, 4.0, centre),
                          ball(n - n_core - n_cl, 40.0, 0.0)])
    vel = np.zeros_like(pos)
    rel = pos[: n_core + n_cl] - centre
    vel[: n_core + n_cl, 0] = -SCENE_SPIN * rel[:, 2]
    vel[: n_core + n_cl, 2] = SCENE_SPIN * rel[:, 0]
    return pos, vel


def turn(rot: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """f32[3, n]: float32 planes turned by ``rot`` in float64 (three
    products and two sums a component, in that order), cast once."""
    p = planes.astype(np.float64)
    return np.stack([rot[i, 0] * p[0] + rot[i, 1] * p[1] + rot[i, 2] * p[2]
                     for i in range(3)]).astype(np.float32)


def initial(config: dict, seed: int, device) -> Initial:
    """The seeded initial state of ``config`` on ``device``."""
    gen = config["generation"]
    if gen not in GENERATIONS:
        raise ValueError(f"generation {gen!r}: the state maker makes "
                         f"{', '.join(GENERATIONS)}")
    n = int(config["count"])
    cap = capacity(n)
    rot = rotation(seed)
    pos = torch.zeros((3, cap), dtype=torch.float32, device=device)
    vel = torch.zeros_like(pos)
    col = torch.zeros_like(pos)
    if gen == "hollow":
        radius = float(config["radius"])
        pos[:, :n] = hollow_sphere(n, radius, rot, device)
        col[:, :n] = (pos[:, :n] / radius + 1.0) * 0.5
    elif gen == "filled":
        radius = float(config["radius"])
        p = turn(rot, filled_sphere(n, radius))
        pos[:, :n] = torch.from_numpy(p)
        col[:, :n] = torch.from_numpy((p / radius + 1.0) * 0.5)
    else:
        p, v = deep_zoom_scene(n)
        pos[:, :n] = torch.from_numpy(turn(rot, p.T))
        vel[:, :n] = torch.from_numpy(turn(rot, v.T))
        col[:, :n] = SCENE_COLOUR
    masses = None
    if config.get("central_mass", 0.0) > 0.0:
        masses = torch.ones((cap,), dtype=torch.float32, device=device)
        masses[0] = float(config["central_mass"])
    return Initial(pos, vel, col, n, masses)
