"""Deterministic initial-state generators (host-side numpy).

Counterpart of ``particle_sim_tpu/core/generate.py``, and bit-identical to
it: the same float64 numpy arithmetic and the same PCG64 stream for the
seeded Filled mode.

  * **Hollow** — golden-angle spiral on the sphere surface:
    ``y_i = 1 - 2*i/(n-1)``, ``r_y = sqrt(1 - y^2)``,
    ``theta_i = pi*(3 - sqrt(5)) * i``, ``pos = 50 * (cos(theta)*r_y, y,
    sin(theta)*r_y)``.
  * **Filled** — uniform in the sphere volume: ``r = 50 * u1^(1/3)``,
    ``theta = 2*pi*u2``, ``phi = acos(2*u3 - 1)`` from
    ``numpy.random.default_rng(seed)``.

Both: velocity = 0, initial color = ``(pos/50 + 1)/2`` (alpha 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .params import FILLED_SEED, SPHERE_RADIUS, SphereGeneration

GOLDEN_ANGLE = np.pi * (3.0 - np.sqrt(5.0))


def generate_hollow(count: int) -> np.ndarray:
    """float32[count, 3] positions on the golden-angle spiral sphere."""
    if count <= 0:
        return np.zeros((0, 3), dtype=np.float32)
    i = np.arange(count, dtype=np.float64)
    denom = max(count - 1, 1)  # count == 1 would divide 0 by 0
    y = 1.0 - (i / denom) * 2.0
    r_y = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = GOLDEN_ANGLE * i
    pos = np.stack([np.cos(theta) * r_y, y, np.sin(theta) * r_y], axis=1)
    return (pos * SPHERE_RADIUS).astype(np.float32)


def generate_filled(count: int, seed: int = FILLED_SEED) -> np.ndarray:
    """float32[count, 3] positions uniform in the sphere volume."""
    if count <= 0:
        return np.zeros((0, 3), dtype=np.float32)
    rng = np.random.default_rng(seed)
    u = rng.random((3, count), dtype=np.float64)
    r = SPHERE_RADIUS * np.cbrt(u[0])          # cube root: uniform in volume
    theta = u[1] * 2.0 * np.pi
    phi = np.arccos(u[2] * 2.0 - 1.0)          # uniform on [-1,1] in cos(phi)
    sin_phi = np.sin(phi)
    pos = np.stack(
        [r * sin_phi * np.cos(theta), r * np.cos(phi), r * sin_phi * np.sin(theta)],
        axis=1,
    )
    return pos.astype(np.float32)


def initial_colors(positions: np.ndarray) -> np.ndarray:
    """float32[n, 3] rgb = (pos/50 + 1)/2 (alpha is 1)."""
    return ((positions / SPHERE_RADIUS + 1.0) * 0.5).astype(np.float32)


def generate(
    count: int, mode: SphereGeneration = SphereGeneration.HOLLOW,
    seed: int = FILLED_SEED,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, velocities, init_colors_rgb), each float32[count, 3]."""
    if mode == SphereGeneration.HOLLOW:
        pos = generate_hollow(count)
    elif mode == SphereGeneration.FILLED:
        pos = generate_filled(count, seed=seed)
    else:
        raise ValueError(f"unknown generation mode: {mode!r}")
    vel = np.zeros_like(pos)
    return pos, vel, initial_colors(pos)
