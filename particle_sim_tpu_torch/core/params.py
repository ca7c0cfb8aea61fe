"""Simulation parameters and enums.

Counterpart of ``particle_sim_tpu/core/params.py``. The packed parameter
vector keeps the same ``P_*`` slots, so one ``float32[16]`` vector drives
both packages and the CUDA step kernel reads it straight from device
memory (parameter edits never rebuild or re-specialise anything). The
enums keep their integer values, so checkpoints cross between packages.

The attractor configuration and the direct-sum gravity configuration
(``PairwiseParams``) are carried here; the particle-mesh configuration
(``PMConfig``) arrives with its solver.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

# Indices into the packed parameter vector; the CUDA step kernel
# (csrc/step.cu) reads the same slots.
P_DT = 0
P_GRAVITY = 1
P_MOUSE_FORCE = 2
P_MOUSE_RADIUS = 3
P_DAMPING = 4
P_MAX_DIST = 5
P_MOUSE_X = 6
P_MOUSE_Y = 7
P_MOUSE_Z = 8
P_DRAGGING = 9  # 0.0 / 1.0
P_COLOR_MODE = 10  # 0.0 / 1.0 / 2.0 (compared against 0.5 / 1.5 thresholds)
PARAM_VEC_SIZE = 16  # padded for alignment / future fields

#: Initial sphere radius (``sphere_radius = 50.0`` of the reference).
SPHERE_RADIUS = 50.0

#: Fixed RNG seed of the Filled generator (the reference's SmallRng seed).
FILLED_SEED = 69


class ColorMode(enum.IntEnum):
    """Per-particle color switch."""

    ORIGINAL = 0   # color = initial_color
    VELOCITY = 1   # s=clamp(|v|/5,0,1) -> (s, 0.5-0.5s, 1-s, 1)
    POSITION = 2   # d=clamp(|p|/max(max_dist,0.01),0,1) -> (d, 0, 1-d, 1)


class SphereGeneration(enum.IntEnum):
    HOLLOW = 0
    FILLED = 1


class Method(enum.IntEnum):
    """Stepper selector; the values match the JAX package's ``Method``.

    TORCH — plain PyTorch stepper (ops/step_ref.py), any device.
    CUDA  — the hand-written CUDA kernel (ops/step_cuda.py), CUDA only.
    """

    TORCH = 0
    CUDA = 1


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Per-step simulation parameters (the reference's defaults)."""

    delta_time: float = 0.016
    gravity: float = 0.0
    color_mode: int = int(ColorMode.ORIGINAL)
    mouse_force: float = 5.0
    mouse_radius: float = 10.0
    is_mouse_dragging: bool = False
    damping: float = 0.99
    max_dist_for_color: float = 50.0
    mouse_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def pack(self) -> np.ndarray:
        """Pack into the float32 parameter vector fed to the steppers."""
        v = np.zeros((PARAM_VEC_SIZE,), dtype=np.float32)
        v[P_DT] = self.delta_time
        v[P_GRAVITY] = self.gravity
        v[P_MOUSE_FORCE] = self.mouse_force
        v[P_MOUSE_RADIUS] = self.mouse_radius
        v[P_DAMPING] = self.damping
        v[P_MAX_DIST] = self.max_dist_for_color
        v[P_MOUSE_X : P_MOUSE_Z + 1] = self.mouse_position
        v[P_DRAGGING] = 1.0 if self.is_mouse_dragging else 0.0
        v[P_COLOR_MODE] = float(self.color_mode)
        return v

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PairwiseParams:
    """Parameters of the all-pairs O(N^2) softened gravity:

        a_i = G * sum_j m_j * (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2)

    The softening makes the self-pair contribute exactly zero (its
    numerator is 0), so no self-interaction mask is needed.
    """

    gravitational_constant: float = 1.0
    softening: float = 0.5

    def pack(self) -> np.ndarray:
        """-> float32[2]: (G, softening)."""
        return np.array(
            [self.gravitational_constant, self.softening], dtype=np.float32
        )
