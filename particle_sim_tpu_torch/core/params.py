"""Simulation parameters and enums.

Counterpart of ``particle_sim_tpu/core/params.py``. The packed parameter
vector keeps the same ``P_*`` slots, so one ``float32[16]`` vector drives
both packages and the CUDA step kernel reads it straight from device
memory (parameter edits never rebuild or re-specialise anything). The
enums keep their integer values, so checkpoints cross between packages.

The attractor configuration, the direct-sum gravity configuration
(``PairwiseParams``) and the particle-mesh configuration (``PMConfig``)
are carried here.
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


@dataclasses.dataclass(frozen=True)
class PMConfig:
    """Particle-mesh solver configuration (ops/pm.py, ops/pm_cuda.py).

    PM solves the same softened gravity as PairwiseParams' direct sum, at
    O(N + G^3 log G): CIC deposit -> FFT Poisson -> CIC gather. The fields
    are fixed per solver (they shape the grids and the cached Green's
    function spectra); the per-step G constant stays in
    PairwiseParams.pack(). The same fields and defaults as the JAX
    package's PMConfig, so checkpoints carry it across.

    grid:      cells per axis (the CUDA kernels take any size; the JAX
               package's TPU kernels take 32/64/128/256).
    box_min:   world coords of the grid origin.
    box_size:  world extent per axis; cell size h = box_size/grid. Default
               box spans [-64, 64)^3 around the radius-50 generation sphere
               with margin, h = 1.
    softening: Plummer eps (fixed per solver: it shapes the kernel
               spectra, unlike PairwiseParams.softening). Resolve eps >=
               ~2h or short-range forces fall below mesh resolution.
    boundary:  'isolated' (vacuum, Hockney doubled grid — parity with the
               direct sum) or 'periodic' (closed-form Fourier kernel,
               ~8x cheaper FFTs, periodic images).
    gradient:  'exact' (three inverse vector-kernel FFTs) or 'fd' (one
               potential FFT + central differences).
    auto_box:  True -> ignore box_min/box_size and track the live cloud
               with a cubic box recomputed on the device every step
               (auto-zoom). ``softening`` is then in CELL units (the
               physical eps = softening * cell_size shrinks as the cloud
               does), because the cached spectra must be box-independent.
               Adaptive softening changes the energy budget through deep
               collapses; use the static box for strict energy studies.
    """

    grid: int = 128
    box_min: Tuple[float, float, float] = (-64.0, -64.0, -64.0)
    box_size: float = 128.0
    softening: float = 2.0
    boundary: str = "isolated"
    gradient: str = "exact"
    auto_box: bool = False

    @property
    def cell_size(self) -> float:
        return self.box_size / self.grid
