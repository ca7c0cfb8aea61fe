"""Particle state: SoA component planes on one device.

Counterpart of ``particle_sim_tpu/core/state.py``. The layout is kept as
it is there, so states cross between the packages without reshuffling:

  * position, velocity and initial color are ``float32[3, R, 128]``
    component planes (x/y/z or r/g/b first), ``R`` from
    :func:`capacity_rows`, so the capacity is a multiple of 1024 and the
    flat ``[3, R*128]`` view that the CUDA kernels walk costs nothing;
  * ``n_active`` is the live particle count as a 0-d int32 tensor on the
    state's device; padding slots past it are zero and stepped harmlessly;
  * the current color is not stored: consumers compute it from
    (position, velocity, initial color, parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

LANE = 128      # last-dim width of a plane row
SUBLANE = 8     # row alignment of the capacity


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def capacity_rows(n: int, row_multiple: int = SUBLANE) -> int:
    """Rows R such that capacity = R*LANE >= n, R a multiple of 8."""
    return max(round_up(cdiv(max(n, 1), LANE), row_multiple), row_multiple)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state. All planes are ``float32[3, R, LANE]``.

    ``pos[c]``/``vel[c]`` hold the x/y/z component planes; ``init_color[c]``
    the r/g/b channels of the generation color (alpha is always 1).
    ``n_active`` is a 0-d int32 tensor on the planes' device.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    init_color: torch.Tensor
    n_active: torch.Tensor

    @property
    def rows(self) -> int:
        return self.pos.shape[1]

    @property
    def capacity(self) -> int:
        return self.pos.shape[1] * self.pos.shape[2]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        positions: np.ndarray,      # float32[n, 3]
        velocities: np.ndarray,     # float32[n, 3]
        init_colors: np.ndarray,    # float32[n, 3] (rgb) or [n, 4]
        *,
        device,
        capacity: Optional[int] = None,
        row_multiple: int = SUBLANE,
    ) -> "ParticleState":
        n = positions.shape[0]
        rows = (capacity_rows(n, row_multiple) if capacity is None
                else capacity // LANE)
        if rows * LANE < n:
            raise ValueError(f"capacity {rows * LANE} < particle count {n}")

        def to_planes(a: np.ndarray) -> np.ndarray:
            buf = np.zeros((3, rows * LANE), dtype=np.float32)
            buf[:, :n] = np.asarray(a, dtype=np.float32)[:, :3].T
            return buf.reshape(3, rows, LANE)

        return cls.from_planes(to_planes(positions), to_planes(velocities),
                               to_planes(init_colors), n, device=device)

    @classmethod
    def from_planes(cls, pos, vel, init_color, n_active, *,
                    device) -> "ParticleState":
        """Build from ``float32[3, R, 128]`` planes held as numpy arrays —
        the layout of ``particle_sim_tpu.core.state.ParticleState``, so
        ``np.asarray`` of the JAX state's fields carries it across."""
        def plane(a):
            a = np.ascontiguousarray(a, dtype=np.float32)
            if a.ndim != 3 or a.shape[0] != 3 or a.shape[2] != LANE:
                raise ValueError(f"expected float32[3, R, {LANE}], "
                                 f"got {a.shape}")
            return torch.from_numpy(a.copy()).to(device)

        p, v, c = plane(pos), plane(vel), plane(init_color)
        if not p.shape == v.shape == c.shape:
            raise ValueError("pos, vel and init_color shapes differ")
        n = int(n_active)
        if not 0 <= n <= p.shape[1] * LANE:
            raise ValueError(f"n_active {n} outside the capacity")
        return cls(pos=p, vel=v, init_color=c,
                   n_active=torch.tensor(n, dtype=torch.int32, device=device))

    # -- host-side views, sliced to the active count --------------------------
    def _flat(self, plane: torch.Tensor) -> np.ndarray:
        n = int(self.n_active)
        return plane.reshape(3, -1)[:, :n].cpu().numpy().T  # [n, 3]

    def positions(self) -> np.ndarray:
        return self._flat(self.pos)

    def velocities(self) -> np.ndarray:
        return self._flat(self.vel)

    def init_colors_rgba(self) -> np.ndarray:
        rgb = self._flat(self.init_color)
        return np.concatenate(
            [rgb, np.ones((rgb.shape[0], 1), dtype=np.float32)], axis=1)


def grow_state(state: ParticleState, tail_pos, tail_vel, tail_col,
               new_count: int) -> ParticleState:
    """Append newly generated particles after the active ones, keeping
    the existing state. ``tail_*`` are host float32[add, 3] arrays; only
    the tail crosses to the device.

    When the capacity suffices the tail is written into the existing
    planes IN PLACE (a caller holding the old tensors sees the append);
    otherwise the planes are reallocated at the grown capacity.
    """
    add = tail_pos.shape[0]
    new_rows = max(capacity_rows(new_count), state.rows)
    # the tail is padded to a LANE multiple; it may overwrite padding
    # beyond n_old+add, which is harmless (those slots stay inactive)
    n_old = int(state.n_active)
    tail_width = round_up(max(add, 1), LANE)
    if n_old + tail_width > new_rows * LANE:
        # tail padding would run past capacity: bump capacity one row chunk
        new_rows = capacity_rows(n_old + tail_width)
    device = state.device

    def one(plane: torch.Tensor, tail: np.ndarray) -> torch.Tensor:
        buf = np.zeros((3, tail_width), dtype=np.float32)
        buf[:, :add] = np.asarray(tail, dtype=np.float32)[:, :3].T
        flat = plane.reshape(3, -1)
        if new_rows * LANE > flat.shape[1]:
            out = torch.zeros((3, new_rows * LANE), dtype=torch.float32,
                              device=device)
            out[:, : flat.shape[1]] = flat
        else:
            out = flat
        out[:, n_old : n_old + tail_width] = torch.from_numpy(buf).to(device)
        return out.reshape(3, new_rows, LANE)

    return ParticleState(
        pos=one(state.pos, tail_pos), vel=one(state.vel, tail_vel),
        init_color=one(state.init_color, tail_col),
        n_active=torch.tensor(new_count, dtype=torch.int32, device=device))

