"""Physics diagnostics: kinetic/potential energy, momentum, extent.

Counterpart of ``particle_sim_tpu/ops/diagnostics.py``: reductions over the
SoA planes on their device; a handful of scalars cross to the host per
call. The potential energy is the direct pairwise sum at small N and the
mesh estimate (one PM 'fd' solve, ops/pm.py, between the deposit and
gather of ops/pm_cuda.py: the kernels on CUDA tensors) at large N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import params as P
from . import pm, pm_cuda

#: Largest live count whose potential is the exact pairwise sum.
DIRECT_MAX_N = 12288
#: Pair elements per receiver chunk of the direct potential.
_CHUNK_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    kinetic: float              # 1/2 sum m |v|^2
    potential: Optional[float]  # softened pairwise potential * G (None: off)
    momentum: tuple             # sum m v (3,)
    mean_radius: float          # mean |x| over live particles
    max_speed: float

    def as_dict(self) -> dict:
        return {
            "kinetic": self.kinetic,
            "potential": self.potential,
            "total_energy": (None if self.potential is None
                             else self.kinetic + self.potential),
            "momentum": list(self.momentum),
            "mean_radius": self.mean_radius,
            "max_speed": self.max_speed,
        }


def _live_weights(n: int, n_active, masses, device):
    live = pm.live_mask(n, n_active, device).to(torch.float32)
    return live, (live if masses is None else live * masses)


def _base_reductions(pos, vel, n_active, masses=None):
    """(kinetic, momentum f32[3], mean_radius, max_speed) as device
    tensors."""
    flat_p = pos.reshape(3, -1)
    flat_v = vel.reshape(3, -1)
    live, m = _live_weights(flat_p.shape[1], n_active, masses, pos.device)
    count = torch.clamp_min(
        torch.as_tensor(n_active, device=pos.device).to(torch.float32), 1.0)
    v2 = (flat_v * flat_v).sum(0)
    kinetic = 0.5 * (v2 * m).sum()
    momentum = (flat_v * m[None]).sum(1)
    radius = torch.sqrt((flat_p * flat_p).sum(0))
    mean_radius = (radius * live).sum() / count
    max_speed = (torch.sqrt(v2) * live).amax()
    return kinetic, momentum, mean_radius, max_speed


def _potential_direct(pos_flat, n_active, g_const, softening, masses=None):
    """Exact softened pairwise potential
    G * sum_{i<j} -m_i m_j / sqrt(r^2 + eps^2), over receiver chunks (the
    JAX version builds the whole N x N tensor)."""
    n = pos_flat.shape[1]
    _, m = _live_weights(n, n_active, masses, pos_flat.device)
    eps_sq = float(softening) * float(softening)
    rows = max(1, _CHUNK_PAIRS // max(n, 1))
    total = torch.zeros((), dtype=torch.float64, device=pos_flat.device)
    for i0 in range(0, n, rows):
        xi = pos_flat[:, i0:i0 + rows]
        diff = pos_flat[:, None, :] - xi[:, :, None]
        r2 = (diff * diff).sum(0) + eps_sq
        w = torch.rsqrt(r2) * m[None, :] * m[i0:i0 + rows, None]
        total = total + w.sum(dtype=torch.float64)
    # the diagonal contributes one m_i^2/eps self-pair per live particle
    total = total - (m.double() * m.double()).sum() / float(softening)
    return -0.5 * g_const * total


def _potential_pm(pos_flat, n_active, g_const, cfg: "P.PMConfig",
                  masses=None):
    """Mesh potential: E = G/2 * sum_i m_i phi(x_i), phi from the spectral
    solve's 'fd' kernel (one forward + one inverse FFT).

    Honours ``cfg.auto_box`` (solve in cell units on the box tracking the
    cloud, eps in cells, rescale by 1/h: phi ~ 1/r)."""
    fd_cfg = dataclasses.replace(cfg, gradient="fd")
    g = fd_cfg.grid
    scale = 1.0
    if fd_cfg.auto_box:
        # coords clamp into the traced box in either boundary mode
        box_min, cell = pm.auto_box(pos_flat, n_active, g)
        periodic = False
        scale = 1.0 / cell
    else:
        box_min, cell = pm_cuda.static_box(tuple(fd_cfg.box_min),
                                           float(fd_cfg.cell_size),
                                           pos_flat.device)
        periodic = fd_cfg.boundary == "periodic"
    rho = pm_cuda.deposit(pos_flat, n_active, box_min, cell, g,
                          periodic=periodic, masses=masses)
    h = 1.0 if fd_cfg.auto_box else fd_cfg.cell_size
    eps = float(fd_cfg.softening)
    (kern,) = pm.base_kernels_device(fd_cfg, eps, h, device=rho.device)
    if fd_cfg.boundary == "isolated":
        rho_p = torch.nn.functional.pad(rho, (0, g, 0, g, 0, g))
        phi = pm._irfftn_octant(torch.fft.rfftn(rho_p) * kern, g)
    else:
        phi = torch.fft.irfftn(torch.fft.rfftn(rho) * kern, s=rho.shape)
    phi_i = pm_cuda.gather(phi.to(torch.float32)[None].contiguous(),
                           pos_flat, n_active, box_min, cell,
                           periodic=periodic)[0]
    _, m = _live_weights(pos_flat.shape[1], n_active, masses,
                         pos_flat.device)
    # subtract each particle's self-energy (the dominant constant term is
    # the kernel's r=0 value spread over the particle's own cells)
    self_phi = -1.0 / eps
    return (0.5 * g_const * scale
            * ((phi_i * m).sum() - self_phi * (m * m).sum()))


def measure(pos, vel, n_active, *, g_const: float = 0.0,
            softening: float = 2.0, pm_cfg: Optional["P.PMConfig"] = None,
            potential: bool = False, masses=None) -> Diagnostics:
    """Diagnostics of (3, R, LANE) planes; host scalars out.

    ``potential=True`` adds the gravitational potential energy: the exact
    pairwise sum when n_active <= DIRECT_MAX_N, the mesh estimate
    otherwise (needs ``pm_cfg``; an estimate for drift tracking, not an
    absolute reference). When neither applies, ``potential`` stays None.
    With an auto-box pm_cfg, ``softening`` and the PM softening are in
    cell units; both paths convert through the current cell size."""
    kinetic, momentum, mean_radius, max_speed = _base_reductions(
        pos, vel, n_active, masses)
    pot = None
    if potential and g_const != 0.0:
        flat = pos.reshape(3, -1)
        n = int(n_active)
        if n <= DIRECT_MAX_N:
            eps = softening
            if pm_cfg is not None and pm_cfg.auto_box:
                # pm softening is in cell units under auto_box
                _, cell = pm.auto_box(flat, n_active, pm_cfg.grid)
                eps = pm_cfg.softening * float(cell)
            k = min(flat.shape[1], -(-max(n, 1) // 1024) * 1024)
            pot = float(_potential_direct(
                flat[:, :k], min(n, k), g_const, eps,
                None if masses is None else masses[:k]))
        elif pm_cfg is not None:
            pot = float(_potential_pm(flat, n_active, g_const, pm_cfg,
                                      masses))
    return Diagnostics(
        kinetic=float(kinetic),
        potential=pot,
        momentum=tuple(momentum.cpu().tolist()),
        mean_radius=float(mean_radius),
        max_speed=float(max_speed),
    )
