"""The plain reference of the multi-level configuration (``deep_zoom_16m``).

Plain PyTorch, written from the physics the configuration states and
from nothing of the program: it imports neither the program nor JAX,
and takes no spectrum, table or window origin the program made. It runs
on the device it is given, after the program's state has been freed.
From the particle-mesh reference (``pm.py``) it takes the precisions,
the CIC deposit and gather, the isolated Hockney solve, the kick and the
attractor step (``PMReference.steps``), and adds the refinement levels
of the configuration's ``pm2`` list, outermost first:

  * the coarse field: ``pm.py``'s deposit, solve with K_eps0 (eps0 the
    coarse softening) and gather, not yet cleaned;
  * for level k: the tracked origin, the mass-weighted centroid of the
    parent level's members (level 1's parent: every live particle) minus
    half the window, clamped inside the parent window less its margin
    (level 1 is not clamped: its parent is the whole mesh); the members,
    the live particles in [origin + margin, origin + size - margin)^3;
    their CIC deposit on a G^3 grid of cell size / G from the origin; the
    isolated Hockney solve of the difference kernel
    K_eps_k(r) - K_eps_{k-1}(r), K_eps(r) = -r / (|r|^2 + eps^2)^1.5,
    sampled in real space on the doubled grid; the CIC gather, to the
    members only;
  * the sum of the coarse field and the levels, the mass-weighted mean
    taken out, times G; then ``pm.py``'s kick and step.

So a pair with both ends in window k feels the eps_k-softened force (the
differences telescope), as ops/pm2.py's module docstring and the README's
multi-level row describe. Departures from that description:

  * each level deposits and gathers its members alone (gathered out of
    the state and added back), where the program masks a pass over every
    slot: the same sums, since a non-member deposits nothing and receives
    nothing;
  * the particles are in identity order: the program's persistent class
    order only places them (it changes float32 summation order, not the
    physics);
  * tracked windows and the exact gradient only (the configuration has
    no other); static windows, 'fd' levels and the auto box raise;
  * no window-exact correction (pmx) and no diagnostics: the
    configuration's command and its cell take neither.

``precision`` is "float64" (the reference), "float32" (the witness of
``check.py``'s "vs_f32") or "bfloat16", the control: float32
arithmetic, every state plane, grid and acceleration rounded to
bfloat16.
"""

from __future__ import annotations

import torch

from .pm import PMReference


class PMNReference(PMReference):
    def __init__(self, config: dict, device, precision: str = "float64"):
        super().__init__(config, device, precision)
        if self.auto_box:
            raise ValueError("the multi-level reference needs a static "
                             "coarse box")
        self.levels = []
        for lv in config["pm2"]:
            if lv["window_min"] is not None or lv["gradient"] != "exact":
                raise ValueError("the multi-level reference takes tracked "
                                 "windows with the exact gradient only")
            self.levels.append((float(lv["window_size"]),
                                float(lv["softening"]), float(lv["margin"])))

    def _diff_spectra(self, h: float, eps: float, eps_outer: float) -> list:
        """rfftn of the three components of K_eps - K_eps_outer sampled on
        the doubled grid of spacing h."""
        key = ("diff", h, eps, eps_outer)
        if key not in self._spectra:
            g = self.grid
            idx = torch.arange(2 * g, dtype=torch.float64, device=self.device)
            d = torch.where(idx < g, idx, idx - 2 * g) * h
            dz, dy, dx = d[:, None, None], d[None, :, None], d[None, None, :]
            r2 = dx * dx + dy * dy + dz * dz
            k = (r2 + eps * eps) ** -1.5 - (r2 + eps_outer * eps_outer) ** -1.5
            cdt = (torch.complex128 if self.dtype == torch.float64
                   else torch.complex64)
            self._spectra[key] = [torch.fft.rfftn(-dc * k).to(cdt)
                                  for dc in (dx, dy, dz)]
        return self._spectra[key]

    @staticmethod
    def _inside(x: torch.Tensor, lo: torch.Tensor, size: float,
                margin: float) -> torch.Tensor:
        lo = lo[:, None] + margin
        return ((x >= lo) & (x < lo + (size - 2.0 * margin))).all(0)

    def windows(self, x: torch.Tensor, m: torch.Tensor) -> list:
        """[(origin [3], members bool[n])] of each level, outermost
        first."""
        out, members, parent = [], None, None
        for size, _, margin in self.levels:
            w = m if members is None else m * members.to(self.dtype)
            c = (x * w[None]).sum(1) / torch.clamp_min(w.sum(), 1e-12)
            origin = c - 0.5 * size
            if parent is not None:
                p_origin, p_size, p_margin = parent
                origin = torch.minimum(
                    torch.maximum(origin, p_origin + p_margin),
                    p_origin + (p_size - p_margin - size))
            members = self._inside(x, origin, size, margin)
            out.append((origin, members))
            parent = (origin, size, margin)
        return out

    def accel(self, x: torch.Tensor, m: torch.Tensor):
        """(acceleration [3, n], coarse cell size) of the live particles
        x with masses m."""
        box_min, cell = self._box(x)
        rho = self._deposit(x, m, box_min, cell)
        grids = self._q(self._solve(
            rho, self._kernel_spectra(float(cell), self.softening, False)))
        a = self._gather(grids, x, box_min, cell)
        eps_outer = self.softening
        for (size, eps, _), (origin, members) in zip(self.levels,
                                                     self.windows(x, m)):
            idx = members.nonzero().squeeze(1)
            if idx.numel():
                xs = x[:, idx]
                h2 = size / self.grid
                cell2 = torch.tensor(h2, dtype=self.dtype, device=self.device)
                rho2 = self._deposit(xs, m[idx], origin, cell2)
                grids2 = self._q(self._solve(
                    rho2, self._diff_spectra(h2, eps, eps_outer)))
                a[:, idx] = a[:, idx] + self._gather(grids2, xs, origin,
                                                     cell2)
            eps_outer = eps
        a = a - ((a * m[None]).sum(1) / m.sum())[:, None]
        return self._q(a * self.g_const), cell

    def diagnostics(self, pos, vel, masses) -> dict:
        raise ValueError("the multi-level reference takes no diagnostics")


def make(config: dict, device, precision: str = "float64") -> PMNReference:
    return PMNReference(config, device, precision)
