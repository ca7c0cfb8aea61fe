"""The plain reference of the exact-core configuration
(``deep_zoom_exact_500k``).

Plain PyTorch, written from the physics the configuration states and
from nothing of the program: it imports neither the program nor JAX,
and takes no window origin, mask or order the program made. It runs on
the device it is given, after the program's state has been freed. From
the multi-level reference (``pmn.py``) it takes the coarse field, the
refinement levels' origins, members and telescoped difference fields
(before their clean), the precisions, the kick and the attractor step;
from the direct-sum reference (``direct.py``) the size of a block of its
pair sums. It adds the exact window of the configuration's ``pmx``:

  * the origin: the mass-weighted centroid of the innermost level's
    members minus half the window, clamped inside that level's window
    less its margin;
  * the members: the live particles in
    [origin + margin, origin + size - margin)^3;
  * the correction, for every member pair (the self term included: it
    is 0),

        da_i = sum_j m_j r_ij [g(r_ij; eps_x) - g(r_ij; eps_prev)],
        g(r; eps) = (r^2 + eps^2)^-1.5,  r_ij = x_j - x_i,

    with eps_x the window's softening and eps_prev the innermost level's,
    over the receivers in blocks of at most ``BLOCK_PAIRS`` pairs;
  * the coarse field, the levels and the correction summed, the
    mass-weighted mean taken out once, times G; then the kick and step.

So a pair with both ends in the window feels the eps_x-softened force
exactly, the mesh's eps_prev-softened share of it taken back out, as
ops/pmx.py's module docstring and the README's pmx row describe.
Departures from that description:

  * members beyond the configuration's ``capacity`` raise: the program
    then corrects only the first ``capacity`` members in its persistent
    mirror's slot order, which no independent reference can know; the
    configuration's capacity holds every member;
  * the members' pairs are summed in identity order, where the program
    sorts them members first into a compact buffer and sums its sources
    in slices (float32 summation order, not the physics);
  * as ``pmn.py``: each level deposits and gathers its members alone;
    tracked windows and the exact gradient only (a static exact window
    raises too); no diagnostics.

``precision`` is "float64" (the reference), "float32" (the witness of
``check.py``'s "vs_f32") or "bfloat16", the control: float32
arithmetic, every state plane, grid and acceleration (the correction
too) rounded to bfloat16.
"""

from __future__ import annotations

import torch

from .direct import BLOCK_PAIRS
from .pmn import PMNReference


class PMXReference(PMNReference):
    def __init__(self, config: dict, device, precision: str = "float64"):
        super().__init__(config, device, precision)
        x = config["pmx"]
        if x["window_min"] is not None:
            raise ValueError("the exact-window reference takes a tracked "
                             "window only")
        if not self.levels:
            raise ValueError("the exact-window reference nests the window "
                             "inside the refinement levels")
        self.exact = (float(x["window_size"]), float(x["softening"]),
                      float(x["margin"]))
        self.capacity = int(x["capacity"])

    def exact_window(self, x: torch.Tensor, m: torch.Tensor,
                     levels: list) -> tuple:
        """(origin [3], members bool[n]) of the exact window, from the
        levels' ``windows``."""
        p_origin, p_members = levels[-1]
        p_size, _, p_margin = self.levels[-1]
        size, _, margin = self.exact
        w = m * p_members.to(self.dtype)
        c = (x * w[None]).sum(1) / torch.clamp_min(w.sum(), 1e-12)
        origin = torch.minimum(torch.maximum(c - 0.5 * size,
                                             p_origin + p_margin),
                               p_origin + (p_size - p_margin - size))
        return origin, self._inside(x, origin, size, margin)

    def correction(self, xs: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
        """[3, k] window correction of the members xs [3, k] with masses
        ms [k], before G."""
        eps_x, eps_prev = self.exact[1], self.levels[-1][1]
        e_x, e_p = eps_x * eps_x, eps_prev * eps_prev
        k = xs.shape[1]
        a = torch.empty_like(xs)
        rows = max(1, BLOCK_PAIRS // max(k, 1))
        for i0 in range(0, k, rows):
            d = xs[:, None, :] - xs[:, i0:i0 + rows, None]   # [3, B, k]
            r2 = (d * d).sum(0, keepdim=True)
            w = ms[None, None, :] * ((r2 + e_x) ** -1.5 - (r2 + e_p) ** -1.5)
            a[:, i0:i0 + rows] = (d * w).sum(2)
        return a

    def accel(self, x: torch.Tensor, m: torch.Tensor):
        """(acceleration [3, n], coarse cell size) of the live particles
        x with masses m."""
        box_min, cell = self._box(x)
        rho = self._deposit(x, m, box_min, cell)
        grids = self._q(self._solve(
            rho, self._kernel_spectra(float(cell), self.softening, False)))
        a = self._gather(grids, x, box_min, cell)
        levels = self.windows(x, m)
        eps_outer = self.softening
        for (size, eps, _), (origin, members) in zip(self.levels, levels):
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
        _, members = self.exact_window(x, m, levels)
        idx = members.nonzero().squeeze(1)
        if idx.numel() > self.capacity:
            raise ValueError(f"{idx.numel()} members of the exact window, "
                             f"over its capacity {self.capacity}")
        if idx.numel():
            a[:, idx] = a[:, idx] + self._q(self.correction(x[:, idx],
                                                            m[idx]))
        a = a - ((a * m[None]).sum(1) / m.sum())[:, None]
        return self._q(a * self.g_const), cell


def make(config: dict, device, precision: str = "float64") -> PMXReference:
    return PMXReference(config, device, precision)
