"""The plain reference of the particle-mesh configurations.

Plain PyTorch, written from the physics the configurations state and
from nothing of the program: it imports neither the program nor JAX,
and takes no table, spectrum or weight the program made. It runs on the
device it is given, after the program's state has been freed.

  * the step: the CIC mass deposit of the live particles (masses or 1)
    on a G^3 grid, the isolated Hockney solve on the doubled grid with
    the softened kernel K(r) = -r / (|r|^2 + eps^2)^1.5 sampled in real
    space, the CIC gather, the mass-weighted mean acceleration taken out,
    times G; then ``v += a dt``, the attractor (gravity on y, the mouse
    pull with its quadratic fall-off inside twice its radius), ``p += v
    dt`` before ``v *= damping``. A static box clamps the cell
    coordinates into [0, G - 1 - 1e-3]; the auto box is the cube around
    the live cloud padded by 5 % a side, solved in cell units (eps in
    cells) and scaled by 1 / h^2;
  * the diagnostics: kinetic energy, momentum, and the mesh potential
    (the deposit, the Hockney solve of phi = -1 / sqrt(r^2 + eps^2), the
    gather, each particle's self term -1 / eps taken out);
  * the frame: each live point projected by the camera's view-projection
    matrix (float32, one pixel a point), shaded by colour mode (the
    generation colour held at u8 a channel where the configuration's
    ``display_colour`` says "u8", as the persistent PM keeps it) and by the
    brightness min(2 |v|, 1), summed additively, clamped to 1 and
    quantised to u8 with rounding.

``precision`` is "float64" (the reference), "float32" (the same
arithmetic in the precision the configurations state: the yardstick of
the rounding a float32 program may show, ``check.py``'s "vs_f32"), or
one of the controls: the reference computed a precision below what the
configuration states, "bfloat16" (float32 arithmetic, every state plane,
grid and acceleration rounded to bfloat16) for the state and the
diagnostics, and "float8" for the frame's colours (the frame states
bfloat16 colour words).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

PRECISIONS = ("float64", "float32", "bfloat16", "float8")


class PMReference:
    def __init__(self, config: dict, device, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        pm = config["pm"]
        if pm["boundary"] != "isolated" or pm["gradient"] != "exact":
            raise ValueError("the reference solves the isolated exact-"
                             "gradient mesh only")
        self.grid = int(pm["grid"])
        self.box_min = tuple(float(v) for v in pm["box_min"])
        self.box_size = float(pm["box_size"])
        self.softening = float(pm["softening"])
        self.auto_box = bool(pm["auto_box"])
        self.g_const = float(config["g_const"])
        self.display_u8 = config.get("display_colour") == "u8"
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self._spectra = {}

    # -- precision -----------------------------------------------------------
    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """A state, grid or acceleration as the precision stores it."""
        if self.precision == "bfloat16":
            return t.to(torch.bfloat16).to(torch.float32)
        return t

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return self._q(t.to(self.device, self.dtype))

    # -- the mesh --------------------------------------------------------------
    def _box(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(box_min [3], cell size 0-d) of the solve."""
        if self.auto_box:
            lo, hi = x.amin(1), x.amax(1)
            size = torch.clamp_min((hi - lo).amax() * 1.1, 1e-3)
            return 0.5 * (lo + hi) - 0.5 * size, size / self.grid
        box = torch.tensor(self.box_min, dtype=self.dtype, device=self.device)
        return box, torch.tensor(self.box_size / self.grid, dtype=self.dtype,
                                 device=self.device)

    def _corners(self, x: torch.Tensor, box_min, cell):
        """The eight CIC corners: (flat cell index, weight) pairs."""
        g = self.grid
        c = torch.clamp((x - box_min[:, None]) / cell, 0.0, g - 1 - 1e-3)
        i0 = torch.floor(c)
        f = c - i0
        i0 = i0.long()
        for cz in (0, 1):
            for cy in (0, 1):
                for cx in (0, 1):
                    w = ((f[0] if cx else 1.0 - f[0])
                         * (f[1] if cy else 1.0 - f[1])
                         * (f[2] if cz else 1.0 - f[2]))
                    idx = ((i0[2] + cz) * g + (i0[1] + cy)) * g + (i0[0] + cx)
                    yield idx, w

    def _deposit(self, x, m, box_min, cell) -> torch.Tensor:
        rho = torch.zeros(self.grid ** 3, dtype=self.dtype, device=self.device)
        for idx, w in self._corners(x, box_min, cell):
            rho.index_add_(0, idx, m * w)
        return self._q(rho)

    def _gather(self, grids: torch.Tensor, x, box_min, cell) -> torch.Tensor:
        flat = grids.reshape(grids.shape[0], -1)
        out = torch.zeros((grids.shape[0], x.shape[1]), dtype=self.dtype,
                          device=self.device)
        for idx, w in self._corners(x, box_min, cell):
            out += w[None] * flat[:, idx]
        return self._q(out)

    def _kernel_spectra(self, h: float, eps: float, potential: bool) -> list:
        """rfftn of the real-space kernel on the doubled grid: the three
        components of K, or the potential -1/sqrt(r^2 + eps^2)."""
        key = (h, eps, potential)
        if key not in self._spectra:
            g = self.grid
            idx = torch.arange(2 * g, dtype=torch.float64, device=self.device)
            d = torch.where(idx < g, idx, idx - 2 * g) * h
            dz, dy, dx = d[:, None, None], d[None, :, None], d[None, None, :]
            r2 = dx * dx + dy * dy + dz * dz + eps * eps
            if potential:
                real = [-(r2 ** -0.5)]
            else:
                inv_r3 = r2 ** -1.5
                real = [-dc * inv_r3 for dc in (dx, dy, dz)]
            cdt = (torch.complex128 if self.dtype == torch.float64
                   else torch.complex64)
            self._spectra[key] = [torch.fft.rfftn(k).to(cdt) for k in real]
        return self._spectra[key]

    def _solve(self, rho: torch.Tensor, spectra: list) -> torch.Tensor:
        g = self.grid
        rho_hat = torch.fft.rfftn(
            torch.nn.functional.pad(rho.view(g, g, g), (0, g) * 3))
        return torch.stack([
            torch.fft.irfftn(rho_hat * k, s=(2 * g,) * 3)[:g, :g, :g]
            for k in spectra])

    def _mesh_scale(self, cell) -> Tuple[float, float]:
        """(h of the solve, eps of the solve): cell units under the auto
        box, the world's otherwise."""
        if self.auto_box:
            return 1.0, self.softening
        return float(cell), self.softening

    def accel(self, x: torch.Tensor, m: torch.Tensor):
        """(acceleration [3, n], cell size) of the live particles x."""
        box_min, cell = self._box(x)
        h, eps = self._mesh_scale(cell)
        rho = self._deposit(x, m, box_min, cell)
        grids = self._q(self._solve(rho, self._kernel_spectra(h, eps, False)))
        a = self._gather(grids, x, box_min, cell)
        a = a - ((a * m[None]).sum(1) / m.sum())[:, None]
        scale = self.g_const / (cell * cell) if self.auto_box else self.g_const
        return self._q(a * scale), cell

    # -- the step ----------------------------------------------------------------
    def steps(self, pos: torch.Tensor, vel: torch.Tensor,
              masses: Optional[torch.Tensor], params: dict, k: int):
        """``k`` steps of the live particles (f32[3, n] each) ->
        (pos, vel, cell size of the last solve)."""
        x, v = self._cast(pos), self._cast(vel)
        n = x.shape[1]
        m = (torch.ones(n, dtype=self.dtype, device=self.device)
             if masses is None else self._cast(masses[:n]))
        dt = params["delta_time"]
        mouse = torch.tensor(params["mouse_position"], dtype=self.dtype,
                             device=self.device)[:, None]
        reach = 2.0 * params["mouse_radius"]
        drag = 1.0 if params["is_mouse_dragging"] else 0.0
        cell = None
        for _ in range(k):
            a, cell = self.accel(x, m)
            v = v + a * dt
            v[1] = v[1] - params["gravity"] * dt
            d = mouse - x
            dist_sq = torch.clamp_min((d * d).sum(0), 1e-24)
            dist = torch.sqrt(dist_sq)
            t = 1.0 - dist / reach
            within = (dist_sq < reach * reach).to(self.dtype) * drag
            v = v + d * (within * (params["mouse_force"] * 2.0 * dt)
                         * t * t / dist)[None]
            x = self._q(x + v * dt)
            v = self._q(v * params["damping"])
        return x, v, float(cell)

    # -- the diagnostics ---------------------------------------------------------
    def diagnostics(self, pos, vel, masses) -> dict:
        """kinetic, potential (mesh), momentum [3] and the sum of m |v|
        (the momentum's scale) of the live particles."""
        x, v = self._cast(pos), self._cast(vel)
        n = x.shape[1]
        m = (torch.ones(n, dtype=self.dtype, device=self.device)
             if masses is None else self._cast(masses[:n]))
        speed = torch.sqrt((v * v).sum(0))
        box_min, cell = self._box(x)
        h, eps = self._mesh_scale(cell)
        rho = self._deposit(x, m, box_min, cell)
        phi = self._q(self._solve(rho, self._kernel_spectra(h, eps, True)))
        phi_i = self._gather(phi, x, box_min, cell)[0]
        scale = 1.0 / cell if self.auto_box else 1.0
        potential = (0.5 * self.g_const * scale
                     * ((phi_i * m).sum() + (m * m).sum() / eps))
        return {
            "kinetic": float(self._q(0.5 * (speed * speed * m).sum())),
            "potential": float(potential),
            "momentum": self._q((v * m[None]).sum(1)).tolist(),
            "momentum_scale": float((speed * m).sum()),
        }

    # -- the frame --------------------------------------------------------------
    @staticmethod
    def _norm(x, y, z) -> torch.Tensor:
        return torch.sqrt((x * x + y * y + z * z).double()).float()

    def _shade(self, x, v, col, params) -> torch.Tensor:
        """f32[3, n]: the colour of each point by colour mode, times its
        brightness."""
        mode = int(params["color_mode"])
        if mode == 1:
            s = torch.clamp(self._norm(*v) * 0.2, 0.0, 1.0)
            rgb = torch.stack([s, 0.5 - s * 0.5, 1.0 - s])
        elif mode == 2:
            dmax = max(float(params["max_dist_for_color"]), 0.01)
            d = torch.clamp(self._norm(*x) / dmax, 0.0, 1.0)
            rgb = torch.stack([d, torch.zeros_like(d), 1.0 - d])
        else:
            rgb = col
        return rgb * torch.clamp_max(self._norm(*v) * 2.0, 1.0)[None]

    @staticmethod
    def quantised_colour(col: torch.Tensor) -> torch.Tensor:
        """The generation colour held at u8 a channel, as the persistent
        PM's frames show it."""
        c8 = (torch.clamp(col, 0.0, 1.0) * 255.0 + 0.5).to(torch.int32)
        return c8.to(torch.float32) / 255.0

    def frame(self, pos, vel, col, params: dict, view_proj,
              width: int, height: int) -> torch.Tensor:
        """u8[height, width, 4] frame of the live points (f32[3, n])."""
        x = pos.to(self.device, torch.float32)
        v = vel.to(self.device, torch.float32)
        vp = torch.as_tensor(view_proj, dtype=torch.float32,
                             device=self.device)
        clip = [vp[r, 0] * x[0] + vp[r, 1] * x[1] + vp[r, 2] * x[2] + vp[r, 3]
                for r in range(4)]
        w_ok = clip[3] > 1e-8
        inv_w = torch.where(w_ok, 1.0 / torch.clamp_min(clip[3], 1e-8), 0.0)
        ndc = [c * inv_w for c in clip[:3]]
        valid = (w_ok & (ndc[0].abs() <= 1.0) & (ndc[1].abs() <= 1.0)
                 & (ndc[2] >= 0.0) & (ndc[2] <= 1.0))
        fx = torch.clamp((ndc[0] + 1.0) * 0.5 * width, -1.0, float(width))
        fy = torch.clamp((1.0 - ndc[1]) * 0.5 * height, -1.0, float(height))
        px = torch.clamp(fx.to(torch.int32), 0, width - 1).long()
        py = torch.clamp(fy.to(torch.int32), 0, height - 1).long()
        col = col.to(self.device, torch.float32)
        if self.display_u8:
            col = self.quantised_colour(col)
        rgb = self._shade(x, v, col, params)
        if self.precision == "float8":
            rgb = rgb.to(torch.float8_e4m3fn).to(torch.float32)
        rgb = rgb * valid.to(torch.float32)[None]
        fb = torch.zeros((height * width, 3), dtype=torch.float64,
                         device=self.device)
        fb.index_add_(0, py * width + px, rgb.T.double())
        fb = torch.clamp(fb.float(), 0.0, 1.0).view(height, width, 3)
        rgb8 = (fb * 255.0 + 0.5).to(torch.uint8)
        alpha = torch.full((height, width, 1), 255, dtype=torch.uint8,
                           device=self.device)
        return torch.cat([rgb8, alpha], dim=-1)


def make(config: dict, device, precision: str = "float64") -> PMReference:
    return PMReference(config, device, precision)

