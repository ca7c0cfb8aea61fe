"""Particle-mesh (PM) self-gravity — the plain PyTorch version and the
spectral solve.

Counterpart of ``particle_sim_tpu/ops/pm.py``, with the same functions,
names and argument order. PM computes the softened gravity of the direct
sum (ops/pairwise.py) at O(N + G^3 log G): CIC mass deposit onto a G^3
grid, an FFT Poisson solve, CIC gather of the acceleration:

    a(x) = G_const * sum_j m_j K(x - x_j),   K(r) = -r / (|r|^2 + eps^2)^1.5

Two boundary modes:
  * ``isolated`` (default): Hockney-Eastwood zero-padded doubling. K is
    sampled in real space on a (2G)^3 grid and convolved spectrally, so
    the result is the CIC-smoothed direct sum with vacuum boundaries.
  * ``periodic``: the closed-form Plummer kernel in Fourier space
    (phi_hat = -4 pi exp(-|k| eps) / k^2, acceleration through i k) on
    G^3 transforms; forces include the periodic images.

Gradient modes: ``exact`` (three inverse FFTs of the vector kernel) or
``fd`` (one inverse FFT of the potential + 4th-order central differences).

The CIC deposit and gather here (``cic_deposit_ref``, ``cic_gather_ref``)
are the plain versions the CUDA kernels (ops/pm_cuda.py, csrc/pm.cu) are
held to. The FFTs go to ``torch.fft`` (cuFFT on the card): the JAX
package leaves them to XLA outside any kernel, too. The kernel path's
isolated exact-gradient solve (``fused=True``, which ops/pm_cuda.py and
ops/pm2.py's fast callers pass) runs the same transforms on CUDA tensors
through ops/pm_fft.py instead: cuFFT plans and hand-written kernels
(csrc/pm_fft.cu) with no copy between them.

Kernel spectra are computed on the host in numpy (the same code as the
JAX package, so they are bit-identical) and kept on the device as one
stacked complex64[k, ...] tensor an entry, indexed like the tuple of k
spectra, in one least-recently-used cache of at most 8 entries:
the base spectra (``base_kernels_device``; one G = 256 entry is ~1.6 GB)
and the difference spectra g_eps - g_eps_outer of the refinement levels
(``diff_kernels_device``, ops/pm2.py; ~203 MB a level at G = 128).
``solve_accel_diff`` solves with a difference kernel, ``solve_accel_pair``
runs the coarse and one fine solve through one batched set of transforms.
"""

from __future__ import annotations

import collections
import functools
from typing import Tuple

import numpy as np
import torch

from ..core import params as P
from ..utils import trace
from . import physics, pm_fft

#: Corner order of the CIC stencil, (cz, cy, cx), shared with csrc/pm.cu.
_CORNERS = [(cz, cy, cx) for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)]


def clamp_limit(grid: int, periodic: bool) -> float:
    """The largest cell coordinate ``cell_coords_dyn`` lets through, as the
    JAX package computes it (the same numpy expression, so the same
    float32 value): the CIC upper corner (floor + 1) stays on the grid."""
    if periodic:
        return float(np.float32(grid) - 1e-3)
    return float(np.float32(grid - 1) - 1e-3)


def _box_tensor(box_min, device) -> torch.Tensor:
    return torch.as_tensor(box_min, dtype=torch.float32,
                           device=device).reshape(3, 1)


def cell_coords_dyn(pos_flat: torch.Tensor, box_min, cell_size,
                    grid: int, periodic: bool = False) -> torch.Tensor:
    """f32[3, N] continuous cell-space coords.

    Isolated mode clamps so the CIC upper corner (floor+1) stays on the
    grid: coords in [0, G-1-1e-3]. Periodic mode wraps positions into the
    box (coords in [0, G), out-of-box particles re-enter on the far side),
    and the deposit and gather wrap the final cell's upper corner to cell
    0. ``box_min``: f32[3, 1] tensor or a tuple; ``cell_size``: a Python
    float or a 0-d tensor."""
    dev = pos_flat.device
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    c = ((pos_flat - _box_tensor(box_min, dev))
         / torch.as_tensor(cell_size, dtype=torch.float32, device=dev))
    hi = clamp_limit(grid, periodic)
    if periodic:
        return torch.clamp_max(torch.remainder(c, float(grid)), hi)
    return torch.clamp(c, 0.0, hi)


def cell_coords(pos_flat: torch.Tensor, cfg: "P.PMConfig") -> torch.Tensor:
    """cell_coords_dyn with the config's static box."""
    return cell_coords_dyn(pos_flat, cfg.box_min, cfg.cell_size, cfg.grid,
                           periodic=cfg.boundary == "periodic")


def live_mask(n: int, n_active, device) -> torch.Tensor:
    """bool[n]: ``arange(n) < n_active`` (n_active an int or a tensor)."""
    return (torch.arange(n, dtype=torch.int32, device=device)
            < torch.as_tensor(n_active, device=device))


def auto_box(pos_flat: torch.Tensor, n_active, grid: int,
             pad: float = 0.05, coll=None):
    """(box_min f32[3, 1], cell_size 0-d f32) — a cubic box tracking the
    live cloud, computed on the device (nothing is read back). Padding
    particles are excluded from the extent. ``coll``
    (parallel.mesh.Collectives): the extent of every rank's shard (an
    all-reduce MIN and MAX of the local ones)."""
    live = live_mask(pos_flat.shape[1], n_active, pos_flat.device)
    big = 3.0e38
    lo = torch.where(live[None], pos_flat, big).amin(1)
    hi = torch.where(live[None], pos_flat, -big).amax(1)
    if coll is not None:
        lo, hi = coll.min_(lo), coll.max_(hi)
    extent = (hi - lo).amax()
    size = torch.clamp_min(extent * (1.0 + 2.0 * pad), 1e-3)
    center = 0.5 * (lo + hi)
    box_min = (center - 0.5 * size).reshape(3, 1)
    return box_min, size / grid


def cic_weights(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i0 i64[3, N] lower corner, f f32[3, N] fractional offset)."""
    fl = torch.floor(c)
    return fl.long(), c - fl


def _corner(i0, f, g: int, wrap: bool, cz: int, cy: int, cx: int):
    """((wx, wy, wz) f32[N] each, (iz, iy, ix)) of one CIC corner. The
    deposit weighs m * wx * wy * wz and the gather wx * wy * wz, left to
    right (csrc/pm.cu rounds the same products in the same order)."""
    wx = f[0] if cx else 1.0 - f[0]
    wy = f[1] if cy else 1.0 - f[1]
    wz = f[2] if cz else 1.0 - f[2]
    iz, iy, ix = i0[2] + cz, i0[1] + cy, i0[0] + cx
    if wrap:  # the upper corner of the last cell wraps to cell 0
        iz, iy, ix = iz % g, iy % g, ix % g
    return (wx, wy, wz), (iz, iy, ix)


def cic_deposit_ref(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig",
                    coords=None, masses=None) -> torch.Tensor:
    """f32[G, G, G] mass grid — the plain scatter-add.

    ``coords`` overrides the cell coords (auto-box path); ``masses``
    f32[N] overrides the unit masses."""
    g = cfg.grid
    dev = pos_flat.device
    c = cell_coords(pos_flat, cfg) if coords is None else coords
    i0, f = cic_weights(c)
    m = live_mask(pos_flat.shape[1], n_active, dev).to(torch.float32)
    if masses is not None:
        m = m * masses
    wrap = cfg.boundary == "periodic"
    rho = torch.zeros((g, g, g), dtype=torch.float32, device=dev)
    for cz, cy, cx in _CORNERS:
        (wx, wy, wz), idx = _corner(i0, f, g, wrap, cz, cy, cx)
        rho.index_put_(idx, m * wx * wy * wz, accumulate=True)
    return rho


def cic_gather_ref(grids: torch.Tensor, pos_flat: torch.Tensor,
                   cfg: "P.PMConfig", coords=None) -> torch.Tensor:
    """f32[C, N] trilinear interpolation of grids f32[C, G, G, G]."""
    c = cell_coords(pos_flat, cfg) if coords is None else coords
    i0, f = cic_weights(c)
    g = cfg.grid
    wrap = cfg.boundary == "periodic"
    out = torch.zeros((grids.shape[0], pos_flat.shape[1]),
                      dtype=torch.float32, device=pos_flat.device)
    for cz, cy, cx in _CORNERS:
        (wx, wy, wz), (iz, iy, ix) = _corner(i0, f, g, wrap, cz, cy, cx)
        out = out + (wx * wy * wz)[None] * grids[:, iz, iy, ix]
    return out


# ---------------------------------------------------------------------------
# spectral solve
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _isolated_kernels_host(grid: int, h: float, eps: float,
                           gradient: str) -> tuple:
    """rfftn of the real-space kernel on the doubled grid (host, cached).

    Hockney-Eastwood: sample K (or the potential phi for gradient='fd') at
    circularly-wrapped offsets on a (2G)^3 grid; circular convolution with
    the zero-padded mass grid is then the exact linear convolution for
    sources and targets inside the G^3 physical region.
    """
    g2 = 2 * grid
    idx = np.arange(g2)
    d = np.where(idx < grid, idx, idx - g2).astype(np.float32) * h
    dz = d[:, None, None]
    dy = d[None, :, None]
    dx = d[None, None, :]
    r2 = dx * dx + dy * dy + dz * dz + np.float32(eps * eps)
    inv_r3 = r2 ** np.float32(-1.5)
    if gradient == "fd":
        phi = -(r2 ** np.float32(-0.5))
        return (np.fft.rfftn(phi).astype(np.complex64),)
    return tuple(
        np.fft.rfftn(-dc * inv_r3).astype(np.complex64)
        for dc in (dx, dy, dz)
    )


@functools.lru_cache(maxsize=8)
def _isolated_diff_kernels_host(grid: int, h: float, eps: float,
                                eps_outer: float, gradient: str) -> tuple:
    """rfftn of the DIFFERENCE kernel g_eps - g_eps_outer (eps < eps_outer)
    on the doubled grid — the short-range part a coarse mesh softened at
    eps_outer cannot resolve. Decays like r^-4 beyond eps_outer, so its
    support is local to the refinement window (ops/pm2.py)."""
    g2 = 2 * grid
    idx = np.arange(g2)
    d = np.where(idx < grid, idx, idx - g2).astype(np.float32) * h
    dz = d[:, None, None]
    dy = d[None, :, None]
    dx = d[None, None, :]
    r2 = dx * dx + dy * dy + dz * dz
    r2a = r2 + np.float32(eps * eps)
    r2b = r2 + np.float32(eps_outer * eps_outer)
    if gradient == "fd":
        phi = -(r2a ** np.float32(-0.5) - r2b ** np.float32(-0.5))
        return (np.fft.rfftn(phi).astype(np.complex64),)
    k = r2a ** np.float32(-1.5) - r2b ** np.float32(-1.5)
    return tuple(
        np.fft.rfftn(-dc * k).astype(np.complex64)
        for dc in (dx, dy, dz)
    )


@functools.lru_cache(maxsize=8)
def _periodic_kernels_host(grid: int, h: float, eps: float,
                           gradient: str) -> tuple:
    """Closed-form Plummer kernel in Fourier space on the G^3 grid."""
    k1 = 2.0 * np.pi * np.fft.fftfreq(grid, d=h).astype(np.float32)
    kr = 2.0 * np.pi * np.fft.rfftfreq(grid, d=h).astype(np.float32)
    kz = k1[:, None, None]
    ky = k1[None, :, None]
    kx = kr[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    kmag = np.sqrt(k2)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi_hat = np.where(k2 > 0.0, -4.0 * np.pi * np.exp(-kmag * eps) / k2,
                           0.0).astype(np.complex64)
    if gradient == "fd":
        return (phi_hat,)
    return tuple((-1j * kc * phi_hat).astype(np.complex64)
                 for kc in (kx, ky, kz))


#: Device spectra (base and difference), least recently used first; at
#: most DEVICE_CACHE_SIZE.
_DEVICE_KERNELS: "collections.OrderedDict" = collections.OrderedDict()
DEVICE_CACHE_SIZE = 8


def _cached_spectra(key: tuple, device, host_fn) -> torch.Tensor:
    """The complex64 spectra ``host_fn()`` on ``device`` as one stacked
    [k, ...] tensor, from the LRU cache under ``key`` + the device (least
    recently used out)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = key + (str(dev),)
    got = _DEVICE_KERNELS.get(key)
    if got is not None:
        _DEVICE_KERNELS.move_to_end(key)
        return got
    host = host_fn()
    got = torch.empty((len(host),) + host[0].shape, dtype=torch.complex64,
                      device=dev)
    for dst, src in zip(got, host):
        dst.copy_(torch.from_numpy(src))
    _DEVICE_KERNELS[key] = got
    while len(_DEVICE_KERNELS) > DEVICE_CACHE_SIZE:
        _DEVICE_KERNELS.popitem(last=False)
    return got


def base_kernels_device(cfg: "P.PMConfig", softening, cell_size=None, *,
                        device="cpu") -> torch.Tensor:
    """The solve's kernel spectra as one stacked complex64 tensor on
    ``device``, cached (least recently used out, at most DEVICE_CACHE_SIZE entries,
    keyed with the device)."""
    g = cfg.grid
    h = float(cfg.cell_size if cell_size is None else cell_size)
    eps = float(softening)
    grad = cfg.gradient
    if cfg.boundary == "isolated":
        make = functools.partial(_isolated_kernels_host, g, h, eps, grad)
    else:
        make = functools.partial(_periodic_kernels_host, g, h, eps, grad)
    return _cached_spectra((cfg.boundary, g, h, eps, grad), device, make)


def diff_kernels_device(grid: int, h, eps, eps_outer,
                        gradient: str = "exact", *,
                        device="cpu") -> torch.Tensor:
    """The difference spectra (``_isolated_diff_kernels_host``) as one
    stacked complex64 tensor on ``device``, in the same cache as the base
    spectra."""
    args = (grid, float(h), float(eps), float(eps_outer), gradient)
    return _cached_spectra(("diff",) + args, device,
                           functools.partial(_isolated_diff_kernels_host,
                                             *args))


def _irfftn_octant(spec: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse 3D rfft of a (2g, 2g, g+1) half-spectrum, keeping only the
    physical first-octant (g, g, g) output. The inverse is separable, so
    each axis is cut to its needed half as soon as it returns to the
    spatial domain."""
    x = torch.fft.ifft(spec, dim=0)[:g]                    # z spatial
    x = torch.fft.ifft(x, dim=1)[:, :g]                    # y spatial
    return torch.fft.irfft(x, n=2 * g, dim=2)[:, :, :g]    # x spatial (c2r)


def interleaved_view(buf: torch.Tensor) -> torch.Tensor:
    """The f32[3, G, G, G] view of an interleaved f32[G, G, G, 4] buffer
    (x, y, z, pad a cell): the JAX layout by index, while a cell's three
    components lie in one 16-byte word, which the gather kernel
    (ops/pm_cuda.py) loads at once. The pad lane is never read as a
    value."""
    return buf[..., :3].permute(3, 0, 1, 2)


def _interleaved_buffer(g: int, device) -> torch.Tensor:
    return torch.empty((g, g, g, 4), dtype=torch.float32, device=device)


def _irfftn_octant_batch(specs: torch.Tensor, g: int) -> tuple:
    """_irfftn_octant over a leading batch axis of 3k spectra in one set
    of transforms, written into k interleaved buffers (the one copy out
    of the transform's padded output) -> their k f32[3, G, G, G] views."""
    x = torch.fft.ifft(specs, dim=1)[:, :g]
    x = torch.fft.ifft(x, dim=2)[:, :, :g]
    x = torch.fft.irfft(x, n=2 * g, dim=3)[..., :g]
    views = []
    for c in range(0, x.shape[0], 3):
        out = _interleaved_buffer(g, x.device)
        out[..., :3].copy_(x[c:c + 3].permute(1, 2, 3, 0))
        views.append(interleaved_view(out))
    return tuple(views)


def _fd_gradient(phi: torch.Tensor, h: float) -> torch.Tensor:
    """-grad(phi) via 4th-order central differences; the f32[3, G, G, G]
    view of an interleaved buffer (interleaved_view). Differences wrap
    circularly: exact for periodic mode; for isolated mode the wrap
    touches only the outermost two grid layers."""
    def diff(axis):
        p1 = torch.roll(phi, 1, dims=axis)
        m1 = torch.roll(phi, -1, dims=axis)
        p2 = torch.roll(phi, 2, dims=axis)
        m2 = torch.roll(phi, -2, dims=axis)
        return (8.0 * (p1 - m1) - (p2 - m2)) / (12.0 * h)
    out = _interleaved_buffer(phi.shape[0], phi.device)
    for c, axis in enumerate((2, 1, 0)):
        out[..., c] = diff(axis)
    return interleaved_view(out)


def _solve_isolated(rho: torch.Tensor, ks, g: int, gradient: str,
                    h, fused: bool = False) -> torch.Tensor:
    """The Hockney solve of rho with the doubled-grid spectra ``ks``.
    ``fused``: the exact gradient of a CUDA tensor goes through
    ops/pm_fft.py, the same transforms with no copy between them."""
    if fused and rho.is_cuda and gradient == "exact":
        return interleaved_view(pm_fft.solve(rho, ks, g))
    rho_hat = torch.fft.rfftn(torch.nn.functional.pad(rho, (0, g) * 3))
    if gradient == "fd":
        phi = _irfftn_octant(rho_hat * ks[0], g)
        return _fd_gradient(phi.to(torch.float32), h)
    return _irfftn_octant_batch(rho_hat[None] * ks, g)[0]


def solve_accel(rho: torch.Tensor, cfg: "P.PMConfig", softening,
                cell_size=None, kernels=None, *,
                fused: bool = False) -> torch.Tensor:
    """f32[3, G, G, G] acceleration grids (unit G_const) from the mass grid.

    The isolated solves and the 'fd' gradients return the view of an
    interleaved buffer (interleaved_view), written by the copy that ends
    the solve anyway; the periodic 'exact' solve, whose inverse transform
    writes dense planes, returns them as they are.

    ``cell_size`` overrides the config's static h (the auto-box path
    solves in cell units, h = 1). ``kernels``: base_kernels_device()
    spectra; by default they come from its cache on rho's device.
    ``fused`` (the kernel path's callers): the isolated exact-gradient
    solve of a CUDA tensor runs through ops/pm_fft.py; every other solve,
    and every solve without it, keeps the plain torch.fft chain."""
    g = cfg.grid
    h = cfg.cell_size if cell_size is None else cell_size
    if cfg.boundary not in ("isolated", "periodic"):
        raise ValueError(f"unknown boundary mode {cfg.boundary!r}")
    with trace.span("pm.solve", device=rho.is_cuda):
        ks = (base_kernels_device(cfg, softening, h, device=rho.device)
              if kernels is None else kernels)
        if cfg.boundary == "isolated":
            return _solve_isolated(rho, ks, g, cfg.gradient, h, fused)
        rho_hat = torch.fft.rfftn(rho)
        if cfg.gradient == "fd":
            phi = torch.fft.irfftn(rho_hat * ks[0], s=rho.shape)
            return _fd_gradient(phi.to(torch.float32), h)
        specs = rho_hat[None] * ks
        return torch.fft.irfftn(specs, s=rho.shape,
                                dim=(1, 2, 3)).to(torch.float32)


def solve_accel_diff(rho: torch.Tensor, grid: int, h, eps, eps_outer,
                     gradient: str = "exact", kernels=None, *,
                     fused: bool = False) -> torch.Tensor:
    """f32[3, G, G, G] acceleration grids for the short-range difference
    kernel g_eps - g_eps_outer (isolated Hockney; a refinement level of
    ops/pm2.py), in solve_accel's layouts. ``kernels``:
    diff_kernels_device() spectra; by default from its cache on rho's
    device. ``fused`` as in :func:`solve_accel`."""
    ks = (diff_kernels_device(grid, h, eps, eps_outer, gradient,
                              device=rho.device)
          if kernels is None else kernels)
    return _solve_isolated(rho, ks, grid, gradient, float(h), fused)


def solve_accel_pair(rho: torch.Tensor, rho2: torch.Tensor,
                     cfg: "P.PMConfig", softening, kernels2,
                     kernels1=None) -> tuple:
    """(grids, grids2) f32[3, G, G, G] each, interleaved views — the
    isolated exact-gradient coarse solve of ``rho`` and the fine
    difference solve of ``rho2`` (``kernels2`` = pm2.fine_kernels(...))
    batched through one transform set: both share the doubled-grid shape,
    so the forward rfftns batch to 2 and the six inverse components ride
    one _irfftn_octant_batch. ``kernels1``: base_kernels_device()
    spectra (default: from its cache). The caller gates on boundary
    'isolated' and both gradients 'exact'."""
    g = cfg.grid
    ks1 = (base_kernels_device(cfg, softening, device=rho.device)
           if kernels1 is None else kernels1)
    rp = torch.nn.functional.pad(torch.stack([rho, rho2]), (0, g) * 3)
    rhat = torch.fft.rfftn(rp, dim=(1, 2, 3))
    specs = torch.cat([rhat[0][None] * ks1, rhat[1][None] * kernels2])
    return _irfftn_octant_batch(specs, g)


# ---------------------------------------------------------------------------
# full plain pipeline
# ---------------------------------------------------------------------------

def momentum_mean(acc: torch.Tensor, n_active, masses=None, live=None,
                  coll=None) -> torch.Tensor:
    """f32[3]: the live mass-weighted mean of ``acc`` (f32[3, N]),
    ``sum w a / max(sum w, 1e-12)`` with w = live * masses. Arguments as
    in :func:`momentum_clean`; ``live`` may also be float 0/1."""
    if live is None:
        live = live_mask(acc.shape[1], n_active, acc.device)
    w = live.to(torch.float32)
    if masses is not None:
        w = w * masses
    s = (acc * w[None]).sum(dim=1)
    c = w.sum()
    if coll is not None:
        sc = coll.sum_(torch.cat([s, c.reshape(1)]))
        s, c = sc[:3], sc[3]
    return s / torch.clamp_min(c, 1e-12)


def momentum_clean(acc: torch.Tensor, n_active,
                   masses=None, live=None, coll=None) -> torch.Tensor:
    """Subtract the live mass-weighted mean acceleration (zero padding).

    The exact PM self-force sums (mass-weighted) to zero by the
    antisymmetry of the kernel; what survives numerically is solver bias.
    Removing the weighted mean restores conservation: net momentum change
    = sum_i m_i (a_i - mean) = 0 when mean = sum m_i a_i / sum m_i.
    ``live`` (bool[N]) overrides ``arange < n_active``: for slot orders
    other than the identity (ops/pm_persist.py). ``coll``
    (parallel.mesh.Collectives): the mean over every rank's shard (one
    all-reduce of the three weighted sums and the weight). The plain
    paths and the kernel path's public accelerations
    (pm_cuda.clean_and_scale) clean here; every PM step on the kernel
    path takes the mean in one kernel and subtracts it inside the step
    kernel's launch (ops/pm_cuda.py, the PM step's tail)."""
    with trace.span("pm.momentum", device=acc.is_cuda):
        if live is None:
            live = live_mask(acc.shape[1], n_active, acc.device)
        live = live.to(torch.float32)
        mean = momentum_mean(acc, n_active, masses, live=live, coll=coll)
        return (acc - mean[:, None]) * live[None]


def pm_accel_ref(pos_flat: torch.Tensor, n_active, g_const, softening,
                 cfg: "P.PMConfig", masses=None) -> torch.Tensor:
    """f32[3, N] PM acceleration — the plain scatter/gather path (any grid).

    With ``cfg.auto_box`` the box is a cube tracking the cloud and the
    solve runs in cell units (h = 1, eps = softening in cells; the cached
    spectra are box-independent); the physical acceleration is the
    cell-unit result scaled by 1/h^2."""
    if cfg.auto_box:
        box_min, cell = auto_box(pos_flat, n_active, cfg.grid)
        c = cell_coords_dyn(pos_flat, box_min, cell, cfg.grid)
        rho = cic_deposit_ref(pos_flat, n_active, cfg, coords=c,
                              masses=masses)
        grids = solve_accel(rho, cfg, softening, cell_size=1.0)
        acc = cic_gather_ref(grids, pos_flat, cfg, coords=c)
        acc = momentum_clean(acc, n_active, masses)
        return (g_const / (cell * cell)) * acc
    rho = cic_deposit_ref(pos_flat, n_active, cfg, masses=masses)
    grids = solve_accel(rho, cfg, softening)
    acc = momentum_clean(cic_gather_ref(grids, pos_flat, cfg), n_active,
                         masses)
    return g_const * acc


def step_pm_ref(pos: torch.Tensor, vel: torch.Tensor,
                param_vec: torch.Tensor, pair_vec: torch.Tensor, n_active,
                cfg: "P.PMConfig", masses=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame: PM self-gravity + the attractor step, on (3, R, LANE)
    planes. The same integrator contract as ops/pairwise.step_pairwise:
    the acceleration accumulates into velocity first, then p += v*dt, then
    v *= damping. The softening comes from ``cfg``; pair_vec[0] (G_const)
    is read on the device. -> (pos, vel), new tensors."""
    flat = pos.reshape(3, -1)
    acc = pm_accel_ref(flat, n_active, pair_vec[0], cfg.softening, cfg,
                       masses=masses)
    with trace.span("pm.kick", device=pos.is_cuda):
        return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                            param_vec)
