"""Particle-mesh gravity on the hand-written CUDA kernels (csrc/pm.cu).

Counterpart of ``particle_sim_tpu/ops/pm_pallas.py``: ``pm_accel`` and
``step_pm``, with the deposit and gather kernels behind :func:`deposit`
and :func:`gather`. The TPU path sorts particles by cell for its one-hot
matmul kernels and un-sorts the accelerations; here both kernels take the
particles in their own order (one thread each, float atomics for the
deposit), so there is no sort, no tiling by grid and any grid size works.
The deposit sums the corner weights of particles that share a cell before
its atomics (``cell_sorted``: the design for the persistent state's
cell-sorted slots); the gather reads the acceleration grids in the
interleaved layout that ``pm.solve_accel`` writes (:func:`grid_layout`);
csrc/pm.cu says why.

Each wrapper takes its plain version (:func:`deposit_plain`,
:func:`gather_plain`, wrapping ``pm.cic_deposit_ref`` /
``pm.cic_gather_ref``) for CPU tensors only; on CUDA tensors it launches
its kernel or raises. ``box_min`` and ``cell`` may be tensors on the
device (the auto-box path computes them there), so no step reads anything
back to the host.

Two intended differences from the TPU kernels, both toward the plain
version: the CIC weights are float32 (no bf16 one-hots, no 10-bit
fractions), and periodic mode wraps the last cell's upper corner to cell
0 as the plain version does (the sorted TPU path clamps into the last
cell). A non-finite acceleration grid comes out non-finite per component
at the particles that read it (the TPU's un-sort pack poisons all three
components of such a particle together).

:func:`step_pm` (through :func:`step_pm_planes`) updates ``pos`` and
``vel`` IN PLACE: the deposit and the solve (``pm.solve_accel(fused=True)``:
the isolated exact-gradient solve through ops/pm_fft.py, the plain path
keeps ``torch.fft``), then the tail. With one interleaved grid on CUDA
(the per-frame PM and the single-level persistent step) the tail is two
launches that never write the raw field: :func:`grid_momentum_mean`
(csrc/momentum.cu's grid instance: the mean from rho and the grids) and
:func:`gather_kick_and_step` (csrc/pm.cu's kicked gather). Every other PM
step on the kernel path (pm2, pmx, the mesh) gathers the raw acceleration
(:func:`accel_raw`) and finishes in :func:`momentum_mean` (the live
mass-weighted mean of the field) and :func:`clean_kick_and_step`
(csrc/step.cu's kicked form: the clean, the scale G or G / h^2, ``vel +=
acc * dt`` and the attractor step). The public accelerations end in
:func:`clean_and_scale` instead: on CPU tensors the same bits for a given
raw field.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..core import params as P
from ..utils import cuda_build, trace
from . import pm, step_cuda

#: Kernel launches in this process: the deposit with unit masses, the
#: deposit with masses, the deposit of cell-sorted input (``cell_sorted``;
#: the two counts before it count these too), the gather, the momentum
#: sums (csrc/momentum.cu, from a field or from the grids), the fused PM
#: kick (the step kernel's kicked form with the momentum clean,
#: :func:`clean_kick_and_step`, which step_cuda.LAUNCHES counts too, or
#: the gather's kicked instance), and the gather's kicked instance
#: (:func:`gather_kick_and_step`; GATHER_LAUNCHES and KICK_FUSED_LAUNCHES
#: count it too).
DEPOSIT_LAUNCHES = 0
DEPOSIT_MASS_LAUNCHES = 0
DEPOSIT_SORTED_LAUNCHES = 0
GATHER_LAUNCHES = 0
MOMENTUM_LAUNCHES = 0
KICK_FUSED_LAUNCHES = 0
KICK_GATHER_LAUNCHES = 0

#: Blocks of the momentum sums kernel at most (8 of 256 threads on each
#: of the H100's 132 SMs): with N they fix the order of its sums.
MOMENTUM_MAX_BLOCKS = 132 * 8


def _check(pos: torch.Tensor, masses, live, name: str = "pos") -> None:
    if not isinstance(pos, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if pos.dtype != torch.float32 or pos.ndim != 2 or pos.shape[0] != 3:
        raise ValueError(f"{name} must be float32[3, N], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    n = pos.shape[1]
    for name, t, dtype in (("masses", masses, torch.float32),
                           ("live", live, torch.bool)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != pos.device or t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name} must be {dtype}[{n}] on {pos.device}, "
                             f"got {t.dtype}{list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _plain_cfg(grid: int, periodic: bool) -> "P.PMConfig":
    return P.PMConfig(grid=grid,
                      boundary="periodic" if periodic else "isolated")


def _device_args(pos, n_active, box_min, cell):
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if pos.shape[1] * 3 >= 2 ** 31:
        raise ValueError(f"{pos.shape[1]} particles: too many for int32 "
                         "indexing")
    na = torch.as_tensor(n_active, dtype=torch.int32, device=dev).reshape(1)
    bmin = torch.as_tensor(box_min, dtype=torch.float32,
                           device=dev).reshape(3).contiguous()
    cell_t = torch.as_tensor(cell, dtype=torch.float32, device=dev).reshape(1)
    return na, bmin, cell_t


@functools.lru_cache(maxsize=64)
def device_const(values, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A constant tensor (``values``: a number or a tuple) on ``device``,
    made once: an upload from pageable host memory on every call would
    wait for the steps queued before it. Callers must not write into
    it."""
    return torch.tensor(values, dtype=dtype, device=device)


def static_box(box_min: tuple, cell: float, device: torch.device) -> tuple:
    """(box_min f32[3], cell f32[1]) of a static box on ``device``
    (device_const)."""
    return device_const(tuple(box_min), device), device_const((cell,), device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- deposit --------------------------------------------------------------------
def deposit_plain(pos, n_active, box_min, cell, grid: int, *, periodic: bool,
                  masses=None, live=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`deposit` (pm.cic_deposit_ref)."""
    coords = pm.cell_coords_dyn(pos, box_min, cell, grid, periodic)
    cfg = _plain_cfg(grid, periodic)
    if live is not None:
        m = live.to(torch.float32)
        if masses is not None:
            m = m * masses
        return pm.cic_deposit_ref(pos, pos.shape[1], cfg, coords=coords,
                                  masses=m)
    return pm.cic_deposit_ref(pos, n_active, cfg, coords=coords,
                              masses=masses)


def deposit(pos: torch.Tensor, n_active, box_min, cell, grid: int, *,
            periodic: bool, masses=None, live=None,
            cell_sorted: bool = False) -> torch.Tensor:
    """f32[G, G, G] CIC mass grid of the particles ``pos`` (f32[3, N]).

    Particles with index < ``n_active`` deposit (``live``, bool[N],
    overrides that: for slot orders other than the identity), with mass
    ``masses`` (f32[N]) or 1. ``box_min`` (3 values) and ``cell`` (the
    cell size) may be tuples, floats or device tensors. ``periodic``
    wraps coordinates and the last cell's upper corner (pm.cell_coords_dyn);
    otherwise they clamp into the grid. ``cell_sorted``: the caller keeps
    the particles in the order of this deposit's own lower cells
    (ops/pm_persist.py), so the kernel for that input launches
    (``psim_pm_deposit_sorted``, counted by ``pm.deposit.sorted``); the
    same sums for any order, to float32 summation order. CPU tensors take
    the plain version either way."""
    global DEPOSIT_LAUNCHES, DEPOSIT_MASS_LAUNCHES, DEPOSIT_SORTED_LAUNCHES
    _check(pos, masses, live)
    if grid ** 3 >= 2 ** 31:
        raise ValueError(f"grid {grid}: too large for int32 cell indices")
    if pos.device.type == "cpu":
        return deposit_plain(pos, n_active, box_min, cell, grid,
                             periodic=periodic, masses=masses, live=live)
    na, bmin, cell_t = _device_args(pos, n_active, box_min, cell)
    rho = torch.zeros((grid, grid, grid), dtype=torch.float32,
                      device=pos.device)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    launch = lib.psim_pm_deposit_sorted if cell_sorted else lib.psim_pm_deposit
    with torch.cuda.device(pos.device):
        err = launch(
            pos.data_ptr(), pos.shape[1], na.data_ptr(), _ptr(live),
            _ptr(masses), bmin.data_ptr(), cell_t.data_ptr(), grid,
            pm.clamp_limit(grid, periodic), int(periodic), rho.data_ptr(),
            stream)
    if masses is None:
        DEPOSIT_LAUNCHES += 1
    else:
        DEPOSIT_MASS_LAUNCHES += 1
    if cell_sorted:
        DEPOSIT_SORTED_LAUNCHES += 1
        trace.count("pm.deposit.sorted")
    cuda_build.check(err, "pm deposit")
    return rho


# -- gather ----------------------------------------------------------------------
def grid_layout(grids: torch.Tensor, pos: torch.Tensor) -> str:
    """"planar" for a contiguous f32[C, G, G, G] (C = 1 or 3), or
    "interleaved" for the f32[3, G, G, G] view of an f32[G, G, G, 4]
    buffer (pm.interleaved_view, what pm.solve_accel returns for most
    modes: one 16-byte load a corner in the kernel). Anything else
    raises ValueError."""
    if (not isinstance(grids, torch.Tensor) or grids.dtype != torch.float32
            or grids.ndim != 4 or grids.shape[0] not in (1, 3)
            or not grids.shape[1] == grids.shape[2] == grids.shape[3]):
        raise ValueError("grids must be float32[C, G, G, G], C = 1 or 3")
    if grids.device != pos.device:
        raise ValueError(f"grids must be on {pos.device}")
    if grids.is_contiguous():
        return "planar"
    g = grids.shape[1]
    if (grids.shape[0] == 3 and grids.stride() == (1, 4 * g * g, 4 * g, 4)
            and grids.data_ptr() % 16 == 0
            and grids.untyped_storage().nbytes()
            >= grids.storage_offset() * 4 + 16 * g ** 3):
        return "interleaved"
    raise ValueError("grids must be a contiguous float32[C, G, G, G] or "
                     "the f32[3, G, G, G] view of an f32[G, G, G, 4] "
                     f"buffer (pm.interleaved_view); got strides "
                     f"{grids.stride()}")


def gather_plain(grids, pos, n_active, box_min, cell, *, periodic: bool,
                 live=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather` (pm.cic_gather_ref, dead
    particles set to 0)."""
    g = grids.shape[1]
    coords = pm.cell_coords_dyn(pos, box_min, cell, g, periodic)
    acc = pm.cic_gather_ref(grids, pos, _plain_cfg(g, periodic),
                            coords=coords)
    if live is None:
        live = pm.live_mask(pos.shape[1], n_active, pos.device)
    return torch.where(live[None], acc, 0.0)


def gather(grids: torch.Tensor, pos: torch.Tensor, n_active, box_min, cell,
           *, periodic: bool, live=None) -> torch.Tensor:
    """f32[C, N] trilinear (CIC) interpolation of the grids f32[C, G, G, G]
    (C = 3 acceleration components, or 1: a potential) at the particles,
    in their original order; dead particles get exactly 0. The grids are
    planar or interleaved (:func:`grid_layout`). Arguments as in
    :func:`deposit`."""
    global GATHER_LAUNCHES
    layout = grid_layout(grids, pos)
    g = grids.shape[1]
    _check(pos, None, live)
    if pos.device.type == "cpu":
        return gather_plain(grids, pos, n_active, box_min, cell,
                            periodic=periodic, live=live)
    na, bmin, cell_t = _device_args(pos, n_active, box_min, cell)
    out = torch.empty((grids.shape[0], pos.shape[1]), dtype=torch.float32,
                      device=pos.device)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    with torch.cuda.device(pos.device):
        err = lib.psim_pm_gather(
            grids.data_ptr(), grids.shape[0], int(layout == "interleaved"),
            pos.data_ptr(), pos.shape[1], na.data_ptr(),
            _ptr(live), bmin.data_ptr(), cell_t.data_ptr(), g,
            pm.clamp_limit(g, periodic), int(periodic), out.data_ptr(),
            stream)
    GATHER_LAUNCHES += 1
    cuda_build.check(err, "pm gather")
    return out


# -- the momentum clean ---------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _momentum_workspace(device: torch.device, stream: int) -> tuple:
    """(partials f64[4 * MOMENTUM_MAX_BLOCKS], counter int32[1]) of the
    sums kernel on one stream: the counter is 0 between launches (the
    kernel's last block sets it back), so the launches queued on one
    stream share it; another stream gets its own."""
    return (torch.empty(4 * MOMENTUM_MAX_BLOCKS, dtype=torch.float64,
                        device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def momentum_mean(acc: torch.Tensor, n_active, *, masses=None, live=None,
                  coll=None) -> torch.Tensor:
    """f32[3] live mass-weighted mean of ``acc`` (f32[3, N]): on CUDA one
    launch of the sums kernel, float64 sums in an order fixed by N (two
    calls give the same bits); pm.momentum_mean on CPU tensors. ``live``
    (bool[N]) overrides ``arange < n_active``. ``coll``: the kernel's
    float32 sums and weight are all-reduced, then divided as
    pm.momentum_mean divides."""
    global MOMENTUM_LAUNCHES
    _check(acc, masses, live, name="acc")
    with trace.span("pm.momentum", device=acc.is_cuda):
        if acc.device.type == "cpu":
            return pm.momentum_mean(acc, n_active, masses, live=live,
                                    coll=coll)
        dev = acc.device
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        na = None if live is not None else torch.as_tensor(
            n_active, dtype=torch.int32, device=dev).reshape(1)
        out = torch.empty(8, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials, counter = _momentum_workspace(dev, stream)
        with torch.cuda.device(dev):
            err = cuda_build.library().psim_momentum_sums(
                acc.data_ptr(), acc.shape[1], _ptr(live), _ptr(na),
                _ptr(masses), partials.data_ptr(), counter.data_ptr(),
                MOMENTUM_MAX_BLOCKS, out.data_ptr(), stream)
        MOMENTUM_LAUNCHES += 1
        cuda_build.check(err, "momentum sums")
        if coll is None:
            return out[4:7]
        sums = coll.sum_(out[:4])
        return sums[:3] / torch.clamp_min(sums[3], 1e-12)


def _check_grid_pair(rho: torch.Tensor, grids: torch.Tensor) -> None:
    """rho f32[G, G, G] contiguous and ``grids`` the interleaved
    f32[3, G, G, G] view solved from it (:func:`grid_layout`), on one
    device; else ValueError."""
    if not isinstance(rho, torch.Tensor) or not isinstance(grids,
                                                           torch.Tensor):
        raise TypeError("rho and grids must be torch.Tensors")
    if grid_layout(grids, rho) != "interleaved":
        raise ValueError("grids must be the interleaved f32[3, G, G, G] "
                         "view (pm.interleaved_view), not dense planes")
    g = grids.shape[1]
    if (rho.dtype != torch.float32 or tuple(rho.shape) != (g, g, g)
            or not rho.is_contiguous()):
        raise ValueError(f"rho must be a contiguous float32[{g}, {g}, {g}], "
                         f"got {rho.dtype}{list(rho.shape)}")


def grid_momentum_mean_plain(rho: torch.Tensor,
                             grids: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`grid_momentum_mean`: the float64 sums
    sum rho a and sum rho, each rounded to float32, then the mean as
    pm.momentum_mean forms it."""
    w = rho.double().reshape(-1)
    s = (grids.double().reshape(3, -1) * w[None]).sum(dim=1).float()
    return s / torch.clamp_min(w.sum().float(), 1e-12)


def grid_momentum_mean(rho: torch.Tensor,
                       grids: torch.Tensor) -> torch.Tensor:
    """f32[3] mass-weighted mean of the raw acceleration at the particles
    that deposited ``rho`` (f32[G, G, G]), taken from the grids instead:
    the deposit and the gather share their CIC weights and dead slots do
    neither, so sum_i w_i a(x_i) = sum_c rho_c a_c and sum_i w_i = sum_c
    rho_c, exactly in real arithmetic (float32 rounding of rho apart).
    ``grids``: the interleaved f32[3, G, G, G] view solved from ``rho``.
    On CUDA one launch of the momentum sums' grid instance (float64 sums
    in an order fixed by G); :func:`grid_momentum_mean_plain` on CPU
    tensors."""
    global MOMENTUM_LAUNCHES
    _check_grid_pair(rho, grids)
    with trace.span("pm.momentum", device=rho.is_cuda):
        if rho.device.type == "cpu":
            return grid_momentum_mean_plain(rho, grids)
        dev = rho.device
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        out = torch.empty(8, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials, counter = _momentum_workspace(dev, stream)
        with torch.cuda.device(dev):
            err = cuda_build.library().psim_momentum_sums_grid(
                grids.data_ptr(), rho.data_ptr(), rho.numel(),
                partials.data_ptr(), counter.data_ptr(), MOMENTUM_MAX_BLOCKS,
                out.data_ptr(), stream)
        MOMENTUM_LAUNCHES += 1
        cuda_build.check(err, "momentum sums (grid)")
        return out[4:7]


def gather_kick_and_step(grids: torch.Tensor, pos: torch.Tensor,
                         vel: torch.Tensor, param_vec: torch.Tensor,
                         mean: torch.Tensor, n_active, g_const, box_min,
                         cell, *, periodic: bool, live=None,
                         auto_box: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PM step's tail from the interleaved grids, IN PLACE on (3, R,
    LANE) planes, in one launch of the gather's kicked instance: the
    gather of :func:`gather` at ``pos`` (``box_min``, ``cell``,
    ``periodic``, ``live`` / ``n_active`` as there), then
    :func:`clean_kick_and_step`'s operations in its order with ``mean``
    (f32[3]) and the scale ``g_const``, or ``g_const / (cell * cell)``
    with ``auto_box``. The raw f32[3, N] field is never written. For a
    given mean the same bits as :func:`gather`, then
    :func:`clean_kick_and_step`; those two on CPU tensors. -> (pos, vel),
    the same tensors."""
    global GATHER_LAUNCHES, KICK_FUSED_LAUNCHES, KICK_GATHER_LAUNCHES
    flat = pos.reshape(3, -1)
    if grid_layout(grids, flat) != "interleaved":
        raise ValueError("grids must be the interleaved f32[3, G, G, G] "
                         "view (pm.interleaved_view), not dense planes")
    _check(flat, None, live)
    step_cuda._check(pos, vel, param_vec, 1)
    dev = pos.device
    g = (g_const if isinstance(g_const, torch.Tensor)
         else device_const((float(g_const),), dev))
    step_cuda._check_scalar("g_const", g, torch.float32, dev)
    step_cuda._check_operand("mean", mean, torch.float32, (3,), dev)
    if dev.type == "cpu":
        trace.count("pm.kick_gathered")
        acc = gather_plain(grids, flat, n_active, box_min, cell,
                           periodic=periodic, live=live)
        return clean_kick_and_step(pos, vel, acc, param_vec, mean, n_active,
                                   g, live=live,
                                   cell=cell if auto_box else None)
    with trace.span("pm.kick", device=True):
        trace.count("pm.kick_fused")
        trace.count("pm.kick_gathered")
        na, bmin, cell_t = _device_args(flat, n_active, box_min, cell)
        gd = grids.shape[1]
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = cuda_build.library().psim_pm_gather_kick(
                grids.data_ptr(), pos.data_ptr(), vel.data_ptr(),
                flat.shape[1], na.data_ptr(), _ptr(live), bmin.data_ptr(),
                cell_t.data_ptr(), gd, pm.clamp_limit(gd, periodic),
                int(periodic), param_vec.data_ptr(), mean.data_ptr(),
                g.data_ptr(), cell_t.data_ptr() if auto_box else None,
                stream)
        GATHER_LAUNCHES += 1
        KICK_FUSED_LAUNCHES += 1
        KICK_GATHER_LAUNCHES += 1
        cuda_build.check(err, "pm gather kick")
    return pos, vel


def clean_kick_and_step(pos: torch.Tensor, vel: torch.Tensor,
                        acc: torch.Tensor, param_vec: torch.Tensor,
                        mean: torch.Tensor, n_active, g_const, *,
                        live=None, cell=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PM step's tail, IN PLACE on (3, R, LANE) planes, in one launch
    of the step kernel's kicked form (step_cuda.kick_step; its plain
    version on CPU tensors): ``a = (acc - mean) * live`` (``live`` bool[N]
    or ``arange < n_active``), ``a = scale * a`` with scale ``g_const``,
    or ``g_const / (cell * cell)`` when the auto box's ``cell`` is given,
    then ``vel += a * dt`` and the attractor step. ``acc``: the raw
    f32[3, N] acceleration; ``mean``: :func:`momentum_mean` of it. The
    same operations in the same order as :func:`clean_and_scale`, then
    ``vel += a * dt`` and the step kernel: for a given mean, the same
    bits. -> (pos, vel), the same tensors."""
    global KICK_FUSED_LAUNCHES
    dev = pos.device
    with trace.span("pm.kick", device=pos.is_cuda):
        trace.count("pm.kick_fused")
        g = (g_const if isinstance(g_const, torch.Tensor)
             else device_const((float(g_const),), dev))
        na = None if live is not None else torch.as_tensor(
            n_active, dtype=torch.int32, device=dev)
        out = step_cuda.kick_step(pos, vel, acc, param_vec, mean=mean,
                                  live=live, n_active=na, g=g, cell=cell)
        if dev.type == "cuda":
            KICK_FUSED_LAUNCHES += 1
        return out


# -- the pipeline --------------------------------------------------------------------
def _mesh(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig", *, masses,
          live, coll, plain: bool, cell_sorted: bool) -> tuple:
    """(rho, grids, box_min, cell, periodic): :func:`accel_raw`'s deposit
    and solve, and the box its gather takes."""
    dep = (deposit_plain if plain else
           functools.partial(deposit, cell_sorted=cell_sorted))
    if cfg.auto_box:
        if live is not None:
            raise ValueError("a live mask needs a static box")
        # coords clamp into the traced box in either boundary mode, as in
        # pm.pm_accel_ref: the upper corner never needs the wrap
        box_min, cell = pm.auto_box(pos_flat, n_active, cfg.grid, coll=coll)
        periodic, solve_kw = False, {"cell_size": 1.0}
    else:
        periodic, solve_kw = cfg.boundary == "periodic", {}
        box_min, cell = static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   pos_flat.device)
    rho = dep(pos_flat, n_active, box_min, cell, cfg.grid,
              periodic=periodic, masses=masses, live=live)
    if coll is not None:
        coll.sum_(rho)
    grids = pm.solve_accel(rho, cfg, cfg.softening, fused=not plain,
                           **solve_kw)
    return rho, grids, box_min, cell, periodic


def accel_raw(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig", *,
              masses=None, live=None, coll=None, plain: bool = False,
              cell_sorted: bool = False) -> tuple:
    """(acc, cell): the gathered f32[3, N] acceleration of
    :func:`pm_accel` before its momentum clean and scale; ``cell`` is the
    auto box's 0-d cell size (the scale is G / cell^2), None for a static
    box (the scale is G). ``plain``: the plain deposit, solve and gather
    on any device. ``cell_sorted``: :func:`deposit`'s, for a caller that
    keeps ``pos_flat`` in the order of the grid's lower cells."""
    _, grids, box_min, cell, periodic = _mesh(
        pos_flat, n_active, cfg, masses=masses, live=live, coll=coll,
        plain=plain, cell_sorted=cell_sorted)
    gat = gather_plain if plain else gather
    return (gat(grids, pos_flat, n_active, box_min, cell, periodic=periodic,
                live=live), cell if cfg.auto_box else None)


def pm_accel(pos_flat: torch.Tensor, n_active, g_const, cfg: "P.PMConfig",
             *, masses=None, live=None, coll=None,
             plain: bool = False) -> torch.Tensor:
    """f32[3, N] PM acceleration through the deposit and gather kernels
    (the plain versions on CPU tensors), at any grid size. ``cfg.auto_box``
    solves in cell units inside a box
    tracking the cloud (computed on the device) and rescales by 1/h^2, as
    pm.pm_accel_ref does. ``masses`` f32[N] weights the deposit (the
    sources); the gather gives an acceleration field. ``live`` (bool[N],
    static box only) overrides ``arange < n_active``, as in
    :func:`deposit`.

    ``coll`` (parallel.mesh.Collectives): ``pos_flat`` is this rank's
    shard (``n_active`` its local live count); the mass grid is summed
    over the ranks (the one large collective), the solve runs on every
    rank, the gather stays local, and the auto box and the momentum
    clean are global. ``plain``: the kernels' plain versions on any
    device."""
    acc, cell = accel_raw(pos_flat, n_active, cfg, masses=masses,
                          live=live, coll=coll, plain=plain)
    return clean_and_scale(acc, n_active, g_const, cell=cell, masses=masses,
                           live=live, coll=coll)


def clean_and_scale(acc: torch.Tensor, n_active, g_const, *, cell=None,
                    masses=None, live=None, coll=None) -> torch.Tensor:
    """pm.momentum_clean of the raw f32[3, N] field ``acc``, then the
    scale ``g_const`` (or ``g_const / (cell * cell)`` with the auto box's
    ``cell``). Arguments as in :func:`pm_accel`."""
    acc = pm.momentum_clean(acc, n_active, masses, live=live, coll=coll)
    return (g_const if cell is None else g_const / (cell * cell)) * acc


def step_pm_planes(pos: torch.Tensor, vel: torch.Tensor,
                   param_vec: torch.Tensor, g_const, n_active,
                   cfg: "P.PMConfig", *, masses=None, live=None, coll=None,
                   cell_sorted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PM step on (3, R, LANE) planes, IN PLACE: the deposit and the
    solve, then the tail. On CUDA tensors with interleaved grids and no
    ``coll``, two launches: :func:`grid_momentum_mean` from rho and the
    grids, then :func:`gather_kick_and_step` (the raw field is never
    written). Otherwise the gather, :func:`momentum_mean` (``coll``: the
    sums all-reduced) and :func:`clean_kick_and_step`, the plain versions
    of each on CPU tensors. Arguments as in :func:`pm_accel`;
    ``cell_sorted`` as in :func:`accel_raw`. -> (pos, vel), the same
    tensors."""
    flat = pos.reshape(3, -1)
    rho, grids, box_min, cell, periodic = _mesh(
        flat, n_active, cfg, masses=masses, live=live, coll=coll,
        plain=False, cell_sorted=cell_sorted)
    if (flat.is_cuda and coll is None
            and grid_layout(grids, flat) == "interleaved"):
        mean = grid_momentum_mean(rho, grids)
        return gather_kick_and_step(grids, pos, vel, param_vec, mean,
                                    n_active, g_const, box_min, cell,
                                    periodic=periodic, live=live,
                                    auto_box=cfg.auto_box)
    acc = gather(grids, flat, n_active, box_min, cell, periodic=periodic,
                 live=live)
    mean = momentum_mean(acc, n_active, masses=masses, live=live, coll=coll)
    return clean_kick_and_step(pos, vel, acc, param_vec, mean, n_active,
                               g_const, live=live,
                               cell=cell if cfg.auto_box else None)


def step_pm(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
            pair_vec: torch.Tensor, n_active, cfg: "P.PMConfig", *,
            masses=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PM step on (3, R, LANE) planes, in place: :func:`step_pm_planes`
    (on CPU tensors the bits of the plain pm.step_pm_ref). -> (pos, vel),
    the same tensors."""
    return step_pm_planes(pos, vel, param_vec, pair_vec[0], n_active, cfg,
                          masses=masses)
