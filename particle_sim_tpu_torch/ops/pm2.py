"""Multi-level particle mesh — sub-mesh-scale forces in refinement windows.

Counterpart of ``particle_sim_tpu/ops/pm2.py``, with the same functions,
names and argument order. The single-level PM (ops/pm.py, ops/pm_cuda.py)
resolves forces down to its softening, which mesh accuracy pins at
~2-3 cells of the world grid. A refinement level adds:

  * **a fine mesh** of the same G^3 cells over a window (h2 =
    window_size / G), holding only the particles inside the window;
  * **the difference kernel** g_eps - g_eps_outer (pm.solve_accel_diff):
    exactly the short-range part the level above smoothed away;
  * **one mask for sources and receivers**, so the correction acts on
    window-internal pairs only and is antisymmetric (momentum-exact).

Levels nest (``pmn_accel``): level k solves g_eps_k - g_eps_{k-1} over
window_k, clamped inside window_{k-1}'s source mask, so the composite
telescopes and a pair feels the softening of the innermost window holding
both of its ends. Tracked origins (``window_min=None``) follow the mass
centroid of the parent level's members, computed on the device.

``pmn_accel`` / ``pm2_accel`` run every level on the CUDA deposit and
gather kernels (ops/pm_cuda.py): the window's origin goes in as the
deposit's device box, its mask as the ``live`` mask (outside particles
deposit nothing and gather exactly 0, whatever their position). No sort
is needed: the JAX fast path sorts only for its TPU kernels. The levels'
raw fields are summed (``pmn_accel_raw``) and cleaned once (ops/pm_cuda.py).
The windows' bookkeeping (every level's origin and mask; on CUDA also
the exact window's of ops/pmx.py) is :func:`window_pass`: on CUDA one
launch of csrc/windows.cu a window, on CPU tensors the plain functions
(``_nested_wmins``, ``_in_window``).
On CPU tensors the wrappers take their plain versions. ``pmn_accel_ref`` /
``pm2_accel_ref`` are the plain path (scatter/gather, as the JAX jnp
reference). Window origins stay on the device; no step reads back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import params as P
from ..utils import cuda_build, trace
from . import physics, pm, pm_cuda

#: Launches of the window pass kernel (csrc/windows.cu) in this process.
WINDOW_LAUNCHES = 0
#: Blocks of the window pass at most (8 of 256 threads on each of the
#: H100's 132 SMs): with N they fix the order of its sums.
WINDOW_MAX_BLOCKS = 132 * 8


@dataclass(frozen=True)
class PM2Config:
    """Fine-level configuration (the fields of the JAX package's, with the
    same defaults, so checkpoints carry it across).

    window_min:  world coords of the refinement window origin, or None to
                 TRACK the live mass centroid every step (only the origin
                 moves; the size, and with it the cached spectra, stays).
    window_size: window extent per axis (fine cell h2 = window_size/grid;
                 the grid resolution is the coarse PMConfig's).
    softening:   fine Plummer eps — resolve eps >= ~2.5 h2; must be < the
                 softening of the level above.
    margin:      shrink (world units) of the correction mask inside the
                 window, for sources and receivers alike. Default 0.
    gradient:    'exact' or 'fd', as in PMConfig.
    park:        the persistent two-level mode's parking band (JAX
                 ops/pm_persist.py); carried, unused per frame.
    """
    window_min: Optional[Tuple[float, float, float]]
    window_size: float
    softening: float
    margin: float = 0.0
    gradient: str = "exact"
    park: float = 1.0


def as_levels(pm2) -> tuple:
    """A refinement stack (None, one PM2Config or a tuple) as a tuple of
    levels, outermost first."""
    if pm2 is None:
        return ()
    return pm2 if isinstance(pm2, tuple) else (pm2,)


def _f32(v: float) -> float:
    """``v`` rounded to float32 (jnp.float32(v) of the JAX code)."""
    return float(np.float32(v))


def _in_window(pos_flat: torch.Tensor, wmin: torch.Tensor, size: float,
               shrink: float) -> torch.Tensor:
    lo = wmin.reshape(3, 1) + _f32(shrink)
    hi = lo + _f32(size - 2.0 * shrink)
    return ((pos_flat >= lo) & (pos_flat < hi)).all(dim=0)


def window_min(pos_flat: torch.Tensor, n_active, cfg2: PM2Config,
               masses=None, live=None, coll=None) -> torch.Tensor:
    """f32[3] window origin on pos_flat's device: the static config value,
    or (tracked) the live mass centroid minus half the window. ``live``
    (bool[N]) overrides ``arange < n_active``. ``coll``
    (parallel.mesh.Collectives): the centroid of every rank's shard (one
    all-reduce of four numbers), so every rank agrees on the window."""
    dev = pos_flat.device
    if cfg2.window_min is not None:
        return pm_cuda.device_const(tuple(float(v) for v in cfg2.window_min),
                                    dev)
    if live is None:
        live = pm.live_mask(pos_flat.shape[1], n_active, dev)
    w = live.to(torch.float32)
    if masses is not None:
        w = w * masses
    s = (pos_flat * w[None]).sum(dim=1)
    tot = w.sum()
    if coll is not None:
        st = coll.sum_(torch.cat([s, tot.reshape(1)]))
        s, tot = st[:3], st[3]
    c = s / torch.clamp_min(tot, 1e-12)
    return c - 0.5 * _f32(cfg2.window_size)


def fine_kernels(cfg: "P.PMConfig", cfg2: PM2Config,
                 eps_outer: Optional[float] = None, *,
                 device="cpu") -> tuple:
    """The fine solve's difference spectra on ``device`` (cached;
    pm.diff_kernels_device). ``eps_outer`` defaults to the coarse
    softening; deeper levels pass the PARENT level's."""
    h2 = cfg2.window_size / cfg.grid
    eo = cfg.softening if eps_outer is None else eps_outer
    return pm.diff_kernels_device(cfg.grid, h2, cfg2.softening, eo,
                                  cfg2.gradient, device=device)


def levels_kernels(cfg: "P.PMConfig", levels, *, device="cpu") -> tuple:
    """Per-level spectra for pmn_accel: level k's difference kernel
    subtracts the PREVIOUS level's softening (telescoping)."""
    out, eps_outer = [], cfg.softening
    for c2 in levels:
        out.append(fine_kernels(cfg, c2, eps_outer=eps_outer, device=device))
        eps_outer = c2.softening
    return tuple(out)


def _fine_accel_ref(pos_flat, n_active, cfg, cfg2, masses, wmin,
                    kernels=None, eps_outer: Optional[float] = None):
    """f32[3, N] difference-kernel acceleration, unmasked (plain path).
    ``eps_outer`` defaults to the coarse softening (two-level mode)."""
    h2 = cfg2.window_size / cfg.grid
    eo = cfg.softening if eps_outer is None else eps_outer
    coords2 = pm.cell_coords_dyn(pos_flat, wmin, h2, cfg.grid)
    live = pm.live_mask(pos_flat.shape[1], n_active, pos_flat.device)
    w_src = (_in_window(pos_flat, wmin, cfg2.window_size, cfg2.margin)
             & live).to(torch.float32)
    m_src = w_src if masses is None else w_src * masses
    rho2 = pm.cic_deposit_ref(pos_flat, n_active, cfg, coords=coords2,
                              masses=m_src)
    grids2 = pm.solve_accel_diff(rho2, cfg.grid, h2, cfg2.softening, eo,
                                 cfg2.gradient, kernels=kernels)
    return pm.cic_gather_ref(grids2, pos_flat, cfg, coords=coords2)


def pm2_accel_ref(pos_flat: torch.Tensor, n_active, g_const,
                  cfg: "P.PMConfig", cfg2: PM2Config, masses=None,
                  kernels=None) -> torch.Tensor:
    """f32[3, N] two-level PM acceleration — plain path (the one-level
    case of pmn_accel_ref)."""
    return pmn_accel_ref(pos_flat, n_active, g_const, cfg, (cfg2,),
                         masses=masses,
                         kernels=None if kernels is None else (kernels,))


def fine_accel_fast(pos_flat: torch.Tensor, live: torch.Tensor, n_active,
                    cfg: "P.PMConfig", cfg2: PM2Config, *, wmin: torch.Tensor,
                    inner: torch.Tensor, masses=None, kernels=None,
                    eps_outer: Optional[float] = None,
                    coll=None) -> torch.Tensor:
    """f32[3, N] fine-level (difference-kernel) acceleration, already
    masked to the window-internal receivers, through the deposit and
    gather kernels, which take the particles in slot order (the JAX
    package's sorted kernels need a grouping sort). ``wmin`` (f32[3]) and
    ``inner`` (bool[N], in-window & live) are this level's origin and mask
    from :func:`window_pass`; ``inner`` goes to both kernels as their
    ``live`` (which it includes): outside particles deposit nothing and
    gather exactly 0. ``n_active`` (a device tensor keeps the step free of
    uploads) is passed through to the wrappers. ``coll``
    (parallel.mesh.Collectives): the fine grid is summed over the ranks."""
    g = cfg.grid
    h2 = cfg2.window_size / g
    eo = cfg.softening if eps_outer is None else eps_outer
    cell = pm_cuda.device_const((h2,), pos_flat.device)
    on_device = pos_flat.is_cuda
    with trace.span("pm2.deposit", device=on_device):
        rho2 = pm_cuda.deposit(pos_flat, n_active, wmin, cell, g,
                               periodic=False, masses=masses, live=inner)
    if coll is not None:
        coll.sum_(rho2)
    with trace.span("pm2.solve", device=on_device):
        grids2 = pm.solve_accel_diff(rho2, g, h2, cfg2.softening, eo,
                                     cfg2.gradient, kernels=kernels,
                                     fused=True)
    with trace.span("pm2.gather", device=on_device):
        return pm_cuda.gather(grids2, pos_flat, n_active, wmin, cell,
                              periodic=False, live=inner)


def pm2_accel(pos_flat: torch.Tensor, n_active, g_const,
              cfg: "P.PMConfig", cfg2: PM2Config, *, masses=None,
              kernels=None) -> torch.Tensor:
    """f32[3, N] two-level PM acceleration on the kernels (the one-level
    case of pmn_accel)."""
    return pmn_accel(pos_flat, n_active, g_const, cfg, (cfg2,),
                     masses=masses,
                     kernels=None if kernels is None else (kernels,))


# ---------------------------------------------------------------------------
# multi-level nesting (k refinement windows, outermost first)
# ---------------------------------------------------------------------------

def _validate_levels(cfg: "P.PMConfig", levels) -> tuple:
    """Static nesting checks: each level's softening strictly below its
    parent's (the difference split needs eps_k < eps_{k-1}) and each
    window small enough to fit inside the parent's margin-shrunk source
    mask (so the origin clamp in _nested_wmins can always nest)."""
    levels = tuple(levels)
    if not levels:
        raise ValueError("need at least one refinement level")
    prev_size = float(cfg.box_size)
    prev_eps = float(cfg.softening)
    prev_margin = 0.0
    for k, c2 in enumerate(levels):
        if c2.softening >= prev_eps:
            raise ValueError(
                f"level {k} softening {c2.softening} must be < the level "
                f"above ({prev_eps}) for the difference-kernel split")
        if c2.window_size > prev_size - 2.0 * prev_margin:
            raise ValueError(
                f"level {k} window {c2.window_size} cannot nest inside "
                f"the level above (usable extent "
                f"{prev_size - 2.0 * prev_margin})")
        prev_size = float(c2.window_size)
        prev_eps = float(c2.softening)
        prev_margin = float(c2.margin)
    return levels


def clamp_nested(w: torch.Tensor, parent_w: torch.Tensor, parent,
                 size: float) -> torch.Tensor:
    """Origin ``w`` of a window of ``size`` clamped inside the parent
    level's margin-shrunk source mask (parent origin ``parent_w``)."""
    return torch.clamp(
        w, parent_w + _f32(parent.margin),
        parent_w + _f32(parent.window_size - parent.margin - size))


def _both_static(k: int, c2, pc) -> bool:
    """Whether level ``k`` (``c2``) and its parent ``pc`` are both static;
    then ``c2`` is validated to nest inside ``pc``'s source mask, in
    float64 (ValueError), and is not clamped."""
    if c2.window_min is None or pc.window_min is None:
        return False
    lo = np.asarray(pc.window_min, np.float64) + pc.margin
    hi = lo + (pc.window_size - 2.0 * pc.margin - c2.window_size)
    cw = np.asarray(c2.window_min, np.float64)
    if (cw < lo - 1e-6).any() or (cw > hi + 1e-6).any():
        raise ValueError(
            f"level {k} static window {c2.window_min} does "
            f"not nest inside level {k - 1}'s source mask "
            f"[{tuple(lo)}, {tuple(hi)}]")
    return True


def _nested_wmins(pos_flat, live, cfg, levels, masses, coll=None):
    """Per-level window origins, each nested inside the level above.

    Tracked origins follow the mass centroid of the PARENT level's members
    and are clamped so window_k stays inside level k-1's source mask (the
    telescoping composition needs a pair corrected at level k to be
    corrected at level k-1). A static child under a static parent is
    validated here, in float64; under a tracked parent it is clamped like
    a tracked one (an identity wherever it already nests). ``coll``: the
    centroids over every rank's shard (window_min)."""
    wmins = []
    lv_live = live
    prev = None
    for k, c2 in enumerate(levels):
        w = window_min(pos_flat, None, c2, masses, live=lv_live, coll=coll)
        if prev is not None:
            pw, pc = prev
            if not _both_static(k, c2, pc):
                w = clamp_nested(w, pw, pc, c2.window_size)
        wmins.append(w)
        lv_live = _in_window(pos_flat, w, c2.window_size, c2.margin) & live
        prev = (w, c2)
    return wmins


class Windows(NamedTuple):
    """What :func:`window_pass` hands back, on the positions' device."""
    origins: tuple          # f32[3] a level, outermost first
    masks: tuple            # bool[N] a level (live and inside), or ()
    x_origin: Optional[torch.Tensor] = None  # the exact window's f32[3]
    x_member: Optional[torch.Tensor] = None  # its bool[N] members
    x_count: Optional[torch.Tensor] = None   # int32 0-d: how many


class Win(NamedTuple):
    """The fields of a window that the pass reads (of a PM2Config or an
    ops/pmx.py PMXConfig): its static origin (None: tracked), its size
    and its margin."""
    window_min: Optional[tuple]
    window_size: float
    margin: float

    @classmethod
    def of(cls, c) -> "Win":
        return cls(None if c.window_min is None
                   else tuple(float(v) for v in c.window_min),
                   float(c.window_size), float(c.margin))


class _Launch(NamedTuple):
    """One launch of csrc/windows.cu: window ``win`` (-1: none, the live
    slots), its origin from the previous launch's sums (``tracked``) or
    ``static``, clamped into window ``parent`` (-1: not clamped) by
    [parent + clamp_lo, parent + clamp_hi], its members the slots in
    [origin + shrink, origin + shrink + extent); ``sums``: it reduces its
    members' sums for the next launch's origin."""
    win: int
    tracked: bool
    static: tuple
    parent: int
    half: float
    clamp_lo: float
    clamp_hi: float
    shrink: float
    extent: float
    sums: bool


@functools.lru_cache(maxsize=64)
def _plan(wins: tuple, exact: bool) -> tuple:
    """The launches of one pass over ``wins`` (Win: the levels, outermost
    first, then with ``exact`` the exact window): a first launch reduces
    the live slots' sums when window 0 is tracked, then one a window. The
    constants are the plain functions' float32 operands: window_min's
    half window, clamp_nested's offsets, _in_window's shrink and extent.
    Nesting as _nested_wmins (two static levels validated, not clamped)
    and ops/pmx.py's window_origin (the exact window always
    clamped)."""
    out = []
    if wins[0].window_min is None:
        out.append(_Launch(-1, False, (0.0,) * 3, -1, 0.0, 0.0, 0.0, 0.0,
                           0.0, True))
    for k, c in enumerate(wins):
        parent, lo, hi = -1, 0.0, 0.0
        if k > 0:
            pc = wins[k - 1]
            if (exact and k == len(wins) - 1) or not _both_static(k, c, pc):
                parent, lo = k - 1, _f32(pc.margin)
                hi = _f32(pc.window_size - pc.margin - c.window_size)
        tracked = c.window_min is None
        out.append(_Launch(
            k, tracked,
            (0.0,) * 3 if tracked else tuple(_f32(v) for v in c.window_min),
            parent, 0.5 * _f32(c.window_size), lo, hi, _f32(c.margin),
            _f32(c.window_size - 2.0 * c.margin),
            k + 1 < len(wins) and wins[k + 1].window_min is None))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _window_workspace(device: torch.device, stream: int) -> tuple:
    """(partials f64[5 * WINDOW_MAX_BLOCKS], counter int32[1]) of the pass
    on one stream (pm_cuda._momentum_workspace's rule: the counter is 0
    between launches)."""
    return (torch.empty(5 * WINDOW_MAX_BLOCKS, dtype=torch.float64,
                        device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def window_pass(pos_flat: torch.Tensor, live: torch.Tensor, levels, *,
                masses=None, exact: Optional[Win] = None, masks: bool = True,
                coll=None, plain: bool = False) -> Windows:
    """The windows' bookkeeping of one step: each level's origin (nested
    as :func:`_nested_wmins`) and, with ``masks``, its mask ``live &
    inside`` (the deposit's and the gather's ``live``). ``live``:
    bool[N]. ``coll``: the centroids over every rank's shard (the masks
    stay this rank's).

    On CUDA one launch of csrc/windows.cu a window (and a first one over
    the live slots when the outermost origin is tracked): each finishes
    its origin from the sums the launch before it reduced (float64 sums,
    rounded to float32; a mesh all-reduces them between launches), tests
    the slots in registers and reduces its members' sums; no f32[3, N]
    temporary. The sums' order differs from torch.sum's, so an origin may
    differ from the plain one by a few float32 ulps. ``exact`` (the exact
    window, ops/pmx.py) adds one launch: its origin, clamped into the
    innermost level (into nothing without levels), and with ``masks`` its
    members and their int32 count. Counted once a pass
    (``pm2.windows.fused``).

    On CPU tensors, or with ``plain``, the plain functions, and no exact
    window (its plain version is ops/pmx.py's window_origin)."""
    global WINDOW_LAUNCHES
    levels = tuple(levels)
    if plain or pos_flat.device.type == "cpu":
        origins = (tuple(_nested_wmins(pos_flat, live, None, levels, masses,
                                       coll=coll)) if levels else ())
        return Windows(origins, tuple(
            _in_window(pos_flat, w, c2.window_size, c2.margin) & live
            for w, c2 in zip(origins, levels)) if masks else ())
    pm_cuda._check(pos_flat, masses, live)
    dev = pos_flat.device
    if dev.type != "cuda" or live is None:
        raise ValueError(f"the window pass needs a CUDA tensor and a live "
                         f"mask, got {dev} and {type(live).__name__}")
    wins = tuple(Win.of(c) for c in levels) + (() if exact is None
                                              else (exact,))
    plan = _plan(wins, exact is not None)
    n, m = pos_flat.shape[1], len(wins)
    origins = torch.empty((m, 3), dtype=torch.float32, device=dev)
    sums = torch.empty((len(plan), 4), dtype=torch.float32, device=dev)
    mask = (torch.empty((m, n), dtype=torch.bool, device=dev) if masks
            else None)
    count = (torch.empty((), dtype=torch.int32, device=dev)
             if masks and exact is not None else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, counter = _window_workspace(dev, stream)
    lib = cuda_build.library()
    o_ptr, s_ptr = origins.data_ptr(), sums.data_ptr()
    with torch.cuda.device(dev):
        for j, ln in enumerate(plan):
            w = ln.win
            err = lib.psim_window_pass(
                pos_flat.data_ptr(), n, live.data_ptr(),
                pm_cuda._ptr(masses),
                s_ptr + 16 * (j - 1) if ln.tracked else None,
                o_ptr + 12 * ln.parent if ln.parent >= 0 else None,
                o_ptr + 12 * w if w >= 0 else None,
                mask.data_ptr() + n * w if mask is not None and w >= 0
                else None,
                s_ptr + 16 * j if ln.sums else None,
                count.data_ptr() if count is not None and w == m - 1
                else None,
                partials.data_ptr(), counter.data_ptr(), WINDOW_MAX_BLOCKS,
                *ln.static, ln.half, ln.clamp_lo, ln.clamp_hi, ln.shrink,
                ln.extent, stream)
            WINDOW_LAUNCHES += 1
            cuda_build.check(err, "window pass")
            if coll is not None and ln.sums:
                coll.sum_(sums[j])
    trace.count("pm2.windows.fused")
    k = len(levels)
    return Windows(
        tuple(origins[i] for i in range(k)),
        tuple(mask[i] for i in range(k)) if masks else (),
        None if exact is None else origins[k],
        None if exact is None or not masks else mask[k], count)


def pmn_accel_ref(pos_flat: torch.Tensor, n_active, g_const,
                  cfg: "P.PMConfig", levels, masses=None,
                  kernels=None) -> torch.Tensor:
    """f32[3, N] MULTI-level PM acceleration — plain path.

    ``levels``: nested refinement windows (PM2Config), outermost first.
    Level k solves the difference kernel g_eps_k - g_eps_{k-1} over
    window_k's sources and receivers, so a pair with both ends inside
    window_k feels the eps_k-softened force. With one level this is
    pm2_accel_ref. ``kernels``: optional levels_kernels() output."""
    levels = _validate_levels(cfg, levels)
    acc = pm.pm_accel_ref(pos_flat, n_active, 1.0, cfg.softening, cfg,
                          masses=masses)
    live = pm.live_mask(pos_flat.shape[1], n_active, pos_flat.device)
    wmins = _nested_wmins(pos_flat, live, cfg, levels, masses)
    eps_outer = cfg.softening
    for k, (c2, w) in enumerate(zip(levels, wmins)):
        ker = None if kernels is None else kernels[k]
        acc2 = _fine_accel_ref(pos_flat, n_active, cfg, c2, masses, w,
                               kernels=ker, eps_outer=eps_outer)
        inner = (_in_window(pos_flat, w, c2.window_size, c2.margin)
                 & live).to(torch.float32)
        acc = acc + acc2 * inner[None]
        eps_outer = float(c2.softening)
    return g_const * pm.momentum_clean(acc, n_active, masses)


def pmn_accel_raw(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig",
                  levels, *, masses=None, kernels=None, live=None,
                  coll=None, exact: Optional[Win] = None
                  ) -> Tuple[torch.Tensor, Windows]:
    """(f32[3, N] multi-level PM field, the step's :class:`Windows`) on the
    deposit and gather kernels at any grid size (their plain versions on
    CPU tensors), before the momentum clean and the G scale: the coarse
    pm_cuda.accel_raw, one :func:`window_pass` (every level's origin and
    mask, and ``exact``'s on CUDA), then one deposit + difference solve +
    gather a level (fine_accel_fast). Traced: the window pass in span
    ``pm2.windows``, each level (its field added in) in ``pm2.level``
    around its masked deposit's ``pm2.deposit``, difference solve's
    ``pm2.solve`` and masked gather's ``pm2.gather``. Needs a static
    coarse box. ``live`` (bool[N]) overrides ``arange < n_active``.
    ``coll`` (parallel.mesh.Collectives): ``pos_flat`` is this rank's
    shard; every grid is summed over the ranks, the origins are
    global."""
    if cfg.auto_box:
        raise ValueError("multi-level PM needs a static coarse box")
    levels = _validate_levels(cfg, levels)
    if live is None:
        live = pm.live_mask(pos_flat.shape[1], n_active, pos_flat.device)
    acc, _ = pm_cuda.accel_raw(pos_flat, n_active, cfg, masses=masses,
                               live=live, coll=coll)
    on_device = pos_flat.is_cuda
    with trace.span("pm2.windows", device=on_device):
        win = window_pass(pos_flat, live, levels, masses=masses, exact=exact,
                          coll=coll)
    eps_outer = cfg.softening
    for k, c2 in enumerate(levels):
        ker = None if kernels is None else kernels[k]
        with trace.span("pm2.level", device=on_device):
            acc = acc + fine_accel_fast(pos_flat, live, n_active, cfg, c2,
                                        wmin=win.origins[k],
                                        inner=win.masks[k], masses=masses,
                                        kernels=ker, eps_outer=eps_outer,
                                        coll=coll)
        eps_outer = float(c2.softening)
    return acc, win


def pmn_accel(pos_flat: torch.Tensor, n_active, g_const,
              cfg: "P.PMConfig", levels, *, masses=None,
              kernels=None, live=None, coll=None) -> torch.Tensor:
    """f32[3, N] multi-level PM acceleration: :func:`pmn_accel_raw`, then
    pm_cuda.clean_and_scale (a global clean with ``coll``)."""
    acc, _ = pmn_accel_raw(pos_flat, n_active, cfg, levels, masses=masses,
                           kernels=kernels, live=live, coll=coll)
    return pm_cuda.clean_and_scale(acc, n_active, g_const, masses=masses,
                                   live=live, coll=coll)


def step_pmn(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
             pair_vec: torch.Tensor, n_active, cfg: "P.PMConfig", levels, *,
             masses=None, kernels=None, use_fast: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame: multi-level PM self-gravity + the attractor step on
    (3, R, LANE) planes. ``use_fast``: pmn_accel_raw and the PM step's
    tail (pm_cuda.momentum_mean, clean_kick_and_step), IN PLACE; else the
    plain pmn_accel_ref and physics.kick_and_step_planes. -> (pos, vel)."""
    flat = pos.reshape(3, -1)
    if use_fast:
        acc, _ = pmn_accel_raw(flat, n_active, cfg, levels, masses=masses,
                               kernels=kernels)
        mean = pm_cuda.momentum_mean(acc, n_active, masses=masses)
        return pm_cuda.clean_kick_and_step(pos, vel, acc, param_vec, mean,
                                           n_active, pair_vec[0])
    acc = pmn_accel_ref(flat, n_active, pair_vec[0], cfg, levels,
                        masses=masses, kernels=kernels)
    return physics.kick_and_step_planes(pos, vel, acc.reshape(pos.shape),
                                        param_vec)


def step_pm2(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
             pair_vec: torch.Tensor, n_active, cfg: "P.PMConfig",
             cfg2: PM2Config, *, masses=None, kernels=None,
             use_fast: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of two-level PM (step_pmn with one level)."""
    return step_pmn(pos, vel, param_vec, pair_vec, n_active, cfg, (cfg2,),
                    masses=masses,
                    kernels=None if kernels is None else (kernels,),
                    use_fast=use_fast)
