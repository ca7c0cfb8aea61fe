"""Persistent cell-sorted PM state: the particles stay in cell order
between frames.

Counterpart of ``particle_sim_tpu/ops/pm_persist.py``. The state keeps
the particles in (approximately) cell-sorted slots, with their identity
riding along as ``ids``; a frame runs in slot order and never un-sorts.
The JAX package built this to drop its two grouping sorts a frame. The
port's PM kernels sort nothing (csrc/pm.cu), so here the order is kept
for the kernels' sake: on cell-sorted input a block's particles share a
few cells, so the deposit's pre-sums leave few atomics, and the gather
reads neighbouring grid cells. Without refinement levels the slots are
sorted by the deposit grid's own lower cells (:func:`cell_keys`), so the
deposit is the one for that input (``pm_cuda.deposit(...,
cell_sorted=True)``, counted by ``pm.deposit.sorted``); the class orders
of the levels are not, and keep the deposit for any order.

  * The steady frame is the per-frame pipeline of
    ``pm_cuda.step_pm_planes`` on the sorted planes: ``pm_cuda.deposit`` ->
    ``pm.solve_accel`` (cuFFT) -> ``pm_cuda.grid_momentum_mean`` (one
    launch: the mean from rho and the grids) ->
    ``pm_cuda.gather_kick_and_step`` (one launch of the gather's kicked
    instance: the gather, the clean, the G scale, the kick and the
    attractor). Refinement levels (ops/pm2.py) and the window-exact
    correction (ops/pmx.py) run unchanged on the same planes and add
    their raw fields to the coarse one, which then ends in
    ``pm_cuda.momentum_mean`` and ``pm_cuda.clean_kick_and_step`` (the
    step kernel's kicked form). No sort, no host read. Liveness is
    ``ids < n_active``, so any slot order gives the same physics (f32
    summation order aside).
  * A **repair** re-sorts the state: ``psort.sort((key, slot))`` on the
    radix kernels, then ``index_select`` of every payload (pos, vel, ids,
    masses, col24), as ops/pmx.py compacts. Dead slots carry the largest
    key, so after every repair they form the tail: the live slots are the
    prefix [0, n_active), which the renderers and the stream packer read.
    Between repairs slots do not move.
  * **When a repair fires**: the JAX package repairs when its span pair
    tables would overflow their shared-memory budgets. The port's kernels
    have no pair tables, so the measure is the **disorder**: the number
    of adjacent slots whose sort key decreases, one reduction on the
    device. :func:`needs_repair` compares it with ``REPAIR_SHARE *
    n_active``. A direct call with ``repair=None`` reads that verdict
    (one device read, like the JAX ``lax.cond``); the engine reads it
    through :class:`RepairTrigger`, which never waits for the device.
    Since the PM kernels do not depend on the order, a late repair only
    costs speed.
  * **Multi-level order**: with refinement levels the sort key is the
    class key of the JAX package: class m (1..k) holds the members of
    level m's window widened by its parking band (the innermost window
    wins), sorted by level m's own cell key; class 0 the other live
    particles by coarse cell; dead slots last. ``fine_b`` counts the
    slots below each class boundary. The port's level kernels mask by
    the current window membership, so the classes only give locality:
    no frozen membership, no forced repair on an entrant. The mirror is
    made in the class order (:func:`init_sorted` with ``cfg2``,
    :func:`init_sorted_multi`), so its first frame needs no repair.

:func:`unsort` gathers by the inverse permutation of ``ids``, where the
JAX package sorts by ``ids`` (scatter is serial on the TPU).
:func:`accel_sorted_ref` is the plain version: the same state through
the plain PM path in identity order.

Not ported: ``pick_chunk``, ``pick_segment``, ``budgets`` and
``budgets_multi`` size the TPU kernels' pair tables, which the CUDA
kernels do not have. Every repair is the full sort: the JAX package's
segment-local first tier, on the radix sort a composite key with one
8-bit digit more, measured slower than it (chip_smoke.py phase 19,
PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..core import params as P
from ..core.state import LANE
from ..utils import trace
from . import physics, pm, pm2, pm_cuda, pmx, psort

#: Grids of the JAX package's persistent mode; its cell and class keys
#: fit in int32 with room for several levels at all of them.
SUPPORTED_GRIDS = (32, 64, 128, 256)
#: A repair fires when more than this share of n_active adjacent slot
#: pairs are out of order.
REPAIR_SHARE = 0.25
#: Frames between two disorder measurements in the engine.
CHECK_EVERY = 8


class SortedPMState(NamedTuple):
    """Particle state in (approximately) cell-sorted slot order.

    ``resorts`` counts repairs; it is a host int, since the host decides
    every repair. ``fine_b``: an int32 0-d tensor (one level or none) or
    int32[k] (k levels, :func:`init_sorted_multi`): the slots below each
    class boundary of the last repair (N everywhere before the first
    one). ``col24``: the generation colour packed 8:8:8 in slot order
    (render/raster.pack_col24), so the frames of colour mode 0 need no
    un-sort."""
    pos: torch.Tensor               # f32[3, N]
    vel: torch.Tensor               # f32[3, N]
    ids: torch.Tensor               # int32[N]: the particle in each slot
    masses: Optional[torch.Tensor]  # f32[N] source masses, slot order
    resorts: int
    fine_b: Optional[torch.Tensor] = None
    col24: Optional[torch.Tensor] = None


def _check_config(cfg: "P.PMConfig", n: int) -> None:
    if n % 512:
        raise ValueError(f"particle capacity {n} not a multiple of 512")
    if cfg.auto_box:
        raise ValueError("persistent sorted mode needs a static box; "
                         "use pm_cuda.pm_accel for auto_box")
    if cfg.grid not in SUPPORTED_GRIDS:
        raise ValueError(f"persistent sorted mode supports grids "
                         f"{SUPPORTED_GRIDS}, got {cfg.grid}")


# -- sort keys -------------------------------------------------------------------
def _cell_id(coords: torch.Tensor, g: int) -> torch.Tensor:
    # cell coordinates are >= 0 (clamped, or wrapped), so the truncating
    # cast is the floor
    i0 = coords.to(torch.int32)
    return (i0[2] * g + i0[1]) * g + i0[0]


def cell_keys(pos_flat: torch.Tensor, live: torch.Tensor,
              cfg: "P.PMConfig") -> torch.Tensor:
    """int32[N] lower CIC cell (z*G + y)*G + x of each particle in the
    coarse grid; G^3 for dead slots (so they sort last)."""
    g = cfg.grid
    box, cell = pm_cuda.static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   pos_flat.device)
    coords = pm.cell_coords_dyn(pos_flat, box, cell, g,
                                cfg.boundary == "periodic")
    return torch.where(live, _cell_id(coords, g), g ** 3)


def class_keys(pos_flat: torch.Tensor, live: torch.Tensor,
               cfg: "P.PMConfig", levels: Sequence = (),
               wmins: Sequence = ()) -> torch.Tensor:
    """int32[N] sort key of the persistent order: :func:`cell_keys`
    without levels; with them the class key (module docstring): m * 2G^3
    + level m's cell key for class m, (k + 1) * 2G^3 for dead slots.
    ``wmins``: the levels' window origins (pm2.window_pass)."""
    key = cell_keys(pos_flat, live, cfg)
    if not levels:
        return key
    g = cfg.grid
    flag = 2 * g ** 3
    key = torch.where(live, key, (len(levels) + 1) * flag)
    for m, (c2, wm) in enumerate(zip(levels, wmins), start=1):
        memb = pm2._in_window(pos_flat, wm, c2.window_size,
                              c2.margin - c2.park) & live
        cell = pm_cuda.device_const((c2.window_size / g,), pos_flat.device)
        coords = pm.cell_coords_dyn(pos_flat, wm, cell, g)
        key = torch.where(memb, m * flag + _cell_id(coords, g), key)
    return key


def state_keys(st: SortedPMState, n_active, cfg: "P.PMConfig",
               levels: Sequence = (), *,
               use_kernels: bool = True) -> torch.Tensor:
    """The sort keys of ``st``'s particles as they stand; the levels'
    origins from one ``pm2.window_pass`` without masks (its plain version
    without ``use_kernels``)."""
    live = st.ids < n_active
    wmins = (pm2.window_pass(st.pos, live, levels, masses=st.masses,
                             masks=False, plain=not use_kernels).origins
             if levels else ())
    return class_keys(st.pos, live, cfg, levels, wmins)


def disorder(key: torch.Tensor) -> torch.Tensor:
    """int32 0-d: adjacent slots whose key decreases (0 when sorted; dead
    slots in the tail add nothing, a dead slot before a live one adds
    one)."""
    return (key[1:] < key[:-1]).sum(dtype=torch.int32)


def needs_repair(st: SortedPMState, n_active, cfg: "P.PMConfig",
                 levels: Sequence = (), *,
                 use_kernels: bool = True) -> torch.Tensor:
    """bool 0-d on the state's device: disorder > REPAIR_SHARE * n_active.
    Nothing is read back. Traced: span ``persist.verdict`` (the keys,
    with levels their window origins and masks, and the disorder)."""
    with trace.span("persist.verdict", device=st.pos.is_cuda):
        d = disorder(state_keys(st, n_active, cfg, levels,
                                use_kernels=use_kernels))
        return d.to(torch.float32) > REPAIR_SHARE * torch.as_tensor(
            n_active, device=d.device)


# -- sorting ---------------------------------------------------------------------
def _order(key: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """int64[N] slots in stable key order: psort.sort((key, slot)) (the
    radix kernels on CUDA, radix_sort_ref with ``use_kernels=False``)."""
    idx = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    sort = psort.sort if use_kernels else psort.radix_sort_ref
    return sort((key, idx))[1].long()


def _take(st: SortedPMState, perm: torch.Tensor) -> SortedPMState:
    def take(t):
        return None if t is None else t.index_select(-1, perm)

    return st._replace(pos=take(st.pos), vel=take(st.vel), ids=take(st.ids),
                       masses=take(st.masses), col24=take(st.col24))


def _resort(st: SortedPMState, n_active, cfg: "P.PMConfig",
            levels: Sequence, use_kernels: bool) -> SortedPMState:
    """``st`` sorted by its current keys; with levels ``fine_b`` the new
    class boundaries (in ``st.fine_b``'s shape)."""
    key = state_keys(st, n_active, cfg, levels, use_kernels=use_kernels)
    st2 = _take(st, _order(key, use_kernels))
    if not levels:
        return st2
    flag = 2 * cfg.grid ** 3
    fine_b = torch.stack([(key < (m + 1) * flag).sum(dtype=torch.int32)
                          for m in range(len(levels))])
    return st2._replace(fine_b=fine_b.reshape(st.fine_b.shape))


def _fresh(pos_flat, cfg, fine_shape, vel_flat, masses, col24, id_base):
    n = pos_flat.shape[1]
    _check_config(cfg, n)
    dev = pos_flat.device
    ids = torch.arange(id_base, id_base + n, dtype=torch.int32, device=dev)
    vel_flat = torch.zeros_like(pos_flat) if vel_flat is None else vel_flat
    fine_b = torch.full(fine_shape, n, dtype=torch.int32, device=dev)
    return SortedPMState(pos_flat, vel_flat, ids, masses, 0, fine_b, col24)


def init_sorted(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig",
                vel_flat=None, masses=None, col24=None, *, cfg2=None,
                use_kernels: bool = True, id_base: int = 0) -> SortedPMState:
    """A fresh SortedPMState: (pos, vel, identity[, masses][, col24])
    sorted by coarse cell, or with one refinement level ``cfg2`` into its
    class order (``fine_b`` its class boundary; N without ``cfg2``).
    Slots whose identity is at or past ``n_active`` are dead: they sort
    to the tail. ``id_base``: the identity of the first particle (a
    rank's shard of the mesh holds ids id_base + arange(N)). Raises for
    an ``auto_box`` config, a capacity not a multiple of 512 and a grid
    outside SUPPORTED_GRIDS."""
    st = _fresh(pos_flat, cfg, (), vel_flat, masses, col24, id_base)
    return _resort(st, n_active, cfg, pm2.as_levels(cfg2), use_kernels)


def init_sorted_multi(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig",
                      levels, vel_flat=None, masses=None, col24=None, *,
                      use_kernels: bool = True,
                      id_base: int = 0) -> SortedPMState:
    """init_sorted for a tuple of refinement levels (outermost first):
    the k+1-class order, ``fine_b`` int32[k] its class boundaries. (The
    JAX package takes the level count, sorts by coarse cell and repairs
    into the class order on the first frame.)"""
    levels = pm2._validate_levels(cfg, levels)
    st = _fresh(pos_flat, cfg, (len(levels),), vel_flat, masses, col24,
                id_base)
    return _resort(st, n_active, cfg, levels, use_kernels)


def repair_state(st: SortedPMState, n_active, cfg: "P.PMConfig",
                 levels: Sequence = (), *,
                 use_kernels: bool = True) -> SortedPMState:
    """The state re-sorted by its current keys, ``resorts`` + 1 and, with
    levels, ``fine_b`` the new class boundaries."""
    with trace.span("persist.repair", device=st.pos.is_cuda):
        st2 = _resort(st, n_active, cfg, levels, use_kernels)
    return st2._replace(resorts=st.resorts + 1)


def unsort(st: SortedPMState, arrays) -> tuple:
    """``arrays`` (each (..., N) in slot order) in identity order: the
    inverse permutation of ``ids`` made by one ``index_copy_`` of the
    slot numbers (``ids`` is a permutation), then one ``index_select`` an
    array. The JAX package sorts by ``ids`` because scatter is serial on
    the TPU. On the H100 (chip_smoke.py phase 19) this takes half the
    time of that sort on the radix kernels at 1M and about the same at
    16M, where a scatter of the arrays by ``ids`` takes 2.6 times as
    long (its random writes miss the L2)."""
    ids = st.ids.long()
    inv = torch.empty_like(ids)
    inv.index_copy_(0, ids, torch.arange(ids.shape[0], device=ids.device))
    return tuple(a.index_select(-1, inv) for a in arrays)


class RepairTrigger:
    """The engine's repair decision, read without waiting for the device.

    :meth:`measure` queues a copy of a :func:`needs_repair` verdict into
    pinned host memory and records a CUDA event behind it; :meth:`due`
    returns the verdict once, when that event has completed
    (``event.query()``), and False until then. One verdict is in flight
    at a time: a measure while one is unread queues nothing (so a host
    running ahead of the device cannot starve the reads by replacing
    them). On the CPU the copy is done when measure returns.

    The lag: the engine measures after every CHECK_EVERY-th frame's step
    (when no verdict is in flight), and a repair fires at the start of
    the first frame whose ``due`` finds that measurement done: one frame
    after it at the earliest, later by as many frames as the host runs
    ahead of the device. So the disorder passes the threshold at most
    CHECK_EVERY frames plus that lead before the repair."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self._flag = torch.zeros(1, dtype=torch.bool, pin_memory=cuda)
        self._cuda = cuda
        self._event = None
        self._pending = False

    def measure(self, verdict_fn) -> bool:
        """Queue the verdict ``verdict_fn()`` (a bool tensor, made only
        here) unless one is unread. -> whether it was queued."""
        if self._pending:
            return False
        verdict = verdict_fn()
        self._flag.copy_(verdict.reshape(1), non_blocking=self._cuda)
        if self._cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(verdict.device))
        self._pending = True
        return True

    def due(self) -> bool:
        if not self._pending or (self._event is not None
                                 and not self._event.query()):
            return False
        self._pending = False
        return bool(self._flag[0])


def validate(cfg: "P.PMConfig", levels: Sequence, cfgx) -> None:
    """Raise ValueError for a window-exact ``cfgx`` (pmx.PMXConfig) the
    persistent order cannot carry: it rides the innermost class of the
    multi-level order, so it needs at least two refinement levels (a pm2
    tuple); then pmx's own rules. Nothing without ``cfgx``."""
    if cfgx is None:
        return
    if len(levels) < 2:
        raise ValueError("pmx + pm_persist needs a MULTI-level pm2 stack "
                         "(tuple): the exact window rides the innermost "
                         "class of the k+1-class persistent order")
    pmx._validate(cfg, tuple(levels), cfgx)


# -- the frame -----------------------------------------------------------------------
def accel_sorted_ref(st: SortedPMState, g_const, cfg: "P.PMConfig", *,
                     n_active=None, levels: Sequence = (), cfgx=None):
    """The plain version: acc f32[3, N] in slot order (and, with
    ``cfgx``, the pmx member count), through the plain PM path
    (pm.pm_accel_ref, pm2.pmn_accel_ref, pmx.pmx_accel on the plain
    versions) in identity order, then permuted by ``ids``."""
    n = st.pos.shape[1]
    n_active = n if n_active is None else n_active
    levels = tuple(levels)
    pos_id = unsort(st, (st.pos,))[0]
    m_id = None if st.masses is None else unsort(st, (st.masses,))[0]
    n_m = None
    if cfgx is not None:
        acc, n_m = pmx.pmx_accel(pos_id, n_active, g_const, cfg, levels,
                                 cfgx, masses=m_id, use_fast=False)
    elif levels:
        acc = pm2.pmn_accel_ref(pos_id, n_active, g_const, cfg, levels,
                                masses=m_id)
    else:
        acc = pm.pm_accel_ref(pos_id, n_active, g_const, cfg.softening, cfg,
                              masses=m_id)
    acc = acc.index_select(1, st.ids.long())
    return acc if cfgx is None else (acc, n_m)


def _repaired(st, cfg, cfg2, cfgx, n_active, repair, use_fast,
              coll) -> tuple:
    """(state', n_active, levels): ``st`` checked with ``cfg2`` (None, one
    level, or a tuple on the k+1-class order) and ``cfgx``, and re-sorted
    first when a repair fires."""
    if isinstance(cfg2, tuple):
        levels = pm2._validate_levels(cfg, cfg2)
        k = len(levels)
        if st.fine_b is None or st.fine_b.shape != (k,):
            raise ValueError(f"multi-level persistent mode needs fine_b "
                             f"int32[{k}] (init via init_sorted_multi)")
    else:
        levels = pm2.as_levels(cfg2)
    validate(cfg, levels, cfgx)
    n = st.pos.shape[1]
    _check_config(cfg, n)
    if coll is not None and not use_fast:
        raise ValueError("the sharded persistent PM runs the kernels' "
                         "wrappers (use_fast=True)")
    n_active = n if n_active is None else n_active
    # the verdict and the repair are this rank's alone (keys from its own
    # window origins): they call no collective, so the ranks' collectives
    # stay in step whichever of them repair
    if repair is None:
        repair = bool(needs_repair(st, n_active, cfg, levels,
                                   use_kernels=use_fast))
    if repair:
        st = repair_state(st, n_active, cfg, levels, use_kernels=use_fast)
    return st, n_active, levels


def _accel_raw(st, n_active, live, cfg, levels, cfgx, coll) -> tuple:
    """(acc, pmx member count or None): the kernels' raw field in slot
    order, before the momentum clean and the G scale."""
    kw = dict(masses=st.masses, live=live, coll=coll)
    if cfgx is not None:
        return pmx.pmx_accel_raw(st.pos, n_active, cfg, levels, cfgx, **kw)
    if levels:
        return pm2.pmn_accel_raw(st.pos, n_active, cfg, levels,
                                 **kw)[0], None
    # sorted by this deposit's own lower cells (cell_keys)
    return pm_cuda.accel_raw(st.pos, n_active, cfg, cell_sorted=True,
                             **kw)[0], None


def _accel(st, g_const, cfg, cfg2, cfgx, n_active, repair, use_fast, coll):
    st, n_active, levels = _repaired(st, cfg, cfg2, cfgx, n_active, repair,
                                     use_fast, coll)
    if not use_fast:
        out = accel_sorted_ref(st, g_const, cfg, n_active=n_active,
                               levels=levels, cfgx=cfgx)
        return (st,) + (out if cfgx is not None else (out,))
    live = st.ids < n_active
    acc, n_m = _accel_raw(st, n_active, live, cfg, levels, cfgx, coll)
    acc = pm_cuda.clean_and_scale(acc, n_active, g_const, masses=st.masses,
                                  live=live, coll=coll)
    return (st, acc) if cfgx is None else (st, acc, n_m)


def accel_sorted(st: SortedPMState, g_const, cfg: "P.PMConfig", *,
                 n_active=None, cfg2=None, repair: Optional[bool] = None,
                 use_fast: bool = True, coll=None
                 ) -> Tuple[SortedPMState, torch.Tensor]:
    """(state', acc f32[3, N]): the PM acceleration in the slot order of
    state' (``st`` re-sorted first when a repair fires, else ``st``).

    ``cfg2``: one refinement level (a pm2.PM2Config; the JAX package's
    two-level segmented order). ``repair``: True or False forces it;
    None decides from the disorder, reading one device scalar.
    ``use_fast``: the kernels' wrappers (their plain versions on CPU
    tensors) and the radix sort; else the plain path
    (:func:`accel_sorted_ref`, radix_sort_ref). ``coll``
    (parallel.mesh.Collectives, with ``use_fast``): ``st`` is this rank's
    shard (global ``ids``, global ``n_active``); the grids, origins and
    the momentum clean are global, the repair this rank's own."""
    return _accel(st, g_const, cfg, cfg2, None, n_active, repair, use_fast,
                  coll)


def accel_sorted_multi(st: SortedPMState, g_const, cfg: "P.PMConfig",
                       levels, *, n_active=None, cfgx=None,
                       repair: Optional[bool] = None, use_fast: bool = True,
                       coll=None):
    """(state', acc) with a tuple of refinement levels (outermost first)
    on the k+1-class order; ``st.fine_b`` must be int32[k]
    (:func:`init_sorted_multi`). ``cfgx`` (a pmx.PMXConfig) adds the
    window-exact correction, ops/pmx.py unchanged on the sorted planes,
    and a third output: its member count (a device int32; with ``coll``
    int32[2], members and corrected, pmx.exact_accel). Other arguments as
    in :func:`accel_sorted`."""
    return _accel(st, g_const, cfg, tuple(levels), cfgx, n_active, repair,
                  use_fast, coll)


def step_sorted(st: SortedPMState, param_vec: torch.Tensor,
                pair_vec: torch.Tensor, n_active, cfg: "P.PMConfig", *,
                cfg2=None, cfgx=None, repair: Optional[bool] = None,
                use_fast: bool = True, coll=None):
    """One frame on the persistent state: the PM acceleration (repairing
    first when ``repair`` says so; one level with a single ``cfg2``, the
    multi-level order with a tuple, optionally ended by ``cfgx``), then
    the kick and the attractor step in slot order: with ``use_fast``, in
    place, with no level and no ``cfgx`` pm_cuda.step_pm_planes (on CUDA
    the mean from the grids and the kicked gather), else the raw field
    through pm_cuda.momentum_mean and pm_cuda.clean_kick_and_step;
    without ``use_fast`` the plain physics.kick_and_step_planes. ->
    state', or (state', pmx member count) with ``cfgx``. ``coll``: one
    rank's shard of the mesh (:func:`accel_sorted`)."""
    st, n_active, levels = _repaired(st, cfg, cfg2, cfgx, n_active, repair,
                                     use_fast, coll)
    planes = (3, -1, LANE)
    pos, vel = st.pos.view(planes), st.vel.view(planes)
    if use_fast and not levels and cfgx is None:
        # sorted by this deposit's own lower cells (cell_keys)
        pm_cuda.step_pm_planes(pos, vel, param_vec, pair_vec[0], n_active,
                               cfg, masses=st.masses, live=st.ids < n_active,
                               coll=coll, cell_sorted=True)
        n_m = None
    elif use_fast:
        live = st.ids < n_active
        acc, n_m = _accel_raw(st, n_active, live, cfg, levels, cfgx, coll)
        mean = pm_cuda.momentum_mean(acc, n_active, masses=st.masses,
                                     live=live, coll=coll)
        pm_cuda.clean_kick_and_step(pos, vel, acc, param_vec, mean,
                                    n_active, pair_vec[0], live=live)
    else:
        out = accel_sorted_ref(st, pair_vec[0], cfg, n_active=n_active,
                               levels=levels, cfgx=cfgx)
        acc, n_m = out if cfgx is not None else (out, None)
        with trace.span("pm.kick", device=pos.is_cuda):
            pos, vel = physics.kick_and_step_planes(pos, vel,
                                                    acc.reshape(pos.shape),
                                                    param_vec)
        st = st._replace(pos=pos.reshape(3, -1), vel=vel.reshape(3, -1))
    return st if cfgx is None else (st, n_m)
