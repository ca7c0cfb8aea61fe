"""Exact short-range forces in a tracked window — the P3M-style real-space
correction, bounded by the window instead of a screening length.

Counterpart of ``particle_sim_tpu/ops/pmx.py``, with the same functions,
names and argument order. For member pairs (both ends inside the window's
margin-shrunk mask) the correction adds

    da_ij = [g(r_ij; eps_exact) - g(r_ij; eps_prev)] m_j r_ij

where ``eps_prev`` is the softening the pair already feels from the mesh
stack (the innermost pm2 level's, or the coarse PM's). Summed with the
mesh field, member pairs feel the exact ``eps_exact``-softened force; the
correction is antisymmetric over members (momentum-exact).

``exact_accel`` on the card:

  1. ``psort.sort((flag, idx))``: the radix kernels (csrc/radix_sort.cu)
     sort an int32 0/1 flag, members first, carrying the slot index;
     one digit pass is taken, the others are skipped. The sort is stable,
     so members past ``capacity`` are the ones later in slot order; they
     keep the mesh force, and the returned member count lets callers warn.
  2. ``index_select`` of the first ``capacity`` slots' positions (and
     masses) into a compact buffer.
  3. One difference pass of the pairwise kernel (csrc/pairwise.cu,
     ``pairwise_cuda.pairwise_accel_diff``) over the buffer with the
     in-budget masses: g(eps_exact) - g(eps_prev) a pair, r^2 once. The
     in-budget member count ``min(n_members, B)`` goes to the kernel as
     both live counts, on the device: receivers past it get 0 and the
     sweep ends at the last tile holding a member (on a mesh the sources
     are the gathered buffers, members not contiguous, so the sweep
     covers their whole width).
  4. One ``index_copy_`` of the buffer's corrections into a zeroed
     f32[3, N] at the sorted indices (the JAX un-sort by a second sort is
     a TPU workaround; a scatter of a permutation is exact).

On CUDA the window's origin, its member mask and their count come from
the levels' window pass (``pm2.window_pass``: one launch more than the
levels', csrc/windows.cu), which ``pm2.pmn_accel_raw`` runs for
``pmx_accel_raw`` (without levels ``pmx_accel_raw`` runs it alone); on
CPU tensors from :func:`window_origin` and the mask. The correction
joins the mesh stack's raw field (``pmx_accel_raw``), cleaned once
(ops/pm_cuda.py); the member count stays on the device. Traced
(utils/trace.py): the window pass without levels, the plain origin and
mask, the flag sort and the compaction (step 2) in span
``pmx.members``, the difference pass in ``pmx.diff``, the scatter in a
second ``pmx.members``; the counters ``pmx.members`` and
``pmx.member_pairs`` sum the in-budget members and the pairs the pass
covers, on the device.
With ``use_kernels=False`` the same
steps run on the plain versions (``psort.radix_sort_ref``,
``pairwise.pairwise_accel_diff``, the two plain passes subtracted); on
CPU tensors the wrappers take them anyway. ``exact_accel_ref`` is the
O(N^2) oracle of small tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core import params as P
from ..utils import trace
from . import pairwise, pairwise_cuda, physics, pm, pm2, pm_cuda, psort


@dataclass(frozen=True)
class PMXConfig:
    """Exact-force window (the JAX package's fields and checks).

    window_size: window extent per axis (world units); meant for the
                 densest core, nested inside the innermost mesh level.
    softening:   eps_exact > 0, < the innermost mesh softening.
    capacity:    member budget B of the all-pairs buffer (a multiple of
                 512).
    margin:      shrink of the member mask inside the window.
    window_min:  static origin, or None to track the parent level's
                 member centroid (pm2._nested_wmins semantics).
    park:        carried for attribute parity with PM2Config.
    """
    window_size: float
    softening: float
    capacity: int = 65536
    margin: float = 0.0
    window_min: Optional[Tuple[float, float, float]] = None
    park: float = 1.0

    def __post_init__(self):
        if self.capacity % 512:
            raise ValueError(
                f"pmx capacity {self.capacity} not a multiple of 512")
        if self.softening <= 0.0:
            raise ValueError("pmx needs softening > 0 (a pure 1/r^2 "
                             "force diverges at CIC-coincident points)")


def _member_mask(pos_flat, wmin, cfgx: PMXConfig, live):
    return pm2._in_window(pos_flat, wmin, cfgx.window_size,
                          cfgx.margin) & live


def exact_accel_ref(pos_flat: torch.Tensor, live: torch.Tensor,
                    cfgx: PMXConfig, eps_prev: float, *, masses=None,
                    wmin=None) -> torch.Tensor:
    """f32[3, N] window-exact correction — the plain O(N^2) oracle over all
    slots (small tests). Member pairs feel g(eps_exact) - g(eps_prev)."""
    if wmin is None:
        wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=live)
    w = _member_mask(pos_flat, wmin, cfgx, live).to(torch.float32)
    m_src = w if masses is None else w * masses
    n = pos_flat.shape[1]
    rec = pos_flat.T.contiguous()
    a_x = pairwise.pairwise_accel(rec, pos_flat, n, 1.0, cfgx.softening,
                                  masses=m_src)
    a_p = pairwise.pairwise_accel(rec, pos_flat, n, 1.0, eps_prev,
                                  masses=m_src)
    return (a_x - a_p).T * w[None]


def members_first(member: torch.Tensor, *,
                  use_kernels: bool = True) -> torch.Tensor:
    """int32[N] slot indices, members first, each group in slot order: the
    stable sort of the int32 flag (0 member, 1 not) carrying the index,
    through psort.sort (the radix kernels on CUDA) or, with
    ``use_kernels=False``, psort.radix_sort_ref."""
    flag = (~member).to(torch.int32)
    idx = torch.arange(member.shape[0], dtype=torch.int32,
                       device=member.device)
    sort = psort.sort if use_kernels else psort.radix_sort_ref
    return sort((flag, idx))[1]


def window_origin(pos_flat: torch.Tensor, live: torch.Tensor,
                  cfgx: PMXConfig, levels=(), *, masses=None,
                  coll=None) -> torch.Tensor:
    """f32[3] origin of the exact window: the static one, or (tracked) the
    mass centroid of the innermost mesh level's members (of every live
    particle without levels) minus half the window; under levels clamped
    inside the innermost one (pm2.clamp_nested). The plain version of
    ``pm2.window_pass``'s exact origin."""
    if not levels:
        return pm2.window_min(pos_flat, None, cfgx, masses, live=live,
                              coll=coll)
    wmins = pm2._nested_wmins(pos_flat, live, None, levels, masses,
                              coll=coll)
    inner = levels[-1]
    lv_live = (pm2._in_window(pos_flat, wmins[-1], inner.window_size,
                              inner.margin) & live)
    wmin = pm2.window_min(pos_flat, None, cfgx, masses, live=lv_live,
                          coll=coll)
    return pm2.clamp_nested(wmin, wmins[-1], inner, cfgx.window_size)


def exact_accel(pos_flat: torch.Tensor, live: torch.Tensor,
                cfgx: PMXConfig, eps_prev: float, *, masses=None,
                wmin=None, levels=(), use_kernels: bool = True, coll=None,
                window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corr f32[3, N], n_members int32 0-d, on the device) — the
    compact-buffer path (module docstring). Members past the capacity get
    no correction. The members: ``window``'s (a ``pm2.window_pass`` result
    with this window as its ``exact``, on CUDA), else those of ``wmin``,
    else of :func:`window_origin` under ``levels`` (PM2Config, outermost
    first), inside the ``pmx.members`` span.

    ``coll`` (parallel.mesh.Collectives; ``pos_flat`` is this rank's
    shard): each rank puts its first capacity/n_dev members in its
    buffer, and the buffers of all ranks are gathered (one all_gather of
    positions and masses) as the sources of its receivers, so every
    cross-rank pair is summed both ways with the same values. The count
    is then int32[2]: the members and those corrected, over all ranks."""
    n = pos_flat.shape[1]
    dev = pos_flat.device
    n_sh = 1 if coll is None else coll.size
    B = min(cfgx.capacity, n * n_sh) // n_sh       # this rank's budget
    on_device = pos_flat.is_cuda
    with trace.span("pmx.members", device=on_device):
        if window is not None and window.x_member is not None:
            member, n_m = window.x_member, window.x_count
        else:
            if wmin is None:
                wmin = window_origin(pos_flat, live, cfgx, levels,
                                     masses=masses, coll=coll)
            member = _member_mask(pos_flat, wmin, cfgx, live)
            n_m = member.sum(dtype=torch.int32)
        idx_b = members_first(member, use_kernels=use_kernels)[:B].long()
        n_in = torch.clamp_max(n_m, B)                  # in budget
        in_budget = torch.arange(B, dtype=torch.int32, device=dev) < n_in
        buf = pos_flat.index_select(1, idx_b)           # f32[3, B]
        m_buf = in_budget.to(torch.float32)
        if masses is not None:
            m_buf = m_buf * masses.index_select(0, idx_b)
        src, m_src = buf, m_buf
        if coll is not None:
            src = coll.all_gather(buf, dim=1)            # f32[3, B n_dev]
            m_src = coll.all_gather(m_buf)
    diff = (pairwise_cuda.pairwise_accel_diff if use_kernels
            else pairwise.pairwise_accel_diff)
    # device constants: a Python number would be uploaded (and waited
    # for) on every call
    n_b = pm_cuda.device_const(src.shape[1], dev, torch.int32)
    one, eps_x, eps_p = pm_cuda.device_const(
        (1.0, cfgx.softening, eps_prev), dev)
    with trace.span("pmx.diff", device=on_device):
        corr_buf = diff(buf.T.contiguous(), src, n_b, one, eps_x, eps_p,
                        masses=m_src, n_i=n_in,
                        n_j=n_in if coll is None else None).T
    with trace.span("pmx.members", device=on_device):
        corr = torch.zeros((3, n), dtype=torch.float32, device=dev)
        corr.index_copy_(1, idx_b, corr_buf)
    if coll is None:
        n_out = n_m
        sources = n_in
    else:
        n_out = coll.sum_(torch.stack([n_m, torch.clamp_max(n_m, B)]))
        sources = n_out[1]                 # in budget on every rank
    if trace.on():
        k = n_in.to(torch.int64)
        trace.tally("pmx.members", k)
        trace.tally("pmx.member_pairs", k * sources)
    return corr, n_out


def _eps_prev(cfg: "P.PMConfig", levels) -> float:
    return float(levels[-1].softening) if levels else float(cfg.softening)


def _validate(cfg: "P.PMConfig", levels, cfgx: PMXConfig) -> None:
    ep = _eps_prev(cfg, levels)
    if cfgx.softening >= ep:
        raise ValueError(
            f"pmx softening {cfgx.softening} must be < the innermost "
            f"mesh softening ({ep}) for the difference split")
    parent_size = (float(levels[-1].window_size) if levels
                   else float(cfg.box_size))
    parent_margin = float(levels[-1].margin) if levels else 0.0
    if cfgx.window_size > parent_size - 2.0 * parent_margin:
        raise ValueError(
            f"pmx window {cfgx.window_size} cannot nest inside the "
            f"innermost mesh level (usable extent "
            f"{parent_size - 2.0 * parent_margin})")


def pmx_accel_raw(pos_flat: torch.Tensor, n_active, cfg: "P.PMConfig",
                  levels, cfgx: PMXConfig, *, masses=None, kernels=None,
                  use_fast: bool = True, live=None, coll=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc f32[3, N], n_members) — the full stack before its momentum
    clean and G scale: coarse PM + the pm2 refinement levels (possibly
    none) + the window-exact correction. ``levels`` is () or a tuple of
    PM2Config (outermost first). ``use_fast``: every layer on the kernels
    (their plain versions on CPU tensors), the mesh field raw
    (pm_cuda.accel_raw, pm2.pmn_accel_raw); else the plain path
    throughout, its mesh field cleaned. ``live`` (bool[N], with
    ``use_fast`` only) overrides ``arange < n_active``. ``coll``
    (parallel.mesh.Collectives, with ``use_fast``): ``pos_flat`` is this
    rank's shard, every layer is global (pm2.pmn_accel_raw, exact_accel),
    and the count is exact_accel's int32[2]."""
    levels = tuple(levels) if levels else ()
    _validate(cfg, levels, cfgx)
    if coll is not None and not use_fast:
        raise ValueError("the sharded pmx runs the kernels' wrappers "
                         "(use_fast=True)")
    if live is None:
        live = pm.live_mask(pos_flat.shape[1], n_active, pos_flat.device)
    window, exact = None, pm2.Win.of(cfgx)
    if levels:
        if use_fast:
            # on CUDA the levels' window pass also finds the exact window
            acc, window = pm2.pmn_accel_raw(pos_flat, n_active, cfg, levels,
                                            masses=masses, kernels=kernels,
                                            live=live, coll=coll, exact=exact)
        else:
            acc = pm2.pmn_accel_ref(pos_flat, n_active, 1.0, cfg, levels,
                                    masses=masses, kernels=kernels)
    elif use_fast:
        acc, _ = pm_cuda.accel_raw(pos_flat, n_active, cfg, masses=masses,
                                   live=live, coll=coll)
        if pos_flat.is_cuda:
            with trace.span("pmx.members", device=True):
                window = pm2.window_pass(pos_flat, live, (), masses=masses,
                                         exact=exact, coll=coll)
    else:
        acc = pm.pm_accel_ref(pos_flat, n_active, 1.0, cfg.softening, cfg,
                              masses=masses)
    # the exact window tracks the innermost mesh level's members
    corr, n_m = exact_accel(pos_flat, live, cfgx, _eps_prev(cfg, levels),
                            masses=masses, levels=levels,
                            use_kernels=use_fast, coll=coll, window=window)
    return acc + corr, n_m


def pmx_accel(pos_flat: torch.Tensor, n_active, g_const, cfg: "P.PMConfig",
              levels, cfgx: PMXConfig, *, masses=None, kernels=None,
              use_fast: bool = True, live=None, coll=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc f32[3, N], n_members): :func:`pmx_accel_raw`, then
    pm_cuda.clean_and_scale (a global clean with ``coll``)."""
    acc, n_m = pmx_accel_raw(pos_flat, n_active, cfg, levels, cfgx,
                             masses=masses, kernels=kernels,
                             use_fast=use_fast, live=live, coll=coll)
    return pm_cuda.clean_and_scale(acc, n_active, g_const, masses=masses,
                                   live=live, coll=coll), n_m


def step_pmx(pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
             pair_vec: torch.Tensor, n_active, cfg: "P.PMConfig", levels,
             cfgx: PMXConfig, *, masses=None, kernels=None,
             use_fast: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame: mesh stack + window-exact correction + the attractor
    step, as pm2.step_pmn (in place with ``use_fast``), plus the window's
    member count (a device int32) as a third output so the engine can
    report capacity truncation."""
    flat = pos.reshape(3, -1)
    if use_fast:
        acc, n_m = pmx_accel_raw(flat, n_active, cfg, levels, cfgx,
                                 masses=masses, kernels=kernels)
        mean = pm_cuda.momentum_mean(acc, n_active, masses=masses)
        pos, vel = pm_cuda.clean_kick_and_step(pos, vel, acc, param_vec,
                                               mean, n_active, pair_vec[0])
    else:
        acc, n_m = pmx_accel(flat, n_active, pair_vec[0], cfg, levels, cfgx,
                             masses=masses, kernels=kernels, use_fast=False)
        pos, vel = physics.kick_and_step_planes(
            pos, vel, acc.reshape(pos.shape), param_vec)
    return pos, vel, n_m
