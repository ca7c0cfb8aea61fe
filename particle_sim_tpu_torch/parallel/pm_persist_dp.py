"""The persistent cell-sorted PM over the mesh.

Counterpart of ``particle_sim_tpu/parallel/pm_persist_dp.py``: the
communication of parallel/pm_dp.py (the shards couple only through the
all-reduced grids; the solve runs on every rank; the gathers are local)
with the sort-free frames of ops/pm_persist.py. Each rank keeps ITS OWN
cell-sorted ``SortedPMState`` of its rows, with the GLOBAL identity in
``ids`` (``base + arange``, base = rank * local_n), so ``ids <
n_active`` masks correctly on every rank with the global count.
Particles never move between ranks: the order is a property of each
shard, and a repair (its verdict, its keys from the rank's own window
origins, its sort) runs per rank and calls no collective, so the ranks'
collectives stay in the same order whether or not a shard repairs. Per
frame the collectives are the all-reduce of each grid (the coarse one
and one a refinement level), of the tracked window origins and of the
momentum clean; with the window-exact correction (``cfgx``) each rank
also puts capacity/n_dev slots of its members into one all_gather'd
source buffer, and the member counts are summed.

Rules, as in the JAX package: on a mesh the window-exact correction
needs a tuple ``cfg2`` (the multi-level order), and its capacity must be
a multiple of 512 * n_dev; each shard's capacity must be a multiple of
512.
"""

from __future__ import annotations

from ..core import params as Pm
from ..ops import pm2, pm_persist
from .mesh import Collectives


def _levels(cfg2) -> tuple:
    return pm2.as_levels(cfg2)


def check_pmx(cfgx, cfg2, n_dev: int) -> None:
    """Raise ValueError for a window-exact ``cfgx`` the mesh cannot
    carry."""
    if cfgx is None:
        return
    if not isinstance(cfg2, tuple):
        raise ValueError("multi-chip pmx rides the MULTI-level class "
                         "order: pass a tuple cfg2")
    if cfgx.capacity % (512 * n_dev):
        raise ValueError(f"pmx capacity {cfgx.capacity} must be a multiple "
                         f"of 512 * {n_dev} mesh devices")


def make_persist_init(mesh, cfg: "Pm.PMConfig", *, cfg2=None):
    """-> fn(pos f32[3, local_n], vel, n_active, masses=None, col24=None)
    -> this rank's SortedPMState: its rows (a prefix of live slots)
    sorted by coarse cell, or with ``cfg2`` into the class order
    (``fine_b`` int32[k] for a tuple), ids = rank * local_n + arange.
    ``n_active`` is the GLOBAL count. The sort runs on the radix
    kernels (their plain version on CPU tensors)."""
    coll = Collectives(mesh)
    levels = _levels(cfg2)

    def init(pos_flat, vel_flat, n_active, masses=None, col24=None):
        kw = dict(vel_flat=vel_flat, masses=masses, col24=col24,
                  id_base=coll.rank * pos_flat.shape[1])
        if isinstance(cfg2, tuple):
            return pm_persist.init_sorted_multi(pos_flat, n_active, cfg,
                                                levels, **kw)
        return pm_persist.init_sorted(pos_flat, n_active, cfg, cfg2=cfg2,
                                      **kw)

    return init


def make_persist_pm_step(mesh, cfg: "Pm.PMConfig", *, cfg2=None,
                         cfgx=None):
    """-> fn(st, param_vec, pair_vec, n_active, repair=None) -> st', or
    (st', int32[2] (n_members, n_corrected) over all ranks) with
    ``cfgx``: one persistent-PM frame of this rank's shard (the kernels'
    wrappers, their plain versions on CPU tensors), kicked in place.
    ``repair``: as pm_persist.step_sorted, decided per rank (every
    repair is the full sort, as on one device)."""
    coll = Collectives(mesh)
    check_pmx(cfgx, cfg2, coll.size)

    def step(st, param_vec, pair_vec, n_active, repair=None):
        return pm_persist.step_sorted(st, param_vec, pair_vec, n_active, cfg,
                                      cfg2=cfg2, cfgx=cfgx, repair=repair,
                                      use_fast=True, coll=coll)

    return step


def identity_order(mesh, st: "pm_persist.SortedPMState", arrays) -> tuple:
    """``arrays`` (each (..., local_n) in this rank's slot order) in the
    identity order of its rows (pm_persist.unsort with the rank's ids made
    local)."""
    base = Collectives(mesh).rank * st.pos.shape[1]
    local = st if base == 0 else st._replace(ids=st.ids - base)
    return pm_persist.unsort(local, arrays)
