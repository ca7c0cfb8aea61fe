"""Rendering over the mesh: each rank draws its shard, one all-reduce of
the tile planes composites the frame.

Counterpart of ``particle_sim_tpu/parallel/render_dp.py``. The additive
premultiplied blend is commutative (render/raster.py), so partial frames
compose by summation: each rank renders ITS rows with the compact
renderer's compaction and deposit kernels (render/raster_compact.py,
csrc/raster_compact.cu), unclipped, and one all-reduce of the f32 tile
planes (24 MB at 1920x1080, independent of N) sums them. Only then does
``raster.tiles_to_frame`` clamp to [0, 1]: clipping a shard's frame
first would darken any pixel whose brightness is split across shards.

Rows are sharded contiguously and each shard's live particles are a
prefix of its storage (in identity order and in the persistent slot
order alike, parallel/pm_persist_dp.py), so rank k draws its first
``clip(n_active - k * local_n, 0, local_n)`` slots.
"""

from __future__ import annotations

import torch

from ..core.state import LANE
from ..render import raster, raster_compact
from .mesh import Collectives


def make_render_dp(mesh, *, width: int, height: int, flat: bool = False):
    """-> fn(pos, vel, col, param_vec, view_proj, n_active) -> f32[height,
    width, 3], the same frame on every rank. ``flat=False``: this rank's
    (3, R/n_dev, LANE) identity-order planes; ``flat=True``: its (3,
    local_n) planes of the persistent carry, so the persistent path
    renders without rebuilding the identity order. ``n_active``: the
    GLOBAL count."""
    coll = Collectives(mesh)

    def render(pos, vel, col, param_vec, view_proj, n_active):
        planes = [t.view(3, -1, LANE) if flat else t for t in (pos, vel, col)]
        local_n = planes[0].shape[1] * LANE
        n_loc = torch.clamp(torch.as_tensor(n_active, device=pos.device)
                            - coll.rank * local_n, 0, local_n)
        words = raster_compact.point_words(*planes, param_vec, view_proj,
                                           n_loc, width=width, height=height)
        tiles = coll.sum_(raster_compact.render_tiles(words))
        return raster.tiles_to_frame(tiles, width, height)

    return render
