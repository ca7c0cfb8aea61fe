"""Sorted-deposit rasterizer, on a hand-written CUDA kernel.

Counterpart of ``particle_sim_tpu/render/raster_sorted.py``; same frame as
raster.render (additive premultiplied blend, clamped to 1). The pipeline,
in plain PyTorch around one kernel of csrc/raster_sorted.cu:

  1. shade and project every point: key = tile * 1024 + pixel inside the
     8x128 framebuffer tile, or the sentinel n_tiles * 1024 for a point
     that draws nothing, and the premultiplied payload (r*w, g*w, b*w)
     (:func:`raster.tile_keys`, shared with raster_compact);
  2. sort the points by key, their colours with them, in one call of
     the port's sort (``ops/psort.sort``: the radix kernels on the card),
     as the JAX function's one ``lax.sort`` of (key, r, g, b);
  3. the per-tile table: one ``torch.searchsorted`` of the tile starts
     gives every tile its slice [offsets[t], offsets[t+1]) of the sorted
     points (the TPU's chunk table maps grid steps to 512-point chunks
     instead, because its kernel can only read aligned blocks);
  4. the **deposit kernel** (:func:`deposit`) sums the points into their
     8x128 tiles. Its work is split by points, not by tiles: warps stride
     over the live points [offsets[0], offsets[n_tiles]) in groups of 128,
     sum each pixel's run of points in registers and shuffles, and add it
     once to the frame, which the launch zeroes first.

:func:`deposit` takes its plain version (:func:`deposit_plain`) for CPU
tensors, and on CUDA tensors launches the kernel or raises.
``render(..., plain=True)`` runs the pipeline on the plain version on any
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import psort
from ..utils import cuda_build
from .raster import (
    PX_PER_TILE, TILE_H, TILE_W, TileKeys, tile_keys, tiles_to_frame,
)

#: Kernel launches made by :func:`deposit` in this process.
LAUNCHES = 0


class SortedPoints(NamedTuple):
    """Inputs of the deposit kernel."""

    key: torch.Tensor        # int32[n], ascending
    rgb: torch.Tensor        # f32[3, n] payload planes in key order
    offsets: torch.Tensor    # int32[n_tiles + 1]
    n_tiles: int


def sort_points(keys: TileKeys) -> SortedPoints:
    """Sort the points by key (stable), with their colours, and find
    every tile's slice."""
    key_s = torch.empty_like(keys.key)
    rgb_s = torch.empty((3, keys.key.shape[0]), dtype=torch.float32,
                        device=key_s.device)
    psort.sort((keys.key, keys.r, keys.g, keys.b), out=(key_s, *rgb_s))
    probes = torch.arange(0, keys.n_tiles + 1, dtype=torch.int32,
                          device=key_s.device) * PX_PER_TILE
    offsets = torch.searchsorted(key_s, probes, out_int32=True)
    return SortedPoints(key_s, rgb_s, offsets, keys.n_tiles)


def deposit_plain(key, rgb, offsets, *, n_tiles: int) -> torch.Tensor:
    """Plain version of the deposit kernel -> f32[n_tiles, 3, 8, 128].

    Every point whose key lies in a tile adds its payload there. The tile
    is read from the key, and every point is visited (the kernel visits
    only the live points [offsets[0], offsets[n_tiles]), so a wrong
    offset there shows as a mismatch)."""
    del offsets
    live = (key >= 0) & (key < n_tiles * PX_PER_TILE)
    k = torch.where(live, key, 0)
    pix = ((k >> 10) * (3 * PX_PER_TILE) + (k & (PX_PER_TILE - 1))).long()
    out = torch.zeros((n_tiles * 3 * PX_PER_TILE,), dtype=torch.float32,
                      device=key.device)
    w = live.to(torch.float32)
    for c in range(3):
        out.index_add_(0, pix + c * PX_PER_TILE, rgb[c] * w)
    return out.view(n_tiles, 3, TILE_H, TILE_W)


def deposit(key, rgb, offsets, *, n_tiles: int) -> torch.Tensor:
    """Sum the sorted points into their tiles (the kernel). key: int32[n]
    sorted; rgb: f32[3, n]; offsets: int32[n_tiles + 1], the live points
    are [offsets[0], offsets[n_tiles]). -> f32[n_tiles, 3, 8, 128]."""
    global LAUNCHES
    n = key.shape[0]
    dev = key.device
    for name, t, dtype, shape in (
            ("key", key, torch.int32, (n,)),
            ("rgb", rgb, torch.float32, (3, n)),
            ("offsets", offsets, torch.int32, (n_tiles + 1,))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_tiles < 1 or 3 * n >= 2 ** 31:
        raise ValueError(f"n_tiles={n_tiles}, n={n}: need n_tiles >= 1 and "
                         "3n < 2^31")
    if dev.type == "cpu":
        return deposit_plain(key, rgb, offsets, n_tiles=n_tiles)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((n_tiles, 3, TILE_H, TILE_W), dtype=torch.float32,
                      device=dev)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.psim_sorted_deposit(key.data_ptr(), rgb.data_ptr(),
                                      offsets.data_ptr(), out.data_ptr(), n,
                                      n_tiles, stream)
    LAUNCHES += 1
    cuda_build.check(err, "sorted deposit")
    return out


def render(
    pos: torch.Tensor, vel: torch.Tensor, init_color: torch.Tensor,
    param_vec: torch.Tensor, view_proj: torch.Tensor, n_active: torch.Tensor,
    *, width: int = 1920, height: int = 1080, plain: bool = False,
) -> torch.Tensor:
    """f32[height, width, 3] framebuffer in [0, 1].

    Same semantics as raster.render; width/height must be multiples of
    128/8. ``plain=True`` runs the plain version of the deposit.
    """
    sp = sort_points(tile_keys(pos, vel, init_color, param_vec, view_proj,
                               n_active, width=width, height=height))
    do_deposit = deposit_plain if plain else deposit
    tiles = do_deposit(sp.key, sp.rgb, sp.offsets, n_tiles=sp.n_tiles)
    return tiles_to_frame(tiles, width, height)
