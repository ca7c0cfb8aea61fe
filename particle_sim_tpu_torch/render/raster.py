"""Headless point rasterizer: projection, shading, and the scatter oracle.

Counterpart of ``particle_sim_tpu/render/raster.py``. Semantics:

  * vertex: ``clip = view_proj @ [pos, 1]``; a point is drawn when
    -w <= x, y <= w, 0 <= z <= w and w > 0
  * fragment: ``rgb * min(2|v|, 1)`` brightness
  * one pixel per particle, no depth buffer
  * blend: commutative premultiplied additive accumulation clamped to 1,
    so the frame does not depend on the order of the points

:func:`render` is the plain scatter version (``index_put_`` with
accumulation) that every faster renderer is held to; :func:`tile_keys`
and :func:`tiles_to_frame` are the first and last stage of the two tiled
renderers (raster_compact, raster_sorted); :func:`pack_points` packs the
point stream of the WebSocket server.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import params as P
from ..ops import physics

TILE_H, TILE_W = 8, 128         # framebuffer tile of the tiled renderers
PX_PER_TILE = TILE_H * TILE_W   # 1024


def project_to_pixels(
    pos_flat: torch.Tensor,     # f32[3, N]
    view_proj: torch.Tensor,    # f32[4, 4] on the same device
    width: int, height: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (px i32[N], py i32[N], valid f32[N])."""
    x, y, z = pos_flat[0], pos_flat[1], pos_flat[2]
    vp = view_proj
    cx = vp[0, 0] * x + vp[0, 1] * y + vp[0, 2] * z + vp[0, 3]
    cy = vp[1, 0] * x + vp[1, 1] * y + vp[1, 2] * z + vp[1, 3]
    cz = vp[2, 0] * x + vp[2, 1] * y + vp[2, 2] * z + vp[2, 3]
    cw = vp[3, 0] * x + vp[3, 1] * y + vp[3, 2] * z + vp[3, 3]

    w_ok = cw > 1e-8
    inv_w = torch.where(w_ok, 1.0 / torch.clamp_min(cw, 1e-8), 0.0)
    ndc_x = cx * inv_w
    ndc_y = cy * inv_w
    ndc_z = cz * inv_w
    valid = (
        w_ok
        & (torch.abs(ndc_x) <= 1.0)
        & (torch.abs(ndc_y) <= 1.0)
        & (ndc_z >= 0.0) & (ndc_z <= 1.0)
    )
    # float -> int truncates toward zero. The pre-clamp to [-1, size]
    # changes no result after the final clip; it keeps the cast defined
    # for far-off-screen points (out-of-range float -> int32 is undefined
    # in C++ and saturating in XLA).
    fx = torch.clamp((ndc_x + 1.0) * 0.5 * width, -1.0, float(width))
    fy = torch.clamp((1.0 - ndc_y) * 0.5 * height, -1.0, float(height))
    px = torch.clamp(fx.to(torch.int32), 0, width - 1)
    py = torch.clamp(fy.to(torch.int32), 0, height - 1)
    return px, py, valid.to(torch.float32)


def shaded_rgb(flat_pos, flat_vel, flat_col, param_vec):
    """Per-point RGB by color mode plus the fragment brightness
    min(2|v|,1). -> (r, g, b, bright), each f32[N]."""
    r, g, b = physics.color_rgb(
        flat_pos[0], flat_pos[1], flat_pos[2],
        flat_vel[0], flat_vel[1], flat_vel[2],
        flat_col[0], flat_col[1], flat_col[2],
        color_mode=param_vec[P.P_COLOR_MODE],
        max_dist_for_color=param_vec[P.P_MAX_DIST],
    )
    bright = physics.brightness(flat_vel[0], flat_vel[1], flat_vel[2])
    return r, g, b, bright


class TileKeys(NamedTuple):
    """Per-point tile keys and premultiplied colour of one frame."""

    key: torch.Tensor        # int32[n]
    r: torch.Tensor          # f32[n]: r * w (0 where nothing is drawn)
    g: torch.Tensor
    b: torch.Tensor
    n_tiles: int
    sentinel: int


def tile_keys(pos, vel, init_color, param_vec, view_proj, n_active, *,
              width: int, height: int) -> TileKeys:
    """Shade and project every point into its tile key and payload, the
    input of both tiled renderers: key = tile * 1024 + pixel inside the
    8x128 framebuffer tile, or the sentinel n_tiles * 1024 for a point
    that draws nothing; payload (r*w, g*w, b*w)."""
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"({height},{width}) not a multiple of "
                         f"({TILE_H},{TILE_W}); use raster.render")
    tiles_x, tiles_y = width // TILE_W, height // TILE_H
    n_tiles = tiles_x * tiles_y
    sentinel = n_tiles * PX_PER_TILE

    flat_pos = pos.reshape(3, -1)
    flat_vel = vel.reshape(3, -1)
    flat_col = init_color.reshape(3, -1)
    n = flat_pos.shape[1]

    r, g, b, bright = shaded_rgb(flat_pos, flat_vel, flat_col, param_vec)
    px, py, valid = project_to_pixels(flat_pos, view_proj, width, height)
    active = (torch.arange(n, dtype=torch.int32, device=pos.device)
              < n_active).to(torch.float32)
    w = valid * active * bright

    tile = (py // TILE_H) * tiles_x + (px // TILE_W)
    local = (py % TILE_H) * TILE_W + (px % TILE_W)
    key = torch.where(w > 0.0, tile * PX_PER_TILE + local, sentinel)
    return TileKeys(key.to(torch.int32), r * w, g * w, b * w, n_tiles,
                    sentinel)


def tiles_to_frame(tiles: torch.Tensor, width: int,
                   height: int) -> torch.Tensor:
    """f32[n_tiles, 3, 8, 128] tile planes -> f32[H, W, 3] clamped to 1."""
    tiles_x, tiles_y = width // TILE_W, height // TILE_H
    fb = tiles.view(tiles_y, tiles_x, 3, TILE_H, TILE_W)
    fb = fb.permute(0, 3, 1, 4, 2).reshape(height, width, 3)
    return torch.clamp(fb, 0.0, 1.0)


def render(
    pos: torch.Tensor,          # f32[3, R, LANE]
    vel: torch.Tensor,
    init_color: torch.Tensor,
    param_vec: torch.Tensor,
    view_proj: torch.Tensor,    # f32[4, 4]
    n_active: torch.Tensor,     # 0-d i32
    *,
    width: int = 1920,
    height: int = 1080,
) -> torch.Tensor:
    """f32[height, width, 3] framebuffer in [0, 1]."""
    flat_pos = pos.reshape(3, -1)
    flat_vel = vel.reshape(3, -1)
    flat_col = init_color.reshape(3, -1)
    n = flat_pos.shape[1]

    r, g, b, bright = shaded_rgb(flat_pos, flat_vel, flat_col, param_vec)
    px, py, valid = project_to_pixels(flat_pos, view_proj, width, height)
    active = (torch.arange(n, dtype=torch.int32, device=pos.device)
              < n_active).to(torch.float32)
    weight = valid * active  # alpha is 1.0 throughout

    rgb = torch.stack([r, g, b], dim=1) * (bright * weight)[:, None]  # [N, 3]
    fb = torch.zeros((height, width, 3), dtype=torch.float32,
                     device=pos.device)
    fb.index_put_((py.long(), px.long()), rgb, accumulate=True)
    return torch.clamp(fb, 0.0, 1.0)


def pack_points(pos, vel, init_color, param_vec, n_stop, stride: int = 1):
    """Stream packing on the state's device -> (pos f32[3, m],
    rgba8 u8[m, 4]) for every ``stride``-th slot of the capacity.

    rgb is premultiplied by the fragment brightness min(2|v|, 1);
    inactive slots (index >= ``n_stop``) get rgb 0 and alpha 0, which
    clients discard. The subsample is taken on the device, so only it
    crosses to the host."""
    flat_pos = pos.reshape(3, -1)[:, ::stride]
    flat_vel = vel.reshape(3, -1)[:, ::stride]
    flat_col = init_color.reshape(3, -1)[:, ::stride]
    n = flat_pos.shape[1]
    r, g, b, bright = shaded_rgb(flat_pos, flat_vel, flat_col, param_vec)
    active = (torch.arange(n, dtype=torch.int32, device=pos.device)
              * stride) < n_stop
    af = active.to(torch.float32)
    rgb = torch.stack([r, g, b]) * (bright * af)
    rgba = torch.cat([rgb, af[None, :]], dim=0).T            # [n, 4]
    rgba8 = (torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return flat_pos, rgba8


def pack_col24(col_flat: torch.Tensor) -> torch.Tensor:
    """f32[3, N] in [0, 1] -> i32[N] 8:8:8-packed display colour, the
    codec of pm_persist.SortedPMState.col24 (u8 a channel, the wire
    format's rgba8 quantization); bit for bit the JAX package's."""
    c8 = (torch.clamp(col_flat, 0.0, 1.0) * 255.0 + 0.5).to(torch.int32)
    return c8[0] | (c8[1] << 8) | (c8[2] << 16)


def unpack_col24(col24: torch.Tensor) -> torch.Tensor:
    """i32[N] packed display colour -> f32[3, N] in [0, 1]."""
    return torch.stack([(col24 >> s) & 0xFF for s in (0, 8, 16)]).to(
        torch.float32) / 255.0


def to_rgba8(fb: torch.Tensor) -> torch.Tensor:
    """f32[H,W,3] -> u8[H,W,4] (alpha 255)."""
    rgb8 = (torch.clamp(fb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    alpha = torch.full(fb.shape[:2] + (1,), 255, dtype=torch.uint8,
                       device=fb.device)
    return torch.cat([rgb8, alpha], dim=-1)
