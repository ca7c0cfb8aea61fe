"""Headless point rasterizer: projection, shading, and the scatter oracle.

Counterpart of ``particle_sim_tpu/render/raster.py``. Semantics:

  * vertex: ``clip = view_proj @ [pos, 1]``; a point is drawn when
    -w <= x, y <= w, 0 <= z <= w and w > 0
  * fragment: ``rgb * min(2|v|, 1)`` brightness
  * one pixel per particle, no depth buffer
  * blend: commutative premultiplied additive accumulation clamped to 1,
    so the frame does not depend on the order of the points

:func:`render` is the plain scatter version (``index_put_`` with
accumulation) that every faster renderer is held to.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import params as P
from ..ops import physics


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


def to_rgba8(fb: torch.Tensor) -> torch.Tensor:
    """f32[H,W,3] -> u8[H,W,4] (alpha 255)."""
    rgb8 = (torch.clamp(fb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    alpha = torch.full(fb.shape[:2] + (1,), 255, dtype=torch.uint8,
                       device=fb.device)
    return torch.cat([rgb8, alpha], dim=-1)
