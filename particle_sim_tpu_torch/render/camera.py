"""Free-fly yaw/pitch camera (host-side numpy).

Counterpart of ``particle_sim_tpu/render/camera.py``, the same code: the
camera is O(1) per frame and only its ``view_proj()`` matrix goes to the
device, so ``view_proj()`` is equal to the JAX package's.

  * state & defaults: position (0,0,100), yaw -pi/2, pitch 0, up +Y,
    fov pi/3, near 0.1, far 1000, move speed 50/s, rotation 0.003 rad/px
  * forward = (cos yaw cos pitch, sin pitch, sin yaw cos pitch) normalized
  * view = look_at_rh(pos, pos+forward, right x forward);
    proj = perspective_rh with [0,1] depth
  * WASD/Space/Shift movement, mouse rotation with pitch clamped to
    +-(pi/2 - 0.01)
  * cursor unprojection onto the camera-facing plane through the current
    cursor depth, and scroll-wheel depth adjustment along forward
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_PI = float(np.pi)


def look_at_rh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed look-at view matrix (row-vector-on-right convention)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[0, 3] = s, -np.dot(s, eye)
    m[1, :3], m[1, 3] = u, -np.dot(u, eye)
    m[2, :3], m[2, 3] = -f, np.dot(f, eye)
    return m


def perspective_rh(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Right-handed perspective with wgpu/glam [0,1] depth range."""
    f = 1.0 / np.tan(fov_y / 2.0)
    r = far / (near - far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = r
    m[2, 3] = r * near
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 100.0]))
    yaw: float = -_PI / 2.0
    pitch: float = 0.0
    fov: float = _PI / 3.0
    aspect: float = 16.0 / 9.0
    near: float = 0.1
    far: float = 1000.0
    movement_speed: float = 50.0
    rotation_speed: float = 0.003

    # -- basis ---------------------------------------------------------------
    def forward(self) -> np.ndarray:
        f = np.array([
            np.cos(self.yaw) * np.cos(self.pitch),
            np.sin(self.pitch),
            np.sin(self.yaw) * np.cos(self.pitch),
        ])
        return f / np.linalg.norm(f)

    def right(self) -> np.ndarray:
        r = np.cross(self.forward(), [0.0, 1.0, 0.0])
        return r / np.linalg.norm(r)

    def up(self) -> np.ndarray:
        return np.cross(self.right(), self.forward())

    # -- matrices ------------------------------------------------------------
    def view_proj(self) -> np.ndarray:
        """float32[4,4] — proj @ view."""
        view = look_at_rh(self.position, self.position + self.forward(),
                          self.up())
        proj = perspective_rh(self.fov, self.aspect, self.near, self.far)
        return (proj @ view).astype(np.float32)

    def uniform(self) -> np.ndarray:
        """float32[20]: flattened view_proj + (pos, 1)."""
        return np.concatenate([
            self.view_proj().ravel(),
            np.array([*self.position, 1.0], dtype=np.float32),
        ]).astype(np.float32)

    # -- input ---------------------------------------------------------------
    def process_keyboard(self, keys: set, shift_down: bool, dt: float) -> bool:
        """keys: subset of {'w','a','s','d','space'}."""
        moved = False
        speed = self.movement_speed * dt
        fwd, rgt = self.forward(), self.right()
        up = np.array([0.0, 1.0, 0.0])
        if "w" in keys:
            self.position = self.position + fwd * speed; moved = True
        if "s" in keys:
            self.position = self.position - fwd * speed; moved = True
        if "a" in keys:
            self.position = self.position - rgt * speed; moved = True
        if "d" in keys:
            self.position = self.position + rgt * speed; moved = True
        if "space" in keys:
            self.position = self.position + up * speed; moved = True
        if shift_down:
            self.position = self.position - up * speed; moved = True
        return moved

    def process_mouse_movement(self, dx: float, dy: float) -> None:
        self.yaw += dx * self.rotation_speed
        self.pitch = float(np.clip(
            self.pitch - dy * self.rotation_speed,
            -_PI / 2.0 + 0.01, _PI / 2.0 - 0.01))

    # -- cursor interaction ---------------------------------------------------
    def unproject_cursor(
        self, screen_xy: Tuple[float, float], screen_wh: Tuple[float, float],
        current_world_pos: np.ndarray,
    ) -> np.ndarray:
        """Screen cursor -> world point on the camera-facing plane through
        the current cursor depth."""
        x, y = screen_xy
        w, h = screen_wh
        ndc_x = 2.0 * x / w - 1.0
        ndc_y = 1.0 - 2.0 * y / h
        fwd, rgt, up = self.forward(), self.right(), self.up()
        distance = np.dot(np.asarray(current_world_pos) - self.position, fwd)
        plane_center = self.position + fwd * distance
        height = 2.0 * distance * np.tan(self.fov / 2.0)
        width = height * self.aspect
        return (plane_center + rgt * (ndc_x * width / 2.0)
                + up * (ndc_y * height / 2.0))

    def scroll_cursor_depth(self, current_world_pos: np.ndarray,
                            scroll_delta_y: float) -> np.ndarray:
        """Move the cursor point along forward, 0.2/notch."""
        return np.asarray(current_world_pos) + self.forward() * (
            scroll_delta_y * 0.2)
