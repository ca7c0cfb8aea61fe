"""Frame statistics — FPS windows and EMA update time.

Counterpart of ``particle_sim_tpu/engine/stats.py``, unchanged: FPS counted
over >=1 s windows and an EMA-smoothed (alpha=0.1) update time in ms.
``update_ms`` measures the host-side dispatch of a step; ``device_ms`` is
populated when the engine is asked to time a step with a device sync.
"""

from __future__ import annotations

import dataclasses
import time


EMA_ALPHA = 0.1


@dataclasses.dataclass
class FrameStats:
    fps: float = 0.0
    update_ms: float = 0.0        # EMA of host-side dispatch
    device_ms: float = 0.0        # EMA of synced device step time
    steps_total: int = 0
    _fps_counter: int = 0
    _fps_timer: float = 0.0
    _last: float = dataclasses.field(default_factory=time.perf_counter)

    def frame_tick(self) -> float:
        """Call once per frame; returns wall dt seconds."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._fps_counter += 1
        self._fps_timer += dt
        if self._fps_timer >= 1.0:
            self.fps = self._fps_counter / self._fps_timer
            self._fps_counter = 0
            self._fps_timer = 0.0
        return dt

    def record_update(self, seconds: float, *, device: bool = False) -> None:
        ms = seconds * 1e3
        if device:
            self.device_ms = (1 - EMA_ALPHA) * self.device_ms + EMA_ALPHA * ms
        else:
            self.update_ms = (1 - EMA_ALPHA) * self.update_ms + EMA_ALPHA * ms
        self.steps_total += 1

    def snapshot(self) -> dict:
        return {
            "fps": round(self.fps, 1),
            "update_ms": round(self.update_ms, 4),
            "device_ms": round(self.device_ms, 4),
            "steps_total": self.steps_total,
        }
