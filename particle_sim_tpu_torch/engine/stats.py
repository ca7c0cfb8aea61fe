"""Frame statistics — FPS windows and EMA update time.

Counterpart of ``particle_sim_tpu/engine/stats.py``: FPS counted over
>=1 s windows and an EMA-smoothed (alpha=0.1) update time in ms.
``update_ms`` is the host-side dispatch of a step: ``Engine.step`` times
it once, with the ``engine.step`` span's clock reads when tracing is on
(utils/trace.py), else with ``time.perf_counter``. ``device_ms`` is the
step's device time: from ``Engine.step_synced`` (host time to a device
sync), or, when tracing is on, from the ``engine.step`` span's CUDA
events as they are read (:meth:`FrameStats.record_device`).
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
            self.record_device(ms)
        else:
            self.update_ms = (1 - EMA_ALPHA) * self.update_ms + EMA_ALPHA * ms
        self.steps_total += 1

    def record_device(self, ms: float) -> None:
        """Fold a step's device milliseconds into ``device_ms`` (the
        step itself was counted by record_update)."""
        self.device_ms = (1 - EMA_ALPHA) * self.device_ms + EMA_ALPHA * ms

    def snapshot(self) -> dict:
        return {
            "fps": round(self.fps, 1),
            "update_ms": round(self.update_ms, 4),
            "device_ms": round(self.device_ms, 4),
            "steps_total": self.steps_total,
        }
