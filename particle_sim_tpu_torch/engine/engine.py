"""Engine — the headless application layer: the attractor, optionally
with direct-sum self-gravity.

Counterpart of ``particle_sim_tpu/engine/engine.py`` for the attractor and
the all-pairs gravity solver (``pairwise``, with per-particle source
``masses``). Lifecycle, as there:

  * **method selection**: ``Method.CUDA`` (the hand-written step kernel)
    needs a CUDA device; ``Method.TORCH`` (plain PyTorch) runs on any
    device. Default counts 100k (TORCH) / 1M (CUDA).
  * **pause** gates stepping entirely.
  * **reset** regenerates state at the current count, keeping capacity;
    Filled mode is reproducible across resets (fixed seed).
  * **resize**: grow appends newly generated particles and keeps the
    existing ones; shrink keeps the capacity and only drops the count.
  * **set_method** builds fresh state, keeping the count and pause flag.
  * **pairwise**: a ``PairwiseParams`` turns on the O(N^2) direct sum
    (ops/pairwise_cuda.py: the pairwise kernel, then the step kernel, on
    ``Method.CUDA``; the plain ops/pairwise.py on ``Method.TORCH``). The
    attribute may be swapped between steps (the server's solver events).
  * **masses**: f32 source masses, kept across resizes; grown particles
    get mass 1.

The state lives on ``device`` for the engine's life; nothing moves to
another device behind the caller's back, and asking for ``"cuda"``
without CUDA raises. The CUDA method steps the planes in place.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP.md
item that ports them: the particle-mesh solvers (``pm``, ``pm2``, ``pmx``,
``pm_persist=True``) and the multi-device ``mesh``.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from ..core import generate as gen
from ..core.params import Method, PairwiseParams, SimParams, SphereGeneration
from ..core.state import LANE, ParticleState, capacity_rows, grow_state
from ..ops import pairwise, pairwise_cuda, step_cuda, step_ref
from ..render import raster, raster_compact, raster_sorted
from ..render.camera import Camera
from .stats import FrameStats

DEFAULT_COUNT_TORCH = 100_000
DEFAULT_COUNT_CUDA = 1_000_000

#: Where in ROADMAP.md each feature that is not ported yet is queued.
NOT_PORTED = {
    "pm": "ROADMAP.md queue 1 items 9-10 (ops/pm.py, ops/pm_pallas.py)",
    "pm2": "ROADMAP.md queue 1 item 11 (ops/pm2.py)",
    "pmx": "ROADMAP.md queue 1 item 12 (ops/pmx.py)",
    "pm_persist": "ROADMAP.md queue 1 item 13 (ops/pm_persist.py)",
    "diagnostics": "ROADMAP.md queue 1 item 14 (ops/diagnostics.py)",
    "mesh": "ROADMAP.md queue 1 item 15 (parallel/)",
}


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to particle_sim_tpu_torch yet: "
        f"{NOT_PORTED[feature]}")


def available_methods(device="cuda") -> list:
    """Methods that can run on ``device``: TORCH always, CUDA when the
    device is a CUDA device and CUDA is available."""
    methods = [Method.TORCH]
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        methods.append(Method.CUDA)
    return methods


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Engine:
    def __init__(
        self,
        particle_count: Optional[int] = None,
        method: Optional[Method] = None,
        generation_mode: SphereGeneration = SphereGeneration.HOLLOW,
        *,
        device="cuda",
        substeps: int = 1,
        pairwise: Optional[PairwiseParams] = None,
        pm=None,
        pm2=None,
        pmx=None,
        pm_persist: Union[bool, str] = "auto",
        masses=None,
        mesh=None,
    ):
        for feature, given in (("pm", pm is not None),
                               ("pm2", pm2 is not None),
                               ("pmx", pmx is not None),
                               ("pm_persist", pm_persist is True),
                               ("mesh", mesh is not None)):
            if given:
                raise not_ported(feature)
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        self.device = _resolve_device(device)
        avail = available_methods(self.device)
        if method is None:
            method = avail[-1]
        method = Method(method)
        if method not in avail:
            raise ValueError(
                f"method {method.name} unavailable on device "
                f"{self.device} (available: {[m.name for m in avail]})")
        if particle_count is None:
            particle_count = (DEFAULT_COUNT_CUDA if method == Method.CUDA
                              else DEFAULT_COUNT_TORCH)
        self.method = method
        self.generation_mode = generation_mode
        self.substeps = substeps
        self.pairwise = pairwise
        self.paused = False
        self.stats = FrameStats()
        self.state = self._generate_state(particle_count)
        self._masses: Optional[torch.Tensor] = None
        if masses is not None:
            self.set_masses(masses)

    # -- construction helpers -------------------------------------------------
    def _generate_state(self, count: int,
                        capacity: Optional[int] = None) -> ParticleState:
        pos, vel, col = gen.generate(count, self.generation_mode)
        return ParticleState.from_arrays(pos, vel, col, device=self.device,
                                         capacity=capacity)

    def _param_vec(self, params: Union[SimParams, np.ndarray]) -> torch.Tensor:
        pv = np.asarray(params.pack() if isinstance(params, SimParams)
                        else params, dtype=np.float32)
        # non_blocking: the 64-byte upload must not wait for queued steps
        return torch.from_numpy(pv.copy()).to(self.device, non_blocking=True)

    # -- properties -----------------------------------------------------------
    @property
    def particle_count(self) -> int:
        return int(self.state.n_active)

    @property
    def capacity(self) -> int:
        return self.state.capacity

    # -- masses -----------------------------------------------------------------
    @property
    def masses(self) -> Optional[torch.Tensor]:
        """f32[capacity] source masses on the device, or None (unit)."""
        return self._masses

    def set_masses(self, masses) -> None:
        """Set per-particle source masses (length = particle_count)."""
        m = np.asarray(masses, dtype=np.float32).ravel()
        if m.shape[0] != self.particle_count:
            raise ValueError(
                f"masses length {m.shape[0]} != count {self.particle_count}")
        buf = np.ones((self.capacity,), np.float32)
        buf[: m.shape[0]] = m
        self._masses = torch.from_numpy(buf).to(self.device)

    def _masses_for_capacity(self) -> Optional[torch.Tensor]:
        """Masses padded (with 1) or cut to the CURRENT capacity."""
        if self._masses is None:
            return None
        cap, cur = self.capacity, self._masses.shape[0]
        if cur > cap:
            self._masses = self._masses[:cap].contiguous()
        elif cur < cap:
            self._masses = torch.cat([self._masses, torch.ones(
                (cap - cur,), dtype=torch.float32, device=self.device)])
        return self._masses

    # -- stepping -------------------------------------------------------------
    def step(self, params: Union[SimParams, np.ndarray]) -> None:
        """Advance one frame unless paused. Asynchronous on CUDA."""
        self.stats.frame_tick()
        if self.paused:
            return
        pv = self._param_vec(params)
        t0 = time.perf_counter()
        st = self.state
        if self.pairwise is not None:
            pp = self._param_vec(self.pairwise.pack())   # (G, softening)
            masses = self._masses_for_capacity()
            pos, vel = st.pos, st.vel
            for _ in range(self.substeps):
                if self.method == Method.CUDA:
                    pairwise_cuda.step_pairwise(pos, vel, pv, pp, st.n_active,
                                                masses=masses)
                else:
                    pos, vel = pairwise.step_pairwise(pos, vel, pv, pp,
                                                      st.n_active,
                                                      masses=masses)
            self.state = ParticleState(pos=pos, vel=vel,
                                       init_color=st.init_color,
                                       n_active=st.n_active)
        elif self.method == Method.CUDA:
            step_cuda.step(st.pos, st.vel, pv, substeps=self.substeps)
        else:
            pos, vel = step_ref.step_n(st.pos, st.vel, pv, self.substeps)
            self.state = ParticleState(pos=pos, vel=vel,
                                       init_color=st.init_color,
                                       n_active=st.n_active)
        self.stats.record_update(time.perf_counter() - t0)

    def step_synced(self, params: Union[SimParams, np.ndarray]) -> None:
        """step() + device sync, recording the device time."""
        t0 = time.perf_counter()
        self.step(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.record_update(time.perf_counter() - t0, device=True)

    # -- lifecycle ------------------------------------------------------------
    def set_paused(self, paused: bool) -> None:
        self.paused = paused

    def is_paused(self) -> bool:
        return self.paused

    def reset(self, generation_mode: Optional[SphereGeneration] = None) -> None:
        """Regenerate at the current count, keeping capacity."""
        if generation_mode is not None:
            self.generation_mode = generation_mode
        self.state = self._generate_state(self.particle_count,
                                          capacity=self.capacity)

    def resize(self, new_count: int,
               generation_mode: Optional[SphereGeneration] = None) -> None:
        """Grow appends preserving state; shrink keeps capacity."""
        new_count = max(int(new_count), 1)
        if (generation_mode is not None
                and generation_mode != self.generation_mode):
            # a generation-mode change regenerates everything
            self.generation_mode = generation_mode
            cap = max(self.capacity, capacity_rows(new_count) * LANE)
            self.state = self._generate_state(new_count, capacity=cap)
            return
        old_count = self.particle_count
        if new_count == old_count:
            return
        st = self.state
        if new_count <= self.capacity and new_count <= old_count:
            # shrink: keep the buffers, adjust the count
            self.state = ParticleState(
                pos=st.pos, vel=st.vel, init_color=st.init_color,
                n_active=torch.tensor(new_count, dtype=torch.int32,
                                      device=self.device))
            return
        # grow: only the newly generated tail crosses to the device. Grown
        # particles get mass 1, even where a past shrink left stale masses
        # in the kept-capacity buffer.
        if self._masses is not None:
            self._masses_for_capacity()[old_count:new_count] = 1.0
        pos_a, vel_a, col_a = gen.generate(new_count - old_count,
                                           self.generation_mode)
        self.state = grow_state(st, pos_a, vel_a, col_a, new_count)

    def set_method(self, method: Method) -> None:
        """Switch stepper: fresh state, count and pause flag kept."""
        method = Method(method)
        if method == self.method:
            return
        if method not in available_methods(self.device):
            raise ValueError(f"method {method.name} unavailable on "
                             f"device {self.device}")
        count, was_paused = self.particle_count, self.paused
        self.method = method
        self.state = self._generate_state(count)
        self.paused = was_paused

    # -- output ---------------------------------------------------------------
    def colors_rgba(self, params: Union[SimParams, np.ndarray]) -> np.ndarray:
        """float32[n_active, 4] current colors."""
        st = self.state
        rgb = step_ref.colors(st.pos, st.vel, st.init_color,
                              self._param_vec(params))
        n = self.particle_count
        out = np.ones((n, 4), dtype=np.float32)
        out[:, :3] = rgb.reshape(3, -1)[:, :n].cpu().numpy().T
        return out

    def frame_arrays(
        self, params: Union[SimParams, np.ndarray], max_points: int = 0,
    ) -> tuple:
        """Host (pos f32[3, m], rgba u8[m, 4]) for the stream packer.

        rgba is premultiplied by the fragment brightness min(2|v|, 1), so
        thin clients just draw the colour. When ``max_points`` > 0 a
        strided subsample is taken on the device, so only it crosses to
        the host."""
        pos_dev, rgba_dev = self.frame_arrays_device(params, max_points)
        return (np.ascontiguousarray(pos_dev.cpu().numpy()),
                np.ascontiguousarray(rgba_dev.cpu().numpy()))

    def frame_arrays_device(
        self, params: Union[SimParams, np.ndarray], max_points: int = 0,
    ) -> tuple:
        """frame_arrays on the engine's device: queues the pack and
        returns without the device->host copy, so a caller can release its
        locks before the fetch."""
        st = self.state
        n = self.particle_count
        stride = 1
        if max_points and n > max_points:
            stride = -(-n // max_points)
        pos_dev, rgba_dev = raster.pack_points(
            st.pos, st.vel, st.init_color, self._param_vec(params),
            n_stop=n, stride=stride)
        # the pack strides the padded capacity; slice to the live range so
        # the payload honours max_points even when capacity >> n_active
        out_n = -(-max(n, 1) // stride)
        return pos_dev[:, :out_n], rgba_dev[:out_n]

    def render_frame_device(
        self, camera: Camera, params: Union[SimParams, np.ndarray],
        width: int = 1920, height: int = 1080, renderer: str = "auto",
    ) -> torch.Tensor:
        """Render; return the uint8[H, W, 4] frame on the engine's device.

        renderer: "scatter" (raster.render, any device), "compact"
        (render/raster_compact.py: the compaction and deposit kernels on
        CUDA, their plain versions on the CPU), "sorted"
        (render/raster_sorted.py: the sorted-deposit kernel on CUDA, its
        plain version on the CPU), or "auto": compact on a CUDA device
        when the resolution is a multiple of 128x8 and the capacity a
        multiple of 512, scatter otherwise.
        """
        if renderer not in ("auto", "scatter", "compact", "sorted"):
            raise ValueError(f"unknown renderer {renderer!r}")
        st = self.state
        pv = self._param_vec(params)
        vp = torch.from_numpy(camera.view_proj()).to(self.device,
                                                     non_blocking=True)
        eligible = (self.device.type == "cuda"
                    and width % raster_compact.TILE_W == 0
                    and height % raster_compact.TILE_H == 0
                    and self.capacity % raster_compact.CHUNK == 0)
        args = (st.pos, st.vel, st.init_color, pv, vp, st.n_active)
        if renderer == "compact" or (renderer == "auto" and eligible):
            fb = raster_compact.render(*args, width=width, height=height)
        elif renderer == "sorted":
            fb = raster_sorted.render(*args, width=width, height=height)
        else:
            fb = raster.render(*args, width=width, height=height)
        return raster.to_rgba8(fb)

    def render_frame(
        self, camera: Camera, params: Union[SimParams, np.ndarray],
        width: int = 1920, height: int = 1080, renderer: str = "auto",
    ) -> np.ndarray:
        """uint8[H, W, 4] frame as a host array (see render_frame_device)."""
        return self.render_frame_device(
            camera, params, width=width, height=height,
            renderer=renderer).cpu().numpy()
