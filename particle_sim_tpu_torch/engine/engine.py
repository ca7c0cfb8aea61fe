"""Engine — the headless application layer: the attractor, optionally
with self-gravity by the direct sum or the particle mesh.

Counterpart of ``particle_sim_tpu/engine/engine.py`` for the attractor,
the all-pairs gravity solver (``pairwise``) and the per-frame
particle-mesh solver (``pm``), with per-particle source ``masses``.
Lifecycle, as there:

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
  * **pm**: a ``PMConfig`` solves the same gravity with the particle-mesh
    solver instead (ops/pm_cuda.py: the deposit and gather kernels around
    a cuFFT solve, then the step kernel, on ``Method.CUDA`` at any grid
    size; the plain ops/pm.py on ``Method.TORCH``). Its G constant comes
    from ``pairwise``, defaulted to (1.0, pm.softening).
  * **pm2**: a ``PM2Config`` (or a tuple of them, outermost first) adds
    refinement levels to the PM solver (ops/pm2.py: the same deposit and
    gather kernels a level, around a difference-kernel solve).
  * **pmx**: a ``PMXConfig`` adds the window-exact short-range correction
    (ops/pmx.py: the radix sort's kernels compact the members, two
    pairwise-kernel passes). Members past its capacity keep the mesh
    force; ``step`` polls the member count every 120 frames and logs
    each overflow episode once (``pmx_member_count`` reads it).
  * **masses**: f32 source masses, kept across resizes; grown particles
    get mass 1.

The state lives on ``device`` for the engine's life; nothing moves to
another device behind the caller's back, and asking for ``"cuda"``
without CUDA raises. The CUDA method steps the planes in place.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP.md
item that ports them: the persistent cell-sorted PM state
(``pm_persist=True``) and the multi-device ``mesh``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Union

import numpy as np
import torch

from ..core import generate as gen
from ..core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from ..core.state import LANE, ParticleState, capacity_rows, grow_state
from ..ops import (
    pairwise, pairwise_cuda, pm, pm2 as pm2_ops, pm_cuda, pmx as pmx_ops,
    step_cuda, step_ref,
)
from ..render import raster, raster_compact, raster_sorted
from ..render.camera import Camera
from .stats import FrameStats

DEFAULT_COUNT_TORCH = 100_000
DEFAULT_COUNT_CUDA = 1_000_000
#: Frames between two reads of the pmx member count (about 2 s at 60 FPS).
PMX_CHECK_EVERY = 120

logger = logging.getLogger("particle_sim_tpu_torch.engine")

#: Where in ROADMAP.md each feature that is not ported yet is queued.
NOT_PORTED = {
    "pm_persist": "ROADMAP.md queue 1 item 13 (ops/pm_persist.py)",
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
        pm: Optional[PMConfig] = None,
        pm2=None,
        pmx=None,
        pm_persist: Union[bool, str] = "auto",
        two_tier: bool = True,
        masses=None,
        mesh=None,
    ):
        """``pm``: solve the gravity with the per-frame particle-mesh
        solver instead of the direct sum; the G constant still comes from
        ``pairwise`` (defaulted to ``PairwiseParams(1.0, pm.softening)``
        if omitted), the softening from ``pm.softening``.

        ``pm2``: refinement levels on top of ``pm`` (one PM2Config, or a
        tuple of them, outermost first; a 1-tuple is one level). ``pmx``:
        the window-exact correction (a PMXConfig), on ``pm`` and ``pm2``.
        Both are validated here, as :meth:`set_pm2` and :meth:`set_pmx`
        validate a swap.

        ``pm_persist``: "auto" and False are accepted and resolve to the
        per-frame path at every count (:meth:`persist_resolved`); the JAX
        engine's "auto" goes persistent at 4M particles and more (its
        ``PERSIST_AUTO_MIN_N``) without pm2 or pmx, a mode not ported
        yet, like True.

        ``two_tier``: the persistent PM's repair strategy, kept as
        ``engine.two_tier`` and carried through checkpoints and the
        server's ``"pm"`` events as the JAX engine carries it. It changes
        no physics until the persistent PM is ported."""
        for feature, given in (("pm_persist", pm_persist is True),
                               ("mesh", mesh is not None)):
            if given:
                raise not_ported(feature)
        if pm_persist not in ("auto", False):
            raise ValueError(f"pm_persist must be 'auto', True or False, "
                             f"got {pm_persist!r}")
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
        if pm is not None and pairwise is None:
            pairwise = PairwiseParams(1.0, pm.softening)
        if pm2 is not None and pm is None:
            raise ValueError("pm2 requires a coarse PMConfig (pm=...)")
        if pmx is not None and pm is None:
            raise ValueError("pmx requires the PM solver (pm=...)")
        if (pm_persist == "auto" and (pmx is not None or (
                isinstance(pm2, (tuple, list)) and len(pm2) > 1))):
            pm_persist = False    # auto keeps the per-frame pmn / pmx
        self.pairwise = pairwise
        self.pm = pm
        self.pm2 = None
        self.pmx = None
        self.set_pm2(pm2)
        self.set_pmx(pmx)
        self._pmx_members = None       # (n_members, n_corrected) device
        self._pmx_check_at = 0         # next frame index to read them
        self._pmx_overflowing = False  # warn once per overflow episode
        self._frame_index = 0
        self.pm_persist = pm_persist
        self.two_tier = bool(two_tier)
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
        if self.pm is not None:
            self._step_pm(pv)
        elif self.pairwise is not None:
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
        self._check_pmx_overflow()

    def _step_pm(self, pv: torch.Tensor) -> None:
        """``substeps`` particle-mesh steps, with the refinement levels and
        the exact window when set (the JAX engine's order: pmx, then pm2,
        then pm): the kernels on Method.CUDA (in place), the plain solvers
        on Method.TORCH."""
        cfg, st = self.pm, self.state
        pp = self._param_vec((self.pairwise or PairwiseParams(
            1.0, cfg.softening)).pack())
        masses = self._masses_for_capacity()
        levels = pm2_ops.as_levels(self.pm2)
        fast = self.method == Method.CUDA
        pos, vel = st.pos, st.vel
        for _ in range(self.substeps):
            if self.pmx is not None:
                pos, vel, n_m = pmx_ops.step_pmx(
                    pos, vel, pv, pp, st.n_active, cfg, levels, self.pmx,
                    masses=masses, use_fast=fast)
            elif levels:
                pos, vel = pm2_ops.step_pmn(pos, vel, pv, pp, st.n_active,
                                            cfg, levels, masses=masses,
                                            use_fast=fast)
            elif fast:
                pm_cuda.step_pm(pos, vel, pv, pp, st.n_active, cfg,
                                masses=masses)
            else:
                pos, vel = pm.step_pm_ref(pos, vel, pv, pp, st.n_active, cfg,
                                          masses=masses)
        if self.pmx is not None:
            # device scalars, read lazily (pmx_member_count, the periodic
            # overflow check in step): never a sync here
            self._pmx_members = (n_m, torch.clamp_max(n_m,
                                                      self.pmx.capacity))
        self.state = ParticleState(pos=pos, vel=vel, init_color=st.init_color,
                                   n_active=st.n_active)

    def _check_pmx_overflow(self) -> None:
        """Loud truncation: members beyond the exact buffer's capacity keep
        the mesh force only, so every PMX_CHECK_EVERY frames read the two
        device counts (a sync with a step already queued) and log once per
        overflow episode."""
        self._frame_index += 1
        if (self._pmx_members is None
                or self._frame_index < self._pmx_check_at):
            return
        self._pmx_check_at = self._frame_index + PMX_CHECK_EVERY
        n_mem, n_corr = self.pmx_member_count()
        if n_mem > n_corr and not self._pmx_overflowing:
            self._pmx_overflowing = True
            logger.warning(
                "pmx window overflow: %d members, only %d inside the "
                "capacity-%d exact buffer; the rest keep the mesh-only force "
                "(grow pmx capacity or shrink the window)", n_mem, n_corr,
                self.pmx.capacity)
        elif n_mem <= n_corr:
            self._pmx_overflowing = False

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

    # -- particle-mesh mode and diagnostics ------------------------------------
    def set_pm2(self, pm2) -> None:
        """Set, swap or clear (None, ()) the refinement stack between steps
        (the server's solver events), with the constructor's normalisation
        (a 1-tuple is one level). Every invalid stack raises here, at the
        call site, and the old one stays: one that does not nest or whose
        softenings do not fall, and one the installed pmx window cannot
        nest in."""
        if pm2 is not None and self.pm is None:
            raise ValueError("pm2 requires a PM solver (pm=...)")
        if isinstance(pm2, (tuple, list)):
            pm2 = tuple(pm2)
            if len(pm2) == 1:
                pm2 = pm2[0]
            elif not pm2:
                pm2 = None
        levels = pm2_ops.as_levels(pm2)
        if levels:
            pm2_ops._validate_levels(self.pm, levels)
        if self.pmx is not None:
            pmx_ops._validate(self.pm, levels, self.pmx)
        self.pm2 = pm2

    def set_pmx(self, pmx) -> None:
        """Install, replace or clear (None) the window-exact correction
        between steps, validated against the current PM and stack at the
        call site (a rejected window keeps the old one). A change forgets
        the member counts of the old window."""
        if pmx is not None:
            if self.pm is None:
                raise ValueError("pmx requires the PM solver (pm=...)")
            pmx_ops._validate(self.pm, pm2_ops.as_levels(self.pm2), pmx)
        if pmx == self.pmx:
            return
        self.pmx = pmx
        self._pmx_members = None
        self._pmx_overflowing = False

    def pmx_member_count(self):
        """(n_members, n_corrected) of the newest pmx frame, or None before
        the first one. n_corrected < n_members means the exact window
        overflowed its capacity (the rest keep the mesh force). Reads two
        device scalars."""
        if self._pmx_members is None:
            return None
        return tuple(int(c) for c in self._pmx_members)

    def persist_resolved(self) -> bool:
        """Whether a step right now would run the persistent cell-sorted PM
        mode: always False here (the mode is not ported; "auto" and False
        run the per-frame path, where the JAX engine's "auto" would turn
        persistent at 4M particles and more without pm2)."""
        return False

    def diagnostics(self, potential: bool = False):
        """Physics observables (ops/diagnostics.py): kinetic energy,
        momentum, mean radius, max speed; ``potential=True`` adds the
        gravitational potential (exact at small N, the mesh estimate with
        a PM config at large N)."""
        from ..ops import diagnostics as diag

        g = (self.pairwise.gravitational_constant if self.pairwise else 0.0)
        eps = (self.pm.softening if self.pm
               else self.pairwise.softening if self.pairwise else 2.0)
        return diag.measure(
            self.state.pos, self.state.vel, self.state.n_active,
            g_const=g, softening=eps, pm_cfg=self.pm, potential=potential,
            masses=self._masses_for_capacity())

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
