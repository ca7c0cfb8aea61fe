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
  * **pm_persist**: the PM solver on the persistent cell-sorted state
    (ops/pm_persist.py): the particles stay in cell order between frames
    (a sorted mirror of the state), repaired by the radix sort when the
    disorder passes its threshold; ``state`` rebuilds the identity order
    lazily, when it is read (a gather by the inverse permutation of the
    particles' ids), and the frame and stream accessors read the sorted
    planes directly.
  * **masses**: f32 source masses, kept across resizes; grown particles
    get mass 1.
  * **debug_checks**: ``utils/debug.validate_state`` after every step (a
    read of four numbers, so a wait for the device each step).
  * **mesh**: a 1-D ``dp`` DeviceMesh (parallel/mesh.py) row-shards the
    state over the ranks of a torch.distributed group, one process a
    device, each running this same program on its own rows (SPMD): the
    attractor steps each shard alone (parallel/dp.py), the direct sum
    turns a ring of position shards (parallel/ring.py), the PM solver
    all-reduces its grid (parallel/pm_dp.py; the persistent PM,
    parallel/pm_persist_dp.py, is the one sharded path for pm2 and pmx)
    and the compact frame all-reduces its tile planes
    (parallel/render_dp.py). ``state`` and ``masses`` are gathered from
    every rank when read (all ranks read together); the frame is the
    same on every rank.

The state lives on ``device`` for the engine's life; nothing moves to
another device behind the caller's back, and asking for ``"cuda"``
without CUDA raises. The CUDA method steps the planes in place.
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
from ..core.state import (
    LANE, SUBLANE, ParticleState, capacity_rows, grow_state,
)
from ..ops import (
    pairwise, pairwise_cuda, pm, pm2 as pm2_ops, pm_cuda, pm_persist as pper,
    pmx as pmx_ops, step_cuda, step_ref,
)
from ..render import raster, raster_compact, raster_sorted
from ..render.camera import Camera
from ..utils import trace
from .stats import FrameStats

DEFAULT_COUNT_TORCH = 100_000
DEFAULT_COUNT_CUDA = 1_000_000
#: Frames between two reads of the pmx member count (about 2 s at 60 FPS).
PMX_CHECK_EVERY = 120
#: The count from which pm_persist="auto" runs the persistent PM (without
#: pm2 or pmx): the smallest count at which 100 frames of a collapse ran
#: more than 5 % faster persistent than per frame, repairs included, on
#: the H100 (chip_smoke.py phase 19: at 4,194,304 and 16,777,216, not at
#: 1M; PERF.md).
PERSIST_AUTO_MIN_N: Optional[int] = 4_194_304

logger = logging.getLogger("particle_sim_tpu_torch.engine")


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


def _collectives(mesh, device: torch.device):
    """The ``dp`` collectives of ``mesh`` (parallel/mesh.py), after
    checking that it is a 1-D ``dp`` DeviceMesh of ``device``'s type."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.mesh import DP_AXIS, Collectives

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.mesh.make_mesh), got {type(mesh)}")
    if mesh.ndim != 1 or mesh.mesh_dim_names != (DP_AXIS,):
        raise ValueError(f"mesh must be 1-D with the axis {DP_AXIS!r}, got "
                         f"{mesh.mesh_dim_names}")
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot shard the state "
                         f"of a {device.type} engine")
    return Collectives(mesh)


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
        debug_checks: bool = False,
        interpret: bool = False,
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

        ``pm_persist``: True runs the PM solver on the persistent
        cell-sorted state (ops/pm_persist.py); it needs ``pm`` with a
        static box and a grid in pm_persist.SUPPORTED_GRIDS, and with
        ``pmx`` a multi-level ``pm2`` tuple. "auto" goes persistent from
        PERSIST_AUTO_MIN_N particles (the H100's crossover; None: never)
        without pm2 and pmx, re-evaluated every step; False never.
        :meth:`persist_resolved` says what a step runs.

        ``two_tier``: the persistent PM's repair strategy in the JAX
        package (a segment-local sort before the full one), kept as
        ``engine.two_tier`` and carried through checkpoints and the
        server's ``"pm"`` events. Every repair of the port is the full
        sort: the segment-local one costs the radix sort a pass more.

        ``debug_checks``: validate the state after every step
        (utils/debug.validate_state; on the sorted planes when the
        identity order is stale).

        ``interpret``: the JAX package's Pallas interpret mode. The CUDA
        kernels have none: their plain versions run on CPU tensors, so
        True is accepted only with ``device="cpu"``.

        ``mesh``: a 1-D ``dp`` DeviceMesh (parallel.mesh.make_mesh) over
        an initialized torch.distributed group whose device type is
        ``device``'s: the state is row-sharded over its ranks. The JAX
        rules hold: pm2 on a mesh runs the persistent PM ("auto" is
        promoted to True; an auto box, an unsupported grid or False
        raises), pmx needs a pm2 tuple and a capacity that is a multiple
        of 512 * n_dev. On a mesh the persistent PM runs the kernels'
        wrappers whatever the method (their plain versions on CPU
        tensors), as the JAX engine runs its Pallas kernels there."""
        coll = None if mesh is None else _collectives(mesh,
                                                      torch.device(device))
        if pm_persist not in ("auto", True, False):
            raise ValueError(f"pm_persist must be 'auto', True or False, "
                             f"got {pm_persist!r}")
        if interpret and torch.device(device).type != "cpu":
            raise ValueError("interpret=True: the CUDA kernels have no "
                             "interpret mode; their plain versions run with "
                             "device='cpu'")
        if pm_persist is True:
            if pm is None:
                raise ValueError("pm_persist requires a PMConfig")
            if pm.auto_box or pm.grid not in pper.SUPPORTED_GRIDS:
                raise ValueError(
                    "pm_persist needs a static box and a grid in "
                    f"{pper.SUPPORTED_GRIDS} (got auto_box={pm.auto_box}, "
                    f"grid={pm.grid})")
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        self.device = _resolve_device(device)
        self.mesh = mesh
        self._coll = coll
        self._n_dev = 1 if mesh is None else coll.size
        self._mesh_fns: dict = {}      # parallel/ step functions, by config
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
        if (mesh is not None and pm_persist == "auto"
                and pm2_ops.as_levels(tuple(pm2) if isinstance(pm2, list)
                                      else pm2)):
            # pm2 is sharded only on the persistent path
            if pm.auto_box or pm.grid not in pper.SUPPORTED_GRIDS:
                raise ValueError(
                    "multi-chip pm2 rides the persistent path, which needs a "
                    f"static box and a grid in {pper.SUPPORTED_GRIDS}")
            pm_persist = True
        if (pm_persist == "auto" and (pmx is not None or (
                isinstance(pm2, (tuple, list)) and len(pm2) > 1))):
            pm_persist = False    # auto keeps the per-frame pmn / pmx
        self.pairwise = pairwise
        self.pm = pm
        self.pm_persist = pm_persist
        self.two_tier = bool(two_tier)
        self.debug_checks = bool(debug_checks)
        self._persist: Optional[pper.SortedPMState] = None  # sorted mirror
        self._identity_dirty = False   # state planes stale against it
        self._trigger: Optional[pper.RepairTrigger] = None
        self.pm2 = None
        self.pmx = None
        self.set_pm2(pm2)
        self.set_pmx(pmx)
        self._pmx_members = None       # (n_members, n_corrected) device
        self._pmx_check_at = 0         # next frame index to read them
        self._pmx_overflowing = False  # warn once per overflow episode
        self._frame_index = 0
        self.paused = False
        self.stats = FrameStats()
        self.state = self._generate_state(particle_count)
        self._masses: Optional[torch.Tensor] = None
        if masses is not None:
            self.set_masses(masses)

    # -- construction helpers -------------------------------------------------
    @property
    def _row_multiple(self) -> int:
        return SUBLANE * self._n_dev

    def _generate_state(self, count: int,
                        capacity: Optional[int] = None) -> ParticleState:
        """A fresh state at ``count``; on a mesh the global state on the
        host (every rank makes the same), which the ``state`` setter
        shards."""
        pos, vel, col = gen.generate(count, self.generation_mode)
        return ParticleState.from_arrays(
            pos, vel, col,
            device=self.device if self._coll is None else "cpu",
            capacity=capacity, row_multiple=self._row_multiple)

    def _shard(self, value: ParticleState) -> ParticleState:
        """This rank's rows of a global identity-order state, on the
        engine's device."""
        from ..parallel.mesh import shard_state_planes

        if value.rows % self._n_dev:
            raise ValueError(f"{value.rows} rows do not split over "
                             f"{self._n_dev} devices")
        pos, vel, col = (p.to(self.device) for p in shard_state_planes(
            self.mesh, value.pos, value.vel, value.init_color))
        return ParticleState(pos=pos, vel=vel, init_color=col,
                             n_active=value.n_active.to(self.device))

    def _gather(self, local: ParticleState) -> ParticleState:
        """The global identity-order state from every rank's rows (an
        all_gather a plane)."""
        g = self._coll.all_gather
        return ParticleState(pos=g(local.pos, 1), vel=g(local.vel, 1),
                             init_color=g(local.init_color, 1),
                             n_active=local.n_active)

    def _mesh_fn(self, key: tuple, make):
        """A parallel/ step function, made once a configuration."""
        fn = self._mesh_fns.get(key)
        if fn is None:
            fn = self._mesh_fns[key] = make()
        return fn

    def _param_vec(self, params: Union[SimParams, np.ndarray]) -> torch.Tensor:
        pv = np.asarray(params.pack() if isinstance(params, SimParams)
                        else params, dtype=np.float32)
        # non_blocking: the 64-byte upload must not wait for queued steps
        return torch.from_numpy(pv.copy()).to(self.device, non_blocking=True)

    # -- properties -----------------------------------------------------------
    @property
    def state(self) -> ParticleState:
        """The identity-order state planes. After persistent steps they
        are rebuilt from the sorted mirror on this read (paid per consumed
        frame, never per simulated one). On a mesh: the global state,
        gathered from every rank on this read (every rank reads)."""
        self.ensure_identity_order()
        if self._coll is None:
            return self._state
        return self._gather(self._state)

    @state.setter
    def state(self, value: ParticleState) -> None:
        # assigned planes supersede the sorted mirror; the count is read
        # here once, so that steps never read it back. On a mesh the value
        # is the global state: this rank keeps its rows
        if self._coll is not None:
            value = self._shard(value)
        else:
            self._check_device("the state", value.pos, value.vel,
                               value.init_color, value.n_active)
        self._state = value
        self._count = int(value.n_active)
        self._drop_persist()

    def _check_device(self, what: str, *tensors: torch.Tensor) -> None:
        """Raise ValueError unless every tensor lies on the engine's device:
        the kernel wrappers send CPU tensors to their plain versions, so a
        CPU state on a CUDA engine would step on the CPU (or fail deep in a
        step) instead of being refused here. A device without an index
        ("cuda") means the current one, where ``.to(device)`` puts
        tensors."""
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        for t in tensors:
            if t.device != want:
                raise ValueError(
                    f"{what} is on {t.device} but the engine on {want}: "
                    f"build it with device=engine.device")

    @property
    def particle_count(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._state.capacity * self._n_dev

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 without one): the one that
        writes files and prints."""
        return 0 if self._coll is None else self._coll.rank

    # -- masses -----------------------------------------------------------------
    @property
    def masses(self) -> Optional[torch.Tensor]:
        """f32[capacity] source masses on the device, or None (unit); on a
        mesh gathered from every rank on this read."""
        m = self._masses_for_capacity()
        if m is None or self._coll is None:
            return m
        return self._coll.all_gather(m)

    def set_masses(self, masses) -> None:
        """Set per-particle source masses (length = particle_count): a host
        array, or a tensor on the engine's device (ValueError otherwise)."""
        if isinstance(masses, torch.Tensor):
            self._check_device("the masses", masses)
            masses = masses.detach().cpu()
        self.ensure_identity_order()
        self._drop_persist()          # the sorted masses are stale
        m = np.asarray(masses, dtype=np.float32).ravel()
        if m.shape[0] != self.particle_count:
            raise ValueError(
                f"masses length {m.shape[0]} != count {self.particle_count}")
        buf = np.ones((self.capacity,), np.float32)
        buf[: m.shape[0]] = m
        self._place_masses(buf)

    def _place_masses(self, buf: np.ndarray) -> None:
        """Keep the global f32[capacity] ``buf`` (this rank's rows of it on
        a mesh) on the device."""
        t = torch.from_numpy(buf)
        if self._coll is not None:
            from ..parallel.mesh import shard_rows

            t = shard_rows(self.mesh, t, 0)
        self._masses = t.to(self.device)

    def _masses_for_capacity(self) -> Optional[torch.Tensor]:
        """Masses padded (with 1) or cut to the CURRENT capacity (this
        rank's rows on a mesh)."""
        if self._masses is None:
            return None
        cap, cur = self._state.capacity, self._masses.shape[0]
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
        # one timer: the engine.step span's clock reads when tracing is on
        trace.refresh()
        with trace.span("engine.step", device=self.device.type == "cuda",
                        on_device=self.stats.record_device) as sp:
            t0 = None if sp else time.perf_counter()
            if self._persist_eligible():
                self._step_persist(pv)
            else:
                self._step_identity(pv)
        self.stats.record_update((sp.end_ns - sp.start_ns) * 1e-9 if sp
                                 else time.perf_counter() - t0)
        self._check_pmx_overflow()
        if self.debug_checks:
            from ..utils.debug import validate_state
            st = self._persist if self._identity_dirty else self._state
            validate_state(st.pos, st.vel)

    def _step_identity(self, pv: torch.Tensor) -> None:
        """A step of every mode but the persistent PM, on the identity
        planes (rebuilt first when the solver just left that mode)."""
        self.ensure_identity_order()
        self._persist = None
        st = self._state
        if self._coll is not None:
            self._step_mesh(pv)
        elif self.pm is not None:
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
            self._state = ParticleState(pos=pos, vel=vel,
                                        init_color=st.init_color,
                                        n_active=st.n_active)
        elif self.method == Method.CUDA:
            step_cuda.step(st.pos, st.vel, pv, substeps=self.substeps)
        else:
            pos, vel = step_ref.step_n(st.pos, st.vel, pv, self.substeps)
            self._state = ParticleState(pos=pos, vel=vel,
                                        init_color=st.init_color,
                                        n_active=st.n_active)

    def _step_pm(self, pv: torch.Tensor) -> None:
        """``substeps`` particle-mesh steps, with the refinement levels and
        the exact window when set (the JAX engine's order: pmx, then pm2,
        then pm): the kernels on Method.CUDA (in place), the plain solvers
        on Method.TORCH."""
        cfg, st = self.pm, self._state
        pp = self._pair_vec()
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
        self._state = ParticleState(pos=pos, vel=vel,
                                    init_color=st.init_color,
                                    n_active=st.n_active)

    def _step_mesh(self, pv: torch.Tensor) -> None:
        """``substeps`` steps of this rank's shard: the PM grid all-reduce
        (parallel/pm_dp.py), the ring of the direct sum
        (parallel/ring.py) or the attractor alone (parallel/dp.py); the
        kernels on Method.CUDA (in place), the plain versions on
        Method.TORCH."""
        from ..parallel import dp, pm_dp, ring

        st = self._state
        fast = self.method == Method.CUDA
        masses = self._masses_for_capacity()
        extra = () if masses is None else (masses,)
        pos, vel = st.pos, st.vel
        if self.pm is not None:
            if self.pm2 is not None or self.pmx is not None:
                raise ValueError(
                    "on a mesh pm2 and pmx run on the persistent PM only "
                    "(pm_persist=True with a static box and a grid in "
                    f"{pper.SUPPORTED_GRIDS})")
            fn = self._mesh_fn(
                ("pm", self.pm, fast, bool(extra)),
                lambda: pm_dp.make_pm_step(self.mesh, self.pm,
                                           use_kernels=fast,
                                           with_masses=bool(extra)))
            pp = self._pair_vec()
            for _ in range(self.substeps):
                pos, vel = fn(pos, vel, pv, pp, st.n_active, *extra)
        elif self.pairwise is not None:
            fn = self._mesh_fn(
                ("ring", fast, bool(extra)),
                lambda: ring.make_ring_pairwise_step(
                    self.mesh, use_kernels=fast, with_masses=bool(extra)))
            pp = self._param_vec(self.pairwise.pack())
            for _ in range(self.substeps):
                pos, vel = fn(pos, vel, pv, pp, st.n_active, *extra)
        else:
            fn = self._mesh_fn(
                ("dp", fast, self.substeps),
                lambda: dp.make_sharded_step(self.mesh, use_kernels=fast,
                                             substeps=self.substeps))
            pos, vel = fn(pos, vel, pv)
        self._state = ParticleState(pos=pos, vel=vel,
                                    init_color=st.init_color,
                                    n_active=st.n_active)

    def _pair_vec(self) -> torch.Tensor:
        """(G, softening) on the device; the PM softening comes from the
        config, G from ``pairwise`` (1 when unset)."""
        return self._param_vec((self.pairwise or PairwiseParams(
            1.0, self.pm.softening)).pack())

    # -- the persistent cell-sorted PM (ops/pm_persist.py) ---------------------
    def persist_resolved(self) -> bool:
        """Whether a step right now runs the persistent PM: pm_persist
        True with a PM config that has a static box and a supported grid
        (a solver event may swap it for one that has not: the step then
        falls back to the per-frame path), or "auto" from
        PERSIST_AUTO_MIN_N particles without pm2 and pmx."""
        return self._persist_eligible()

    def _persist_eligible(self) -> bool:
        cfg = self.pm
        if (self.pm_persist is False or cfg is None or cfg.auto_box
                or cfg.grid not in pper.SUPPORTED_GRIDS):
            return False
        if self.pm_persist == "auto":
            return (PERSIST_AUTO_MIN_N is not None and self.pm2 is None
                    and self.pmx is None
                    and self.particle_count >= PERSIST_AUTO_MIN_N)
        return True

    def _step_persist(self, pv: torch.Tensor) -> None:
        """``substeps`` frames on the sorted mirror (made on the first
        one: one sort by coarse cell, or with refinement levels into
        their class order). A repair fires when the RepairTrigger
        reads a disorder verdict from an earlier frame; a verdict is
        queued after every pper.CHECK_EVERY-th frame while none is in
        flight. Nothing here waits for the device. On a mesh each rank
        keeps the mirror of its rows (parallel/pm_persist_dp.py) and
        repairs it alone."""
        cfg, st = self.pm, self._state
        n_active = st.n_active
        levels = pm2_ops.as_levels(self.pm2)
        fast = self.method == Method.CUDA or self._coll is not None
        if self._coll is not None:
            from ..parallel import pm_persist_dp

            init, step = self._mesh_fn(
                ("persist", cfg, self.pm2, self.pmx),
                lambda: (pm_persist_dp.make_persist_init(
                    self.mesh, cfg, cfg2=self.pm2),
                    pm_persist_dp.make_persist_pm_step(
                        self.mesh, cfg, cfg2=self.pm2, cfgx=self.pmx)))
        else:
            def step(st_, pv_, pp_, na_, repair):
                return pper.step_sorted(st_, pv_, pp_, na_, cfg,
                                        cfg2=self.pm2, cfgx=self.pmx,
                                        repair=repair, use_fast=fast)
        if self._persist is None:
            kw = dict(vel_flat=st.vel.reshape(3, -1),
                      masses=self._masses_for_capacity(),
                      col24=raster.pack_col24(st.init_color.reshape(3, -1)))
            if self._coll is not None:
                self._persist = init(st.pos.reshape(3, -1), n_active=n_active,
                                     **kw)
            elif isinstance(self.pm2, tuple):
                self._persist = pper.init_sorted_multi(
                    st.pos.reshape(3, -1), n_active, cfg, self.pm2,
                    use_kernels=fast, **kw)
            else:
                self._persist = pper.init_sorted(
                    st.pos.reshape(3, -1), n_active, cfg, cfg2=self.pm2,
                    use_kernels=fast, **kw)
            self._trigger = pper.RepairTrigger(self.device)
            repair = False
        else:
            repair = self._trigger.due()
        pp = self._pair_vec()
        for _ in range(self.substeps):
            out = step(self._persist, pv, pp, n_active, repair)
            repair = False
            if self.pmx is None:
                self._persist = out
                continue
            self._persist, n_m = out
            # on a mesh the (members, corrected) pair over all ranks
            self._pmx_members = ((n_m, torch.clamp_max(n_m, self.pmx.capacity))
                                 if self._coll is None else tuple(n_m))
        self._identity_dirty = True
        if self._frame_index % pper.CHECK_EVERY == 0:
            st = self._persist
            self._trigger.measure(
                lambda: pper.needs_repair(st, n_active, cfg, levels,
                                          use_kernels=fast))

    def ensure_identity_order(self) -> None:
        """Rebuild the identity-order planes from the sorted mirror
        (pm_persist.unsort); a no-op when they are current."""
        if not self._identity_dirty:
            return
        st, p = self._state, self._persist
        if self._coll is not None:
            from ..parallel.pm_persist_dp import identity_order

            pos, vel = identity_order(self.mesh, p, (p.pos, p.vel))
        else:
            pos, vel = pper.unsort(p, (p.pos, p.vel))
        self._state = ParticleState(pos=pos.view(st.pos.shape),
                                    vel=vel.view(st.vel.shape),
                                    init_color=st.init_color,
                                    n_active=st.n_active)
        self._identity_dirty = False

    def _drop_persist(self) -> None:
        """Forget the sorted mirror (the state is about to be rebuilt, or
        was just assigned)."""
        self._persist = None
        self._identity_dirty = False

    @property
    def resorts(self) -> int:
        """Repairs of the current sorted mirror (0 without one)."""
        return 0 if self._persist is None else self._persist.resorts

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
        """Grow appends preserving state; shrink keeps capacity. On a mesh
        a grow or a regeneration rebuilds the sharded state through the
        host (the rows of every rank move with the capacity)."""
        new_count = max(int(new_count), 1)
        self.ensure_identity_order()   # grow and shrink read the planes
        self._drop_persist()           # capacity or count change: re-init
        old_count = self.particle_count
        # on a mesh the masses are re-placed with the rows (below)
        m_host = (self.masses.cpu().numpy()
                  if self._coll is not None and self._masses is not None
                  else None)
        if (generation_mode is not None
                and generation_mode != self.generation_mode):
            # a generation-mode change regenerates everything
            self.generation_mode = generation_mode
            cap = max(self.capacity,
                      capacity_rows(new_count, self._row_multiple) * LANE)
            self.state = self._generate_state(new_count, capacity=cap)
        elif new_count == old_count:
            return
        elif new_count <= self.capacity and new_count <= old_count:
            # shrink: keep the buffers, adjust the count
            n = torch.tensor(new_count, dtype=torch.int32,
                             device=self.device)
            self._set_count(n)
            return
        else:
            # grow: only the newly generated tail crosses to the device
            # (on one device). Grown particles get mass 1, even where a
            # past shrink left stale masses in the kept-capacity buffer.
            pos_a, vel_a, col_a = gen.generate(new_count - old_count,
                                               self.generation_mode)
            st = self.state
            if self._coll is None:
                if self._masses is not None:
                    self._masses_for_capacity()[old_count:new_count] = 1.0
                self.state = grow_state(st, pos_a, vel_a, col_a, new_count)
                return
            if m_host is not None:
                m_host[old_count:new_count] = 1.0
            self.state = ParticleState.from_arrays(
                np.concatenate([st.positions(), pos_a]),
                np.concatenate([st.velocities(), vel_a]),
                np.concatenate([st.init_colors_rgba()[:, :3], col_a]),
                device="cpu", row_multiple=self._row_multiple)
        if m_host is not None:
            buf = np.ones((self.capacity,), np.float32)
            k = min(buf.shape[0], m_host.shape[0])
            buf[:k] = m_host[:k]
            self._place_masses(buf)

    def _set_count(self, n_active: torch.Tensor) -> None:
        """A new live count on the same planes (a shrink)."""
        st = self._state
        self._state = ParticleState(pos=st.pos, vel=st.vel,
                                    init_color=st.init_color,
                                    n_active=n_active)
        self._count = int(n_active)
        self._drop_persist()

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
            if self._coll is not None and self.pm_persist is not True:
                raise ValueError("multi-chip pm2 requires pm_persist "
                                 "(parallel/pm_persist_dp.py is the sharded "
                                 "refinement path)")
        if self.pmx is not None:
            self._validate_pmx(levels, self.pmx)
        if pm2 == self.pm2:
            return
        self.ensure_identity_order()   # the class order changes with it
        self._drop_persist()
        self.pm2 = pm2

    def set_pmx(self, pmx) -> None:
        """Install, replace or clear (None) the window-exact correction
        between steps, validated against the current PM and stack at the
        call site (a rejected window keeps the old one). A change forgets
        the member counts of the old window. The sorted mirror is kept:
        its class order depends on the pm2 stack only."""
        if pmx is not None:
            if self.pm is None:
                raise ValueError("pmx requires the PM solver (pm=...)")
            self._validate_pmx(pm2_ops.as_levels(self.pm2), pmx)
        if pmx == self.pmx:
            return
        self.pmx = pmx
        self._pmx_members = None
        self._pmx_overflowing = False

    def _validate_pmx(self, levels, pmx) -> None:
        """pmx's rules, and with pm_persist=True the persistent order's
        (pm_persist.validate); on a mesh also the sharded window's
        (parallel/pm_persist_dp.check_pmx)."""
        if self._coll is not None:
            from ..parallel.pm_persist_dp import check_pmx

            if not (len(levels) > 1 and self.pm_persist is True):
                raise ValueError(
                    "multi-chip pmx rides the persistent MULTI-level class "
                    "order: pass a tuple pm2 (which resolves pm_persist=True "
                    "on a mesh)")
            check_pmx(pmx, tuple(levels), self._n_dev)
        if self.pm_persist is True:
            pper.validate(self.pm, levels, pmx)
        else:
            pmx_ops._validate(self.pm, levels, pmx)

    def pmx_member_count(self):
        """(n_members, n_corrected) of the newest pmx frame, or None before
        the first one. n_corrected < n_members means the exact window
        overflowed its capacity (the rest keep the mesh force). Reads two
        device scalars."""
        if self._pmx_members is None:
            return None
        return tuple(int(c) for c in self._pmx_members)

    def diagnostics(self, potential: bool = False):
        """Physics observables (ops/diagnostics.py): kinetic energy,
        momentum, mean radius, max speed; ``potential=True`` adds the
        gravitational potential (exact at small N, the mesh estimate with
        a PM config at large N)."""
        from ..ops import diagnostics as diag

        g = (self.pairwise.gravitational_constant if self.pairwise else 0.0)
        eps = (self.pm.softening if self.pm
               else self.pairwise.softening if self.pairwise else 2.0)
        st = self.state
        return diag.measure(
            st.pos, st.vel, st.n_active,
            g_const=g, softening=eps, pm_cfg=self.pm, potential=potential,
            masses=self.masses)

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
        locks before the fetch.

        After persistent steps the points come straight from the sorted
        planes, coloured from the mirror's col24 (no un-sort): a point
        cloud draws the same in any order, and the live slots are a
        prefix of the mirror (dead slots sort last at every repair and
        slots do not move between repairs). A strided subsample of the
        cell order is spatially even; a repair can change its members."""
        pos, vel, col = self._display_planes()
        n = self.particle_count
        stride = 1
        if max_points and n > max_points:
            stride = -(-n // max_points)
        pos_dev, rgba_dev = raster.pack_points(
            pos, vel, col, self._param_vec(params), n_stop=n, stride=stride)
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
        pv = self._param_vec(params)
        vp = torch.from_numpy(camera.view_proj()).to(self.device,
                                                     non_blocking=True)
        if self._coll is not None and renderer != "scatter":
            fb = self._render_frame_dp(pv, vp, width, height)
            if fb is not None:
                return raster.to_rgba8(fb)
        pos, vel, col = self._display_planes()
        eligible = (self.device.type == "cuda"
                    and width % raster_compact.TILE_W == 0
                    and height % raster_compact.TILE_H == 0
                    and self.capacity % raster_compact.CHUNK == 0)
        args = (pos, vel, col, pv, vp, self._state.n_active)
        if renderer == "compact" or (renderer == "auto" and eligible):
            fb = raster_compact.render(*args, width=width, height=height)
        elif renderer == "sorted":
            fb = raster_sorted.render(*args, width=width, height=height)
        else:
            fb = raster.render(*args, width=width, height=height)
        return raster.to_rgba8(fb)

    def _render_frame_dp(self, pv, vp, width: int, height: int):
        """The frame of a mesh engine (parallel/render_dp.py): each rank
        draws its rows, one all-reduce of the tile planes. From the sorted
        mirror after persistent steps (no identity rebuild). -> the f32
        frame, or None when the resolution or a rank's capacity cannot
        tile (the caller then draws the gathered state)."""
        from ..parallel.render_dp import make_render_dp

        if (width % raster_compact.TILE_W or height % raster_compact.TILE_H
                or self._state.capacity % raster_compact.CHUNK):
            return None
        flat = self._identity_dirty
        fn = self._mesh_fn(("render", width, height, flat),
                           lambda: make_render_dp(self.mesh, width=width,
                                                  height=height, flat=flat))
        st = self._state
        if flat:
            p = self._persist
            return fn(p.pos, p.vel, raster.unpack_col24(p.col24), pv, vp,
                      st.n_active)
        return fn(st.pos, st.vel, st.init_color, pv, vp, st.n_active)

    def _display_planes(self) -> tuple:
        """(pos, vel, init_color) planes for the renderers and the stream:
        the sorted mirror's after persistent steps (a frame does not
        depend on the order of its points; the colours of mode 0 come
        from the mirror's col24, u8 a channel), else the identity
        planes. On a mesh the gathered identity-order state."""
        if self._coll is not None:
            st = self.state
            return st.pos, st.vel, st.init_color
        st = self._state
        if self._identity_dirty:
            p = self._persist
            return (p.pos.view(st.pos.shape), p.vel.view(st.vel.shape),
                    raster.unpack_col24(p.col24).view(st.init_color.shape))
        return st.pos, st.vel, st.init_color

    def render_frame(
        self, camera: Camera, params: Union[SimParams, np.ndarray],
        width: int = 1920, height: int = 1080, renderer: str = "auto",
    ) -> np.ndarray:
        """uint8[H, W, 4] frame as a host array (see render_frame_device)."""
        return self.render_frame_device(
            camera, params, width=width, height=height,
            renderer=renderer).cpu().numpy()
