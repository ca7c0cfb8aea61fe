"""The ranks of the port's multi-process tests: one gloo group of CPU
processes a world size, each running every leg of the mesh path on its
shard of inputs made with numpy from a seed. Imports no JAX (the test
modules hold the JAX side).

:func:`run_group` starts the group with ``torch.multiprocessing``'s spawn
context and a ``file://`` store under the caller's directory (so parallel
test workers never race for ports); each rank's init and every
collective time out after INIT_TIMEOUT_S, and the parent kills the group
and fails if it has not finished in JOIN_TIMEOUT_S. Each rank saves its
results (numpy arrays of its shard, or the traceback of a failure) with
``torch.save``; the parent returns them in rank order.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback

import numpy as np
import torch

INIT_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120
PER_SHARD = 1024           # particles a rank (a multiple of 512)
N_DEAD = 100               # global padding: the last rank's tail is dead
GRID = 32


# -- the group ---------------------------------------------------------------------
def run_group(world: int, job: str, tmp_dir: str,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run ``JOBS[job](rank, world, mesh, tmp_dir)`` on every rank of a new
    gloo
    group of ``world`` processes. -> each rank's result, in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(tmp_dir, f"store_{job}_{world}")
    outs = [os.path.join(tmp_dir, f"out_{job}_{world}_{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, job, outs[r], tmp_dir),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join(5)
    if hung:
        raise AssertionError(f"{job}: a group of {world} ran past "
                             f"{timeout} s and was killed")
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise AssertionError(f"{job}: rank {r} wrote no result (exit "
                                 f"code {procs[r].exitcode})")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise AssertionError(f"{job}: rank {r} failed:\n{res['error']}")
        results.append(res)
    return results


def _rank_main(rank: int, world: int, store: str, job: str, out: str,
               tmp_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        from particle_sim_tpu_torch.parallel import distributed, mesh

        distributed.initialize(f"file://{store}", world, rank, device="cpu",
                               timeout_s=INIT_TIMEOUT_S)
        try:
            res = JOBS[job](rank, world, mesh.make_mesh("cpu"), tmp_dir)
        finally:
            distributed.shutdown()
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    torch.save(res, out)


def shards(results: list, key: str, axis: int = -1) -> np.ndarray:
    """The global array of ``key`` from every rank's shard."""
    return np.concatenate([r[key] for r in results], axis=axis)


# -- inputs ------------------------------------------------------------------------
def inputs(world: int, seed: int = 0) -> dict:
    """The global inputs of every leg at ``world`` ranks (numpy):
    a ball of radius 40, random velocities, masses in [0.5, 2], the
    dense ball of radius 6 (the exact window's scene) and n_active."""
    from particle_sim_tpu_torch.core.params import (
        PairwiseParams, SimParams,
    )

    n = world * PER_SHARD
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = 40.0 * rng.random(n) ** (1 / 3)
    pos = (x * r[:, None]).T.astype(np.float32)             # (3, n)
    return dict(
        pos=pos, dense=(0.15 * pos).astype(np.float32),
        vel=rng.normal(scale=0.5, size=(3, n)).astype(np.float32),
        masses=rng.uniform(0.5, 2.0, n).astype(np.float32),
        n_active=n - N_DEAD,
        pv=SimParams(gravity=1.0, is_mouse_dragging=True,
                     mouse_position=(0.0, 0.0, 30.0), mouse_force=50.0,
                     mouse_radius=25.0).pack(),
        pv_pm=SimParams(delta_time=0.016).pack(),
        pp=PairwiseParams(1.0, 0.5).pack(),
        pp_pm=PairwiseParams(1.0, 4.0).pack(),
    )


def configs(world: int) -> dict:
    """The port's solver configurations of the legs (the test modules
    build the JAX ones from the same fields)."""
    from particle_sim_tpu_torch.core.params import PMConfig
    from particle_sim_tpu_torch.ops import pm2, pmx

    l1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=1.0)
    l2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
    return dict(
        pm=PMConfig(grid=GRID, softening=4.0),
        pm_auto=PMConfig(grid=GRID, softening=2.0, auto_box=True),
        pm2=l1, levels=(l1, l2),
        pmx=pmx.PMXConfig(window_size=4.0, softening=0.15,
                          capacity=PER_SHARD * world))


# -- the legs (every rank runs each in the same order) ---------------------------------
def _legs(rank: int, world: int, mesh, tmp_dir: str) -> dict:
    from particle_sim_tpu_torch.core.state import LANE
    from particle_sim_tpu_torch.parallel import (
        dp, pm_dp, pm_persist_dp, render_dp, ring,
    )
    from particle_sim_tpu_torch.render import raster
    from particle_sim_tpu_torch.render.camera import Camera

    g = inputs(world)
    cf = configs(world)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in g.items() if isinstance(v, np.ndarray)}
    lo, hi = rank * PER_SHARD, (rank + 1) * PER_SHARD
    n_act = torch.tensor(g["n_active"], dtype=torch.int32)

    def local(name):
        a = t[name]
        return a[..., lo:hi].clone()

    def planes(name):
        return local(name).reshape(3, -1, LANE)

    out = {}

    def keep(key, pos, vel):
        out[key + "_pos"] = pos.reshape(3, -1).numpy().copy()
        out[key + "_vel"] = vel.reshape(3, -1).numpy().copy()

    # dp: the attractor step, plain and on the kernel path (in place)
    for key, kern in (("dp", False), ("dp_k", True)):
        step = dp.make_sharded_step(mesh, use_kernels=kern)
        keep(key, *step(planes("pos"), planes("vel"), t["pv"]))
    out["speed"] = float(dp.make_global_mean_speed(mesh)(planes("vel")))

    # the ring, plain and kernel path, with and without masses
    for key, kern, with_m in (("ring", False, False), ("ring_m", False, True),
                              ("ring_k", True, False),
                              ("ring_km", True, True)):
        step = ring.make_ring_pairwise_step(mesh, use_kernels=kern,
                                            with_masses=with_m)
        extra = (local("masses"),) if with_m else ()
        keep(key, *step(planes("pos"), planes("vel"), t["pv"], t["pp"],
                        n_act, *extra))

    # pm_dp: plain; kernel path with masses; the auto box
    for key, cfg, kern, with_m in (("pm", cf["pm"], False, False),
                                   ("pm_km", cf["pm"], True, True),
                                   ("pm_auto", cf["pm_auto"], False, False)):
        step = pm_dp.make_pm_step(mesh, cfg, use_kernels=kern,
                                  with_masses=with_m)
        extra = (local("masses"),) if with_m else ()
        keep(key, *step(planes("pos"), planes("vel"), t["pv_pm"],
                        t["pp_pm"], n_act, *extra))

    # the persistent PM: one level, two levels, the multi-level order and
    # the window-exact correction on it (the dense ball)
    carry = None
    for key, cfg2, cfgx, src in (("persist", None, None, "pos"),
                                 ("persist2", cf["pm2"], None, "pos"),
                                 ("persistN", cf["levels"], None, "pos"),
                                 ("persistX", cf["levels"], cf["pmx"],
                                  "dense")):
        init = pm_persist_dp.make_persist_init(mesh, cf["pm"], cfg2=cfg2)
        st = init(local(src), local("vel"), n_act)
        step = pm_persist_dp.make_persist_pm_step(mesh, cf["pm"], cfg2=cfg2,
                                                  cfgx=cfgx)
        res = step(st, t["pv_pm"], t["pp_pm"], n_act)
        if cfgx is not None:
            res, counts = res
            out[key + "_counts"] = counts.numpy().copy()
        keep(key, res.pos, res.vel)
        out[key + "_ids"] = res.ids.numpy().copy()
        out[key + "_resorts"] = res.resorts
        if key == "persist":
            carry = res

    # render_dp: the identity planes, and the persistent carry (flat)
    cam = Camera(aspect=2.0)
    vp = torch.from_numpy(cam.view_proj())
    col = torch.full((3, PER_SHARD), 0.8).reshape(3, -1, LANE)
    fn = render_dp.make_render_dp(mesh, width=256, height=128)
    out["render"] = fn(planes("pos"), planes("vel"), col, t["pv"], vp,
                       n_act).numpy()
    col24 = raster.pack_col24(local("pos") / 100.0 + 0.5)
    carry = carry._replace(col24=col24.index_select(
        0, (carry.ids - lo).long()))
    flat = render_dp.make_render_dp(mesh, width=256, height=128, flat=True)
    out["render_flat"] = flat(carry.pos, carry.vel,
                              raster.unpack_col24(carry.col24), t["pv"], vp,
                              n_act).numpy()
    ident = pm_persist_dp.identity_order(mesh, carry, (carry.pos, carry.vel))
    out["render_ident"] = fn(ident[0].view(3, -1, LANE),
                             ident[1].view(3, -1, LANE),
                             raster.unpack_col24(col24).view(3, -1, LANE),
                             t["pv"], vp, n_act).numpy()
    return out


def _engine(rank: int, world: int, mesh, tmp_dir: str) -> dict:
    """The engine's mesh mode beside the single-device engine of the same
    configuration (both on every rank), the CLI's --mesh auto inside the
    group, a checkpoint and the server's refusals."""
    import contextlib
    import io

    from particle_sim_tpu_torch.app import cli, server
    from particle_sim_tpu_torch.core.params import (
        Method, PairwiseParams, SimParams,
    )
    from particle_sim_tpu_torch.core.state import ParticleState
    from particle_sim_tpu_torch.engine import Engine
    from particle_sim_tpu_torch.io import checkpoint
    from particle_sim_tpu_torch.render.camera import Camera

    cf = configs(world)
    cfg = cf["pm"]
    out = {}

    def pair(n, steps, params, single_kw=None, **kw):
        """(single, sharded) engines after ``steps`` steps each."""
        a = Engine(particle_count=n, device="cpu", method=Method.TORCH,
                   **(kw if single_kw is None else single_kw))
        b = Engine(particle_count=n, device="cpu", method=Method.TORCH,
                   mesh=mesh, **kw)
        for _ in range(steps):
            a.step(params)
            b.step(params)
        return a, b

    drag = SimParams(gravity=1.5, is_mouse_dragging=True,
                     mouse_position=(2, -3, 10), mouse_force=40.0)
    a, b = pair(4096, 4, drag)
    out["step"] = (a.state.positions(), b.state.positions(),
                   a.state.velocities(), b.state.velocities())
    out["rows"] = (b._state.pos.shape[1], b.state.pos.shape[1])

    a, b = pair(2048, 3, SimParams(), pairwise=PairwiseParams(2.0, 0.5))
    out["ring"] = (a.state.positions(), b.state.positions())
    out["ring_state"] = (b.state.pos.numpy(), b.state.vel.numpy())

    masses = np.linspace(0.5, 3.0, 3000).astype(np.float32)
    a, b = pair(3000, 2, SimParams(), pm=cfg, masses=masses)
    out["pm_masses"] = (a.state.positions(), b.state.positions(),
                        b.masses.numpy()[:3000])

    # lifecycle: step, grow, shrink, reset
    _, b = pair(3000, 1, SimParams(gravity=2.0))
    evolved = b.state.positions()
    b.resize(5000)
    grown = (b.particle_count, b.capacity, b._state.pos.shape[1],
             b.state.positions()[:3000])
    b.resize(1000)
    count_shrunk = b.particle_count
    b.reset()
    out["lifecycle"] = (evolved, grown, count_shrunk,
                        b.state.velocities())
    b.set_masses(np.full(1000, 2.0, np.float32))
    b.resize(2500)
    out["grown_masses"] = b.masses.numpy()[:2500]

    # frames: scatter and the stream from the gathered state; the
    # composite against the single engine's compact frame
    p = SimParams(color_mode=1, gravity=1.0)
    a, b = pair(world * 1024, 2, p)
    cam = Camera(aspect=2.0)
    out["scatter"] = b.render_frame(Camera(aspect=16 / 9), p, width=1280,
                                    height=720, renderer="scatter")
    out["stream"] = tuple(x.shape for x in b.frame_arrays(p, max_points=500))
    out["composite"] = (a.render_frame(cam, p, width=256, height=128,
                                       renderer="compact"),
                        b.render_frame(cam, p, width=256, height=128))
    out["untiled"] = (a.render_frame(cam, p, width=200, height=100),
                      b.render_frame(cam, p, width=200, height=100))

    # the persistent PM on the mesh: from the sorted carry, and against
    # the per-frame mesh PM
    p0 = SimParams(color_mode=0, gravity=0.0, delta_time=0.016)
    _, e = pair(world * 1024, 2, p0, pm=cfg, pm_persist=True)
    fast = e.render_frame(cam, p0, width=256, height=128)
    dirty = e._identity_dirty
    ref = e.render_frame(cam, p0, width=256, height=128, renderer="scatter")
    out["persist_frames"] = (fast, dirty, ref, e._identity_dirty)
    n = world * 1024
    ones = np.ones(n, np.float32)
    e_ref, e = pair(n, 2, p0, single_kw=dict(pm=cfg, masses=ones, mesh=mesh),
                    pm=cfg, pm_persist=True, masses=ones)
    out["persist_mesh"] = (e.state.positions(), e_ref.state.positions())
    a, b = pair(n, 2, p0, pm=cfg, pm_persist=True, pm2=cf["pm2"])
    out["persist_two_level"] = (a.state.positions(), b.state.positions())
    auto = Engine(particle_count=2048, device="cpu", pm=cfg, pm2=cf["pm2"],
                  mesh=mesh)
    out["auto_promotes"] = (auto.pm_persist, auto.persist_resolved())
    refused = []
    for kw in (dict(pm=cf["pm_auto"], pm2=cf["pm2"]),
               dict(pm=cfg, pm2=cf["pm2"], pm_persist=False),
               dict(pm=cfg, pmx=cf["pmx"]),
               dict(pm=cfg, pm2=cf["levels"],
                    pmx=dataclasses.replace(cf["pmx"], capacity=512))):
        try:
            Engine(particle_count=2048, device="cpu", mesh=mesh, **kw)
            refused.append(None)
        except ValueError as err:
            refused.append(str(err))
    out["refused"] = refused
    # the window-exact correction on the dense ball, against one device
    g = inputs(world)
    dense = ParticleState.from_arrays(
        g["dense"].T, np.zeros((n, 3), np.float32), np.full((n, 3), 0.5),
        device="cpu", row_multiple=8 * world)
    counts = []
    for m in (None, mesh):
        x = Engine(particle_count=n, device="cpu", pm=cfg, pm2=cf["levels"],
                   pmx=cf["pmx"], pm_persist=True, mesh=m)
        x.state = dense
        x.step(p0)
        counts.append((x.pmx_member_count(), x.state.positions()))
    out["pmx"] = counts

    # the server refuses what the JAX server refuses on a mesh
    srv = server.StreamServer(Engine(particle_count=2048, device="cpu",
                                     pm=cfg, mesh=mesh))
    srv._apply_pm_solver_event({"pm2_sizes": [32.0],
                                "pm2_softenings": [1.0]}, 1.0, 4.0,
                               persist=False)
    out["server_pm2"] = srv.engine.pm2

    # a checkpoint: every rank gathers, rank 0 writes
    ck = os.path.join(tmp_dir, f"mesh_{world}.npz")
    checkpoint.save(ck, b, step_index=7)
    out["checkpoint"] = (ck, b.state.positions(), b.particle_count)

    # the CLI joins the running group
    buf_out, buf_err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_out), \
            contextlib.redirect_stderr(buf_err):
        rc = cli.main(["--device", "cpu", "--count", "2000", "--steps", "10",
                       "--method", "torch", "--mesh", "auto", "--gravity",
                       "1.0", "--stats-every", "5"])
    out["cli"] = (rc, buf_out.getvalue(), buf_err.getvalue())
    return out


JOBS = {"legs": _legs, "engine": _engine}
