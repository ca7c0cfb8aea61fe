"""The port's persistent cell-sorted PM (ops/pm_persist.py) and
``pack_col24`` against the JAX package's on the CPU: the same inputs, made
with numpy from a seed, through both.

Two references for every acceleration, compared in identity order (each
side's slot order undone by its own ``ids``):
  * the JAX package's ``pm_persist.accel_sorted`` / ``accel_sorted_multi``
    / ``step_sorted`` in interpret mode, within 0.02 of max|a|: the bar
    of tests/test_pm_pallas.py for the TPU kernels (bf16 one-hots, 10-bit
    CIC fractions) against the f32 path, which tests/test_torch_pm.py
    holds the port's PM to. The JAX package's own 3e-3 holds its
    persistent path to its per-frame one, both quantized alike; the
    port's f32 path sits ~5e-3 from either at G = 32;
  * the port's own plain per-frame PM (pm.pm_accel_ref, pm2.pmn_accel_ref,
    pmx.pmx_accel on its plain versions), within 1e-5 of max|a| (the same
    f32 arithmetic in another summation order).
The port's fast path runs its kernel wrappers' plain versions here (CPU
tensors); the kernels themselves are held to these on the card by
chip_smoke.py phase 19. Small shapes: G = 32, N <= 8,192."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.ops import pm2 as jpm2
from particle_sim_tpu.ops import pm_persist as jpp
from particle_sim_tpu.ops import pmx as jpmx
from particle_sim_tpu.render import raster as jraster

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import (
    physics, pm, pm2, pm_cuda, pm_persist, pmx, step_cuda,
)
from particle_sim_tpu_torch.render import raster
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

CFG = PMConfig(grid=32, softening=4.0)
JAX_BAR = 0.02      # of max|a|: the TPU kernels against the f32 path
PLAIN_BAR = 1e-5    # of max|a|: f32 summation order only
L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=1.0)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)


def jax_cfg(cfg):
    cls = {PMConfig: JPM, pm2.PM2Config: jpm2.PM2Config,
           pmx.PMXConfig: jpmx.PMXConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def cloud(n, seed, radius=45.0, capacity=None):
    """(pos f32[3, cap] numpy, n): a ball of n points, zeros to a
    capacity that is a multiple of 512 (the state's)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
    pos = x * r[:, None]
    cap = capacity or -(-n // 512) * 512
    out = np.zeros((3, cap), np.float32)
    out[:, :n] = pos.T
    return out, n


def identity(a, ids):
    """(..., N) in slot order -> identity order."""
    out = np.zeros_like(a)
    out[..., np.asarray(ids)] = a
    return out


def scale_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_state(pos, n, cfg=CFG, **kw):
    return pm_persist.init_sorted(torch.from_numpy(pos), n, cfg, **kw)


def jax_accel(pos, n, cfg=CFG, masses=None, cfg2=None):
    """The JAX persistent path on the same identity-order input ->
    acceleration in identity order."""
    js = jpp.init_sorted(jnp.asarray(pos), jnp.int32(n), jax_cfg(cfg),
                         masses=None if masses is None
                         else jnp.asarray(masses))
    js2, acc = jpp.accel_sorted(
        js, 1.0, jax_cfg(cfg), n_active=jnp.int32(n), interpret=True,
        cfg2=None if cfg2 is None else jax_cfg(cfg2))
    return identity(np.asarray(acc), js2.ids)


def plain_accel(pos, n, cfg=CFG, masses=None):
    return pm.pm_accel_ref(torch.from_numpy(pos), n, 1.0, cfg.softening, cfg,
                           masses=None if masses is None
                           else torch.from_numpy(masses)).numpy()


def keys_of(st, n, cfg=CFG, levels=()):
    return pm_persist.state_keys(st, n, cfg, levels).numpy()


# -- the single-level persistent order ----------------------------------------------
def test_parity_fresh_sort():
    pos, n = cloud(1500, 0)
    st = port_state(pos, n)
    assert np.all(np.diff(keys_of(st, n)) >= 0)
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    assert st2.resorts == 0 and st2 is st          # sorted: no repair
    got = identity(acc.numpy(), st2.ids)
    assert scale_err(got, plain_accel(pos, n)) <= PLAIN_BAR
    assert scale_err(got, jax_accel(pos, n)) <= JAX_BAR


def test_parity_drifted_no_repair():
    """A drift well inside a cell leaves the disorder under REPAIR_SHARE:
    no repair, and the result is still the per-frame one."""
    pos, n = cloud(2000, 1)
    st = port_state(pos, n)
    rng = np.random.default_rng(2)
    drift = rng.normal(scale=0.05, size=pos.shape).astype(np.float32)
    drift[:, n:] = 0.0
    moved = pos + drift
    st = st._replace(pos=st.pos + torch.from_numpy(drift)[:, st.ids.long()])
    share = int(pm_persist.disorder(pm_persist.state_keys(st, n, CFG))) / n
    assert 0.0 < share < pm_persist.REPAIR_SHARE
    assert not bool(pm_persist.needs_repair(st, n, CFG))
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    assert st2.resorts == 0
    got = identity(acc.numpy(), st2.ids)
    assert scale_err(got, plain_accel(moved, n)) <= PLAIN_BAR
    assert scale_err(got, jax_accel(moved, n)) <= JAX_BAR


def scramble(st, seed):
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        st.pos.shape[1]))
    return st._replace(
        pos=st.pos[:, perm], vel=st.vel[:, perm], ids=st.ids[perm],
        masses=None if st.masses is None else st.masses[perm])


def test_repair_fires_on_scramble():
    """A global permutation (dead slots scattered too) passes the
    threshold: the repair restores the cell order and the live prefix,
    and the result is exact."""
    pos, n = cloud(2000, 3)
    st = scramble(port_state(pos, n), 4)
    assert bool(pm_persist.needs_repair(st, n, CFG))
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    assert st2.resorts == 1
    assert int(pm_persist.disorder(pm_persist.state_keys(st2, n, CFG))) == 0
    ids = st2.ids.numpy()
    assert (ids[:n] < n).all() and (ids[n:] >= n).all()   # live prefix
    got = identity(acc.numpy(), ids)
    assert scale_err(got, plain_accel(pos, n)) <= PLAIN_BAR
    assert scale_err(got, jax_accel(pos, n)) <= JAX_BAR


def test_forced_repair_flags():
    """repair=False on a scrambled state still computes the right field
    (liveness rides ids, not the slot); repair=True on a sorted one
    re-sorts (resorts + 1) without changing the order."""
    pos, n = cloud(1200, 5)
    st = port_state(pos, n)
    sc = scramble(st, 6)
    st_f, acc_f = pm_persist.accel_sorted(sc, 1.0, CFG, n_active=n,
                                          repair=False)
    assert st_f is sc
    assert scale_err(identity(acc_f.numpy(), sc.ids),
                     plain_accel(pos, n)) <= PLAIN_BAR
    st_t, _ = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n, repair=True)
    assert st_t.resorts == 1
    np.testing.assert_array_equal(st_t.ids.numpy(), st.ids.numpy())


def test_partial_active_padding_inert():
    """Dead slots (ids >= n_active), poisoned with in-box positions,
    deposit nothing and get exactly 0."""
    pos, n = cloud(900, 5, capacity=2048)
    st = port_state(pos, n)
    poison = torch.where(st.ids[None] < n, st.pos, torch.tensor(1.5))
    st = st._replace(pos=poison)
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    dead = st2.ids.numpy() >= n
    assert dead.sum() == 2048 - 900
    assert np.all(acc.numpy()[:, dead] == 0.0)
    got = identity(acc.numpy(), st2.ids)
    assert scale_err(got[:, :n], plain_accel(pos, n)[:, :n]) <= PLAIN_BAR
    assert scale_err(got[:, :n], jax_accel(pos, n)[:, :n]) <= JAX_BAR


def test_step_sorted_matches_step_pm():
    """One frame on the persistent state equals the per-frame PM step
    (pm_cuda.step_pm) modulo the slot order; against the JAX step_sorted
    at its own bars (its un-sort pack quantizes the acceleration)."""
    n = 1024
    pos, _ = cloud(n, 6, radius=30.0)
    vel = np.random.default_rng(7).normal(scale=0.5, size=pos.shape).astype(
        np.float32)
    pv = SimParams(delta_time=0.016, gravity=0.0).pack()
    pp = PairwiseParams(1.0, CFG.softening).pack()
    planes_p = torch.from_numpy(pos.copy()).view(3, -1, 128)
    planes_v = torch.from_numpy(vel.copy()).view(3, -1, 128)
    pm_cuda.step_pm(planes_p, planes_v, torch.from_numpy(pv),
                    torch.from_numpy(pp), n, CFG)
    st = port_state(pos, n, vel_flat=torch.from_numpy(vel))
    st2 = pm_persist.step_sorted(st, torch.from_numpy(pv),
                                 torch.from_numpy(pp), n, CFG)
    p_id = identity(st2.pos.numpy(), st2.ids)
    v_id = identity(st2.vel.numpy(), st2.ids)
    np.testing.assert_allclose(p_id, planes_p.reshape(3, -1).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(v_id, planes_v.reshape(3, -1).numpy(),
                               rtol=0, atol=1e-4)
    js = jpp.init_sorted(jnp.asarray(pos), jnp.int32(n), jax_cfg(CFG),
                         vel_flat=jnp.asarray(vel))
    js2 = jpp.step_sorted(js, jnp.asarray(pv), jnp.asarray(pp),
                          jnp.int32(n), jax_cfg(CFG), interpret=True)
    np.testing.assert_allclose(p_id, identity(np.asarray(js2.pos), js2.ids),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(v_id, identity(np.asarray(js2.vel), js2.ids),
                               rtol=0, atol=5e-2)


def test_plain_path_matches_fast_path():
    """use_fast=False (accel_sorted_ref, radix_sort_ref) against the
    wrappers' path, both after the same repair."""
    pos, n = cloud(1500, 8)
    st = scramble(port_state(pos, n), 9)
    st_a, acc_a = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    st_b, acc_b = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n,
                                          use_fast=False)
    np.testing.assert_array_equal(st_a.ids.numpy(), st_b.ids.numpy())
    assert scale_err(acc_a.numpy(), acc_b.numpy()) <= PLAIN_BAR


@pytest.mark.parametrize("case", ["unit", "masses", "traced_engine", "cfg2",
                                  "levels", "levels_pmx",
                                  "traced_engine_pm2"])
def test_step_sorted_two_launch_tail(case):
    """Every frame on the kernels' wrappers ends in the PM step's tail
    (the raw field of its layers, the momentum mean, then the clean, the
    G scale and the kick in one step-kernel launch): on CPU tensors bit
    for bit the chain of accel_sorted's / accel_sorted_multi's cleaned,
    scaled acceleration and physics.kick_and_step_planes, on a scrambled
    live mask, with no launch counted; with one refinement level
    (cfg2), two (levels) and two with the exact window (levels_pmx, the
    same member count). traced_engine(_pm2): a traced persistent engine
    on the kernels' wrappers, without and with a refinement level,
    counts pm.kick_fused once a step."""
    launches = (pm_cuda.MOMENTUM_LAUNCHES, pm_cuda.KICK_FUSED_LAUNCHES,
                step_cuda.LAUNCHES)
    pv = SimParams(delta_time=0.016, is_mouse_dragging=True,
                   mouse_position=(4.0, 2.0, -6.0), mouse_force=30.0,
                   mouse_radius=20.0).pack()
    pv = torch.from_numpy(pv)
    pp = torch.from_numpy(PairwiseParams(0.8, CFG.softening).pack())
    if case.startswith("traced_engine"):
        e = Engine(particle_count=4096, device="cpu", method=Method.TORCH,
                   pm=CFG, pm_persist=True,
                   pm2=L1 if case.endswith("pm2") else None)
        # the kernels' wrappers, which take their plain versions here
        e.method = Method.CUDA
        trace.reset()
        trace.enable()
        try:
            for _ in range(3):
                e.step(SimParams(delta_time=0.016))
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        assert counts.get("pm.kick_fused") == 3, counts
    else:
        n = 1500
        pos, _ = cloud(n, 31, capacity=2048)
        if case.startswith("levels"):
            pos, n = clump_scene(17)
        rng = np.random.default_rng(32)
        vel = torch.from_numpy(rng.normal(size=pos.shape).astype(np.float32))
        masses = None
        if case in ("masses", "levels_pmx"):
            masses = torch.from_numpy(
                (rng.random(pos.shape[1]) + 0.5).astype(np.float32))
        cfg2 = {"cfg2": L1, "levels": (L1, L2),
                "levels_pmx": (L1, L2)}.get(case)
        cfgx = PMX_WINDOW if case == "levels_pmx" else None
        if isinstance(cfg2, tuple):
            st = scramble(pm_persist.init_sorted_multi(
                torch.from_numpy(pos), n, CFG, cfg2, vel_flat=vel,
                masses=masses), 33)
            st_a, acc, *n_m = pm_persist.accel_sorted_multi(
                st, pp[0], CFG, cfg2, n_active=n, cfgx=cfgx, repair=False)
        else:
            st = scramble(port_state(pos, n, vel_flat=vel, masses=masses,
                                     cfg2=cfg2), 33)
            st_a, acc = pm_persist.accel_sorted(st, pp[0], CFG, n_active=n,
                                                cfg2=cfg2, repair=False)
        want_p, want_v = physics.kick_and_step_planes(
            st_a.pos, st_a.vel, acc, pv)
        got = pm_persist.step_sorted(
            st._replace(pos=st.pos.clone(), vel=st.vel.clone()), pv, pp, n,
            CFG, cfg2=cfg2, cfgx=cfgx, repair=False)
        if cfgx is not None:
            got, got_m = got
            assert int(got_m) == int(n_m[0]) > 0
        assert torch.equal(got.ids, st.ids)
        assert torch.equal(got.pos, want_p) and torch.equal(got.vel, want_v)
    assert launches == (pm_cuda.MOMENTUM_LAUNCHES,
                        pm_cuda.KICK_FUSED_LAUNCHES, step_cuda.LAUNCHES)


def test_masses_ride_repairs():
    pos, n = cloud(1024, 8)
    m = np.random.default_rng(9).uniform(0.5, 2.0, pos.shape[1]).astype(
        np.float32)
    st = scramble(port_state(pos, n, masses=torch.from_numpy(m)), 10)
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n)
    assert st2.resorts == 1
    np.testing.assert_array_equal(identity(st2.masses.numpy(), st2.ids), m)
    got = identity(acc.numpy(), st2.ids)
    assert scale_err(got, plain_accel(pos, n, masses=m)) <= PLAIN_BAR
    assert scale_err(got, jax_accel(pos, n, masses=m)) <= JAX_BAR


def test_unsort_roundtrip():
    pos, n = cloud(600, 11)
    col = np.random.default_rng(12).random(pos.shape).astype(np.float32)
    st = port_state(pos, n, col24=raster.pack_col24(torch.from_numpy(col)))
    assert not np.array_equal(st.pos.numpy(), pos)
    back_p, back_c = pm_persist.unsort(st, (st.pos, st.col24))
    np.testing.assert_array_equal(back_p.numpy(), pos)
    np.testing.assert_array_equal(back_c.numpy(),
                                  raster.pack_col24(torch.from_numpy(col)))


def test_periodic_boundary_parity():
    cfg = PMConfig(grid=32, softening=4.0, boundary="periodic")
    pos, n = cloud(1200, 12)
    st2, acc = pm_persist.accel_sorted(port_state(pos, n, cfg), 1.0, cfg,
                                       n_active=n)
    got = identity(acc.numpy(), st2.ids)
    assert scale_err(got, plain_accel(pos, n, cfg)) <= PLAIN_BAR
    assert scale_err(got, jax_accel(pos, n, cfg)) <= JAX_BAR


@pytest.mark.parametrize("cfg, cap, match", [
    (PMConfig(grid=32, softening=4.0, auto_box=True), 1024, "static box"),
    (PMConfig(grid=32, softening=4.0), 1000, "multiple of 512"),
    (PMConfig(grid=48, softening=4.0), 1024, "grids")])
def test_rejects_bad_config(cfg, cap, match):
    """As the JAX init_sorted raises (auto_box, capacity, grid)."""
    pos = torch.zeros((3, cap))
    with pytest.raises(ValueError, match=match):
        pm_persist.init_sorted(pos, 10, cfg)
    jcfg = jax_cfg(cfg)
    with pytest.raises(ValueError):
        jpp.init_sorted(jnp.zeros((3, cap), jnp.float32), jnp.int32(10),
                        jcfg)


# -- refinement levels on the class order -----------------------------------------
def clump_scene(seed=13, n_core=1200, n_halo=2400):
    """A clump at (5, 4, -3) in a halo, padded to a multiple of 512."""
    rng = np.random.default_rng(seed)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + np.float32(off)

    p = np.concatenate([ball(n_core, 3.0, (5.0, 4.0, -3.0)),
                        ball(n_halo, 40.0, (0.0, 0.0, 0.0))])
    n = p.shape[0]
    cap = -(-n // 512) * 512
    out = np.zeros((3, cap), np.float32)
    out[:, :n] = p.T
    return out, n


def test_two_level_parity():
    """One refinement level (the JAX two-level segmented order): the class
    order holds the window's members as a tail class; against
    pm2.pm2_accel_ref and the JAX accel_sorted(cfg2)."""
    pos, n = clump_scene()
    st = port_state(pos, n)
    st2, acc = pm_persist.accel_sorted(st, 1.0, CFG, n_active=n, cfg2=L1,
                                       repair=True)
    assert st2.resorts == 1
    key = keys_of(st2, n, levels=(L1,))
    assert np.all(np.diff(key) >= 0)
    flag = 2 * CFG.grid ** 3
    assert int(st2.fine_b) == int((key < flag).sum())
    assert st2.fine_b.shape == ()
    got = identity(acc.numpy(), st2.ids)
    want = pm2.pm2_accel_ref(torch.from_numpy(pos), n, 1.0, CFG, L1).numpy()
    assert scale_err(got, want) <= PLAIN_BAR
    assert scale_err(got, jax_accel(pos, n, cfg2=L1)) <= JAX_BAR


def test_multi_level_parity():
    """Two levels on the k+1-class order: init_sorted_multi sorts into it
    (fine_b the class boundaries, no repair needed); against
    pmn_accel_ref and the JAX accel_sorted_multi (whose first frame
    repairs into the same order)."""
    pos, n = clump_scene(14)
    levels = (L1, L2)
    st = pm_persist.init_sorted_multi(torch.from_numpy(pos), n, CFG, levels)
    key = keys_of(st, n, levels=levels)
    assert np.all(np.diff(key) >= 0)
    flag = 2 * CFG.grid ** 3
    assert st.fine_b.tolist() == [int((key < flag).sum()),
                                  int((key < 2 * flag).sum())]
    assert st.fine_b.tolist()[0] < st.fine_b.tolist()[1] < n
    st2, acc = pm_persist.accel_sorted_multi(st, 1.0, CFG, levels,
                                             n_active=n)
    assert st2 is st and st2.resorts == 0
    got = identity(acc.numpy(), st2.ids)
    want = pm2.pmn_accel_ref(torch.from_numpy(pos), n, 1.0, CFG,
                             levels).numpy()
    assert scale_err(got, want) <= PLAIN_BAR
    jl = tuple(jax_cfg(c) for c in levels)
    js = jpp.init_sorted_multi(jnp.asarray(pos), jnp.int32(n), jax_cfg(CFG),
                               2)
    js2, jacc = jpp.accel_sorted_multi(js, 1.0, jax_cfg(CFG), jl,
                                       n_active=jnp.int32(n), interpret=True)
    assert int(js2.resorts) == 1
    np.testing.assert_array_equal(np.asarray(js2.fine_b), st.fine_b.numpy())
    assert scale_err(got, identity(np.asarray(jacc), js2.ids)) <= JAX_BAR
    with pytest.raises(ValueError, match="fine_b"):
        pm_persist.accel_sorted_multi(port_state(pos, n), 1.0, CFG, levels,
                                      n_active=n)


@pytest.mark.parametrize("levels", [(L1,), (L1, L2)],
                         ids=["cfg2", "multi"])
def test_init_sorts_into_the_class_order(levels):
    """A fresh state with levels is the class order a repair of the
    identity order makes (the sort is stable): the same slots, the same
    fine_b, and no repair counted."""
    pos, n = clump_scene(16)
    p = torch.from_numpy(pos)
    cap = pos.shape[1]
    if len(levels) == 1:
        fresh = pm_persist.init_sorted(p, n, CFG, cfg2=levels[0])
        fine_shape = ()
    else:
        fresh = pm_persist.init_sorted_multi(p, n, CFG, levels)
        fine_shape = (len(levels),)
    ident = pm_persist.SortedPMState(
        p, torch.zeros_like(p), torch.arange(cap, dtype=torch.int32), None,
        0, torch.full(fine_shape, cap, dtype=torch.int32))
    rep = pm_persist.repair_state(ident, n, CFG, levels)
    assert fresh.resorts == 0 and rep.resorts == 1
    np.testing.assert_array_equal(fresh.ids.numpy(), rep.ids.numpy())
    np.testing.assert_array_equal(fresh.fine_b.numpy(), rep.fine_b.numpy())
    np.testing.assert_array_equal(fresh.pos.numpy(), rep.pos.numpy())
    assert int(pm_persist.disorder(pm_persist.state_keys(
        fresh, n, CFG, levels))) == 0


PMX_WINDOW = pmx.PMXConfig(window_size=4.0, softening=0.1, capacity=2048)


def test_multi_level_pmx_matches_per_frame():
    """pmx on the class order: ops/pmx.py unchanged on the sorted planes;
    the member count and the acceleration equal the per-frame pmx_accel's
    (plain) when the capacity holds every member."""
    pos, n = clump_scene(15)
    levels = (L1, L2)
    st = pm_persist.init_sorted_multi(torch.from_numpy(pos), n, CFG, levels)
    st2, acc, n_m = pm_persist.accel_sorted_multi(
        st, 1.0, CFG, levels, n_active=n, cfgx=PMX_WINDOW, repair=True)
    want, n_w = pmx.pmx_accel(torch.from_numpy(pos), n, 1.0, CFG, levels,
                              PMX_WINDOW, use_fast=False)
    assert 0 < int(n_m) == int(n_w) <= PMX_WINDOW.capacity
    assert scale_err(identity(acc.numpy(), st2.ids), want.numpy()) \
        <= PLAIN_BAR
    with pytest.raises(ValueError, match="MULTI-level"):
        pm_persist.step_sorted(st2, torch.from_numpy(SimParams().pack()),
                               torch.tensor([1.0, 4.0]), n, CFG, cfg2=L1,
                               cfgx=PMX_WINDOW)


def test_multi_level_pmx_matches_jax():
    """pmx on the class order against the JAX accel_sorted_multi(cfgx) in
    interpret mode, on its first frame: right after its class repair, so
    its frozen membership is the current one. Its member counts
    (n_members, n_corrected) both equal the port's count (the capacity
    holds every member); the accelerations in identity order within
    JAX_BAR of max|a| (the mesh's quantization; both exact corrections
    are f32)."""
    pos, n = clump_scene(15)
    levels = (L1, L2)
    st = pm_persist.init_sorted_multi(torch.from_numpy(pos), n, CFG, levels)
    st2, acc, n_m = pm_persist.accel_sorted_multi(
        st, 1.0, CFG, levels, n_active=n, cfgx=PMX_WINDOW)
    js = jpp.init_sorted_multi(jnp.asarray(pos), jnp.int32(n), jax_cfg(CFG),
                               2)
    js2, jacc, jcounts = jpp.accel_sorted_multi(
        js, 1.0, jax_cfg(CFG), tuple(jax_cfg(c) for c in levels),
        n_active=jnp.int32(n), cfgx=jax_cfg(PMX_WINDOW), interpret=True)
    assert int(js2.resorts) == 1
    n_members, n_corr = np.asarray(jcounts).tolist()
    assert 0 < int(n_m) == n_members == n_corr <= PMX_WINDOW.capacity
    assert scale_err(identity(acc.numpy(), st2.ids),
                     identity(np.asarray(jacc), js2.ids)) <= JAX_BAR


def test_disorder_counts_decreases():
    key = torch.tensor([0, 1, 5, 3, 3, 7, 2, 9, 9], dtype=torch.int32)
    assert int(pm_persist.disorder(key)) == 2
    assert int(pm_persist.disorder(torch.arange(10, dtype=torch.int32))) == 0


def test_repair_trigger_reads_each_verdict_once():
    """A verdict is read once; while one is unread a new measure queues
    nothing (its verdict is not even made)."""
    trig = pm_persist.RepairTrigger(torch.device("cpu"))
    assert trig.due() is False
    assert trig.measure(lambda: torch.tensor(True)) is True
    assert trig.measure(lambda: pytest.fail("made while one is unread")) \
        is False
    assert trig.due() is True
    assert trig.due() is False
    assert trig.measure(lambda: torch.tensor(False)) is True
    assert trig.due() is False


def test_pack_col24_bit_exact():
    rng = np.random.default_rng(30)
    col = rng.random((3, 4096)).astype(np.float32) * 1.2 - 0.1
    edges = np.float32([0.0, 1.0, -0.0, 0.5 / 255, 1.5 / 255, 254.5 / 255,
                        np.nextafter(np.float32(0.5 / 255), 1),
                        np.nextafter(np.float32(0.5 / 255), 0)])
    col[:, :edges.size] = edges
    ours = raster.pack_col24(torch.from_numpy(col))
    theirs = np.asarray(jraster.pack_col24(jnp.asarray(col)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        raster.unpack_col24(ours).numpy(),
        np.asarray(jraster.unpack_col24(jnp.asarray(theirs))))
