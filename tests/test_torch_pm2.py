"""The port's multi-level particle mesh (ops/pm2.py, the difference solves
of ops/pm.py, Engine(pm2=...)) against the JAX package's on the CPU: the
same inputs, made with numpy from a seed, through both. The port's
kernel path (pm2_accel, pmn_accel) runs its wrappers' plain versions here
(CPU tensors); the JAX fast path runs in interpret mode, as its own tests
run it. Small grids (G = 32): the accuracy bars of tests/test_pm2.py at
G = 128 are held on the card by chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.ops import pm as jpm
from particle_sim_tpu.ops import pm2 as jpm2

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm, pm2

torch.set_num_threads(1)

CFG = PMConfig(grid=32, softening=3.0)
CORE = np.array([5.0, 4.0, -3.0], np.float32)
L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.25)
S1 = pm2.PM2Config(window_min=(-12.0, -12.0, -19.0), window_size=32.0,
                   softening=0.75)
S2 = pm2.PM2Config(window_min=(1.0, 0.0, -7.0), window_size=8.0,
                   softening=0.25, margin=0.5)


def jax_cfg(cfg):
    """The JAX package's config of the same fields."""
    cls = {PMConfig: JPM, pm2.PM2Config: jpm2.PM2Config}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def jax_levels(levels):
    return tuple(jax_cfg(c) for c in levels)


def scene(seed=0, n_core=1500, n_clump=2000, n_halo=1000):
    """tests/test_pmn.py's scene: a dense core (r 1.2) and a clump (r 5)
    around CORE, a halo (r 45); padded to a multiple of 512 with zeros.
    -> (pos f32[3, cap], n)."""
    rng = np.random.default_rng(seed)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    pos = np.concatenate([cloud(n_core, 1.2, CORE), cloud(n_clump, 5.0, CORE),
                          cloud(n_halo, 45.0)])
    n = pos.shape[0]
    cap = -(-n // 512) * 512
    pos = np.concatenate([pos, np.zeros((cap - n, 3), np.float32)])
    return np.ascontiguousarray(pos.T), n


def masses_for(cap, seed=1):
    m = (np.random.default_rng(seed).random(cap) + 0.5).astype(np.float32)
    m[:20] = 40.0
    return m


def scale_err(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- spectra and solves -------------------------------------------------------------
@pytest.mark.parametrize("gradient", ["exact", "fd"])
def test_diff_spectra_bit_identical(gradient):
    ours = pm._isolated_diff_kernels_host(32, 0.75, 0.5, 3.0, gradient)
    theirs = jpm._isolated_diff_kernels_host(32, 0.75, 0.5, 3.0, gradient)
    assert len(ours) == len(theirs) == (1 if gradient == "fd" else 3)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)
    dev = pm.diff_kernels_device(32, 0.75, 0.5, 3.0, gradient)
    assert pm.diff_kernels_device(32, 0.75, 0.5, 3.0, gradient) is dev
    for a, b in zip(dev, theirs):
        assert a.dtype == torch.complex64
        np.testing.assert_array_equal(a.numpy(), b)
    levels = pm2.levels_kernels(CFG, (L1, L2))
    want = (pm.diff_kernels_device(32, 1.0, 0.75, 3.0),
            pm.diff_kernels_device(32, 0.25, 0.25, 0.75))
    assert all(a is b for a, b in zip(levels, want))


def test_diff_spectra_share_the_bounded_cache():
    """Base and difference spectra share one LRU cache: swapping stacks
    evicts, never grows past DEVICE_CACHE_SIZE."""
    pm._DEVICE_KERNELS.clear()
    base = pm.base_kernels_device(CFG, CFG.softening)
    for size in range(8, 8 + 4 * pm.DEVICE_CACHE_SIZE, 4):
        lv = (pm2.PM2Config(None, float(size), 0.5),
              pm2.PM2Config(None, size / 4.0, 0.25))
        pm2.levels_kernels(CFG, lv)
        pm.base_kernels_device(CFG, CFG.softening)     # in use every step
        assert len(pm._DEVICE_KERNELS) <= pm.DEVICE_CACHE_SIZE
    assert pm.base_kernels_device(CFG, CFG.softening) is base
    assert sum(k[0] == "diff" for k in pm._DEVICE_KERNELS) \
        == pm.DEVICE_CACHE_SIZE - 1
    pm._DEVICE_KERNELS.clear()


@pytest.mark.parametrize("gradient", ["exact", "fd"])
def test_solve_accel_diff_matches_jax(gradient):
    rho = np.random.default_rng(3).random((32, 32, 32)).astype(np.float32)
    want = np.asarray(jpm.solve_accel_diff(jnp.asarray(rho), 32, 0.75, 0.5,
                                           3.0, gradient))
    got = pm.solve_accel_diff(torch.from_numpy(rho), 32, 0.75, 0.5, 3.0,
                              gradient)
    assert got.shape == want.shape == (3, 32, 32, 32)
    assert not got.is_contiguous()          # the interleaved view
    # torch's CPU FFT and XLA's round differently: 1e-5 of the scale
    assert scale_err(got.numpy(), want) <= 1e-5


def test_solve_accel_pair_matches_jax():
    rng = np.random.default_rng(4)
    rho = rng.random((32, 32, 32)).astype(np.float32)
    rho2 = rng.random((32, 32, 32)).astype(np.float32)
    k2 = pm2.fine_kernels(CFG, L1)
    jk2 = jpm2.fine_kernels(jax_cfg(CFG), jax_cfg(L1))
    want = jpm.solve_accel_pair(jnp.asarray(rho), jnp.asarray(rho2),
                                jax_cfg(CFG), CFG.softening, jk2)
    got = pm.solve_accel_pair(torch.from_numpy(rho), torch.from_numpy(rho2),
                              CFG, CFG.softening, k2)
    for g, w in zip(got, want):
        assert scale_err(g.numpy(), np.asarray(w)) <= 1e-5
    # the batched transforms give the two separate solves' values
    one = pm.solve_accel(torch.from_numpy(rho), CFG, CFG.softening)
    two = pm.solve_accel_diff(torch.from_numpy(rho2), 32, 1.0, 0.75, 3.0)
    assert scale_err(got[0].numpy(), one.numpy()) <= 1e-6
    assert scale_err(got[1].numpy(), two.numpy()) <= 1e-6


# -- windows and validation ----------------------------------------------------------
@pytest.mark.parametrize("case", ["static", "tracked", "tracked_masses",
                                  "tracked_live"])
def test_window_min_matches_jax(case):
    pos, n = scene(2)
    cap = pos.shape[1]
    cfg2 = S1 if case == "static" else L1
    m = masses_for(cap) if case == "tracked_masses" else None
    live = np.arange(cap) < n
    if case == "tracked_live":
        live &= np.arange(cap) % 3 != 0
    jlive = jnp.asarray(live) if case == "tracked_live" else None
    tlive = torch.from_numpy(live) if case == "tracked_live" else None
    want = np.asarray(jpm2.window_min(
        jnp.asarray(pos), jnp.int32(n), jax_cfg(cfg2),
        None if m is None else jnp.asarray(m), live=jlive))
    got = pm2.window_min(torch.from_numpy(pos), n, cfg2,
                         None if m is None else torch.from_numpy(m),
                         live=tlive).numpy()
    assert got.dtype == np.float32 and got.shape == (3,)
    if case == "static":
        np.testing.assert_array_equal(got, want)
    else:
        # f32 sums in another order: window_min's bar (test_pm2.py:205)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("levels", [(S1, S2), (L1, L2), (S1, L2), (L1, S2)],
                         ids=["static", "tracked", "static_tracked",
                              "tracked_static"])
def test_nested_wmins_match_jax(levels):
    pos, n = scene(3)
    cap = pos.shape[1]
    m = masses_for(cap)
    live = np.arange(cap) < n
    want = jpm2._nested_wmins(jnp.asarray(pos), jnp.asarray(live),
                              jax_cfg(CFG), jax_levels(levels),
                              jnp.asarray(m))
    got = pm2._nested_wmins(torch.from_numpy(pos), torch.from_numpy(live),
                            CFG, levels, torch.from_numpy(m))
    for g, w, c2 in zip(got, want, levels):
        if all(c.window_min is not None for c in levels):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-3)
    # each window inside its parent's margin-shrunk source mask
    w1, w2 = (g.numpy().astype(np.float64) for g in got)
    lo = w1 + levels[0].margin
    hi = w1 + levels[0].window_size - levels[0].margin
    assert (w2 >= lo - 1e-5).all() and (w2 + levels[1].window_size
                                        <= hi + 1e-5).all()


BAD_STACKS = {
    "empty": (),
    "softening": (L1, pm2.PM2Config(None, 8.0, softening=0.75)),
    "coarse softening": (pm2.PM2Config(None, 32.0, softening=3.0),),
    "too large": (L1, pm2.PM2Config(None, 40.0, softening=0.25)),
    "margin": (pm2.PM2Config(None, 32.0, 0.75, margin=13.0), L2),
    "static apart": (pm2.PM2Config((-16.0,) * 3, 32.0, 0.75),
                     pm2.PM2Config((20.0,) * 3, 8.0, 0.25)),
}


@pytest.mark.parametrize("case", list(BAD_STACKS))
def test_validation_errors_match_jax(case):
    """The same ValueError, word for word, from the same call."""
    levels = BAD_STACKS[case]
    pos, n = scene(5)
    with pytest.raises(ValueError) as want:
        jpm2.pmn_accel_ref(jnp.asarray(pos), jnp.int32(n), 1.0,
                           jax_cfg(CFG), jax_levels(levels))
    with pytest.raises(ValueError) as got:
        pm2.pmn_accel_ref(torch.from_numpy(pos), n, 1.0, CFG, levels)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)[:20]):
        pm2.pmn_accel(torch.from_numpy(pos), n, 1.0, CFG, levels)


def test_rejects_auto_box():
    pos, n = scene(5)
    with pytest.raises(ValueError, match="static"):
        pm2.pm2_accel(torch.from_numpy(pos), n, 1.0,
                      PMConfig(grid=32, softening=3.0, auto_box=True), L1)


# -- the solvers ------------------------------------------------------------------
@pytest.mark.parametrize("levels,with_masses", [
    ((S1,), False), ((S1,), True), ((S1, S2), False), ((S1, S2), True)],
    ids=["pm2", "pm2_masses", "pmn", "pmn_masses"])
def test_ref_matches_jax_static(levels, with_masses):
    """pm2_accel_ref / pmn_accel_ref on static windows: 1e-4 of the scale
    (the plain PM's bar, tests/test_torch_pm.py)."""
    pos, n = scene(6)
    m = masses_for(pos.shape[1]) if with_masses else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    if len(levels) == 1:
        want = jpm2.pm2_accel_ref(jnp.asarray(pos), jnp.int32(n), 1.3,
                                  jax_cfg(CFG), jax_cfg(levels[0]),
                                  masses=jm)
        got = pm2.pm2_accel_ref(torch.from_numpy(pos), n, 1.3, CFG,
                                levels[0], masses=tm)
    else:
        want = jpm2.pmn_accel_ref(jnp.asarray(pos), jnp.int32(n), 1.3,
                                  jax_cfg(CFG), jax_levels(levels),
                                  masses=jm)
        got = pm2.pmn_accel_ref(torch.from_numpy(pos), n, 1.3, CFG, levels,
                                masses=tm)
    got, want = got.numpy(), np.asarray(want)
    assert scale_err(got, want) <= 1e-4
    assert (got[:, n:] == 0).all()


def test_ref_matches_jax_tracked():
    """Tracked windows: the origins are f32 sums in another order
    (window_min's bar, 1e-3); the forces are held to the JAX fast path's
    bar, 0.02 of the scale (test_pmn.py:109)."""
    pos, n = scene(7)
    want = np.asarray(jpm2.pmn_accel_ref(jnp.asarray(pos), jnp.int32(n),
                                         1.0, jax_cfg(CFG),
                                         jax_levels((L1, L2))))
    got = pm2.pmn_accel_ref(torch.from_numpy(pos), n, 1.0, CFG,
                            (L1, L2)).numpy()
    assert scale_err(got, want) <= 0.02


@pytest.mark.parametrize("levels", [(L1,), (L1, L2)], ids=["pm2", "pmn"])
def test_kernel_path_matches_jax_fast_path(levels):
    """The port's kernel path (its wrappers' plain versions here) against
    the JAX fast path in interpret mode: 0.02 of the scale, the bar of
    test_pm2.py:97 and test_pmn.py:109; against the port's own plain
    path 1e-4 (the CUDA kernels' summation order is the only difference
    on the card)."""
    pos, n = scene(8)
    m = masses_for(pos.shape[1])
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    want = np.asarray(jpm2.pmn_accel(jnp.asarray(pos), jnp.int32(n), 1.0,
                                     jax_cfg(CFG), jax_levels(levels),
                                     masses=jnp.asarray(m), interpret=True))
    got = pm2.pmn_accel(tp, n, 1.0, CFG, levels, masses=tm).numpy()
    assert scale_err(got, want) <= 0.02
    plain = pm2.pmn_accel_ref(tp, n, 1.0, CFG, levels, masses=tm).numpy()
    assert scale_err(got, plain) <= 1e-4
    if len(levels) == 1:
        assert np.array_equal(
            pm2.pm2_accel(tp, n, 1.0, CFG, levels[0], masses=tm).numpy(), got)


def test_one_level_is_pm2():
    """pmn with a single level is the two-level function, bit for bit
    (test_pmn.py:75-81), on both paths."""
    pos, n = scene(1)
    tp = torch.from_numpy(pos)
    assert torch.equal(pm2.pm2_accel_ref(tp, n, 1.0, CFG, L1),
                       pm2.pmn_accel_ref(tp, n, 1.0, CFG, (L1,)))
    assert torch.equal(pm2.pm2_accel(tp, n, 1.0, CFG, L1),
                       pm2.pmn_accel(tp, n, 1.0, CFG, (L1,)))


@pytest.mark.parametrize("fast", [False, True], ids=["ref", "kernel_path"])
def test_momentum_conserved(fast):
    """test_pm2.py:101-105 (and test_pmn.py:112-117) on the port."""
    pos, n = scene(4)
    fn = pm2.pmn_accel if fast else pm2.pmn_accel_ref
    for levels in ((L1,), (L1, L2)):
        a = fn(torch.from_numpy(pos), n, 1.0, CFG, levels).numpy()[:, :n]
        typical = np.abs(a).max()
        assert np.abs(a.sum(axis=1)).max() < 1e-3 * typical * n ** 0.5


@pytest.mark.parametrize("fast", [False, True], ids=["ref", "kernel_path"])
def test_outside_window_is_coarse_plus_constant(fast):
    """test_pm2.py:72-86: outside the window the two-level field is the
    coarse one plus the constant momentum-clean shift."""
    pos, n = scene(1, n_core=0, n_clump=3000, n_halo=1000)
    cfg2 = pm2.PM2Config(window_min=(-16.0,) * 3, window_size=32.0,
                         softening=0.75)
    tp = torch.from_numpy(pos)
    fn = pm2.pm2_accel if fast else pm2.pm2_accel_ref
    a2 = fn(tp, n, 1.0, CFG, cfg2).numpy()[:, :n]
    a_coarse = pm.pm_accel_ref(tp, n, 1.0, CFG.softening, CFG).numpy()[:, :n]
    out = ~np.all((pos[:, :n] >= -16) & (pos[:, :n] < 16), axis=0)
    assert out.sum() > 500
    diff = a2[:, out] - a_coarse[:, out]
    scale = np.abs(a_coarse).max()
    assert diff.std(axis=1).max() < 1e-4 * scale
    assert np.abs(diff).max() < 0.05 * scale


def test_dead_and_far_particles_never_reach_the_fine_grid():
    """Dead slots (and live particles far outside every window) clamp onto
    the window's faces in cell space: their weight is 0 through the live
    mask, so huge positions in the padding change nothing."""
    pos, n = scene(9)
    poisoned = pos.copy()
    poisoned[:, n:] = np.float32(3e37)
    clean = pm2.pmn_accel(torch.from_numpy(pos), n, 1.0, CFG, (L1, L2))
    dirty = pm2.pmn_accel(torch.from_numpy(poisoned), n, 1.0, CFG, (L1, L2))
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)
    assert (dirty[:, n:] == 0).all()


def test_step_pmn_matches_jax():
    """One frame of step_pm2 / step_pmn (plain path) against the JAX
    step's, and the kernel path steps in place."""
    pos, n = scene(10)
    shape = (3, pos.shape[1] // 128, 128)
    vel = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    pv = SimParams(delta_time=0.016, gravity=0.3).pack()
    pp = np.float32([1.2, CFG.softening])
    want = jpm2.step_pmn(jnp.asarray(pos.reshape(shape)), jnp.asarray(vel),
                         jnp.asarray(pv), jnp.asarray(pp), jnp.int32(n),
                         jax_cfg(CFG), jax_levels((S1, S2)), use_fast=False)
    args = (torch.from_numpy(pv), torch.from_numpy(pp), n, CFG)
    got = pm2.step_pmn(torch.from_numpy(pos.reshape(shape).copy()),
                       torch.from_numpy(vel), *args, (S1, S2),
                       use_fast=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)
    p, v = (torch.from_numpy(pos.reshape(shape).copy()),
            torch.from_numpy(vel.copy()))
    out = pm2.step_pm2(p, v, *args, S1)
    assert out[0] is p and out[1] is v
    ref = pm2.step_pm2(torch.from_numpy(pos.reshape(shape).copy()),
                       torch.from_numpy(vel), *args, S1, use_fast=False)
    np.testing.assert_allclose(p.numpy(), ref[0].numpy(), atol=1e-5)


# -- the engine -----------------------------------------------------------------
@pytest.mark.parametrize("stack,masses", [
    ((S1,), False), ((S1, S2), True), ((L1, L2), False)],
    ids=["static_pm2", "static_pmn_masses", "tracked_pmn"])
def test_engine_pm2_matches_jax(stack, masses):
    """Engine(pm=..., pm2=...) steps to the JAX engine's state (plain
    paths, filled sphere, 3 frames): static windows at the PM engine's
    bars (tests/test_torch_pm_engine.py); tracked ones at 0.02 of the
    velocity change (the fast-path bar on the accelerations)."""
    n = 3000
    m = None
    if masses:
        m = np.ones(n, np.float32)
        m[:30] = 60.0
    pm2_arg = stack if len(stack) > 1 else stack[0]
    je = JEngine(particle_count=n, method=JMethod.JNP,
                 generation_mode=SphereGeneration.FILLED,
                 pairwise=JPairwise(1.5, CFG.softening), pm=jax_cfg(CFG),
                 pm2=(jax_levels(stack) if len(stack) > 1
                      else jax_cfg(stack[0])), masses=m)
    te = Engine(particle_count=n, device="cpu", method=Method.TORCH,
                generation_mode=SphereGeneration.FILLED,
                pairwise=PairwiseParams(1.5, CFG.softening), pm=CFG,
                pm2=pm2_arg, masses=m)
    assert te.pm2 == pm2_arg
    v0 = te.state.velocities().copy()
    for _ in range(3):
        je.step(JSimParams(delta_time=0.02, gravity=0.3))
        te.step(SimParams(delta_time=0.02, gravity=0.3))
    tp, jp = te.state.positions(), je.state.positions()
    tv, jv = te.state.velocities(), je.state.velocities()
    if stack[0].window_min is not None:
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    else:
        dv = np.abs(jv - v0).max()
        assert np.abs(tv - jv).max() <= 0.02 * dv
        assert np.abs(tp - jp).max() <= 0.02 * dv * 3 * 0.02


def test_engine_pm2_construction_and_set_pm2():
    def make(**kw):
        return Engine(particle_count=1024, device="cpu",
                      method=Method.TORCH, pm=CFG, **kw)

    assert make(pm2=(L1,)).pm2 == L1                  # a 1-tuple is a level
    e = make(pm2=[L1, L2])
    assert e.pm2 == (L1, L2) and e.pm_persist is False
    assert make(pm2=L1).pm_persist == "auto"
    assert e.persist_resolved() is False
    with pytest.raises(ValueError, match="pm="):
        Engine(particle_count=512, device="cpu", pm2=L1)
    with pytest.raises(ValueError, match="softening"):
        make(pm2=pm2.PM2Config(None, 24.0, softening=5.0))
    # set_pm2 validates at the call site and a rejected swap keeps the
    # stack; () and None clear it
    with pytest.raises(ValueError, match="nest"):
        e.set_pm2((L1, pm2.PM2Config(None, 40.0, 0.25)))
    assert e.pm2 == (L1, L2)
    e.set_pm2(())
    assert e.pm2 is None
    e.step(SimParams())                          # the plain single-level PM
    e.set_pm2(L1)
    e.step(SimParams())
    assert np.isfinite(e.state.positions()).all()
