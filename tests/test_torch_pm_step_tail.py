"""The multi-level and window-exact PM steps on the kernel path
(ops/pm2.py ``step_pmn``, ops/pmx.py ``step_pmx``) end in the PM step's
one tail (pm_cuda.momentum_mean, then pm_cuda.clean_kick_and_step), and
the direct sum's step kicks through the step kernel's kicked form.

On the CPU the wrappers take their plain versions: each step is bit for
bit its public acceleration (pm2.pmn_accel, pmx.pmx_accel) followed by
physics.kick_and_step_planes, with no kernel counted; a traced engine
counts ``pm.kick_fused`` once a step. On a card (``chip``: skipped
without one): the kernel-path steps at 100,000 particles within the
pmn and pmx bars of their plain paths, and the direct sum's kick bit for
bit the three-launch form it replaced at 65,536. No JAX here: the plain
paths are held to the JAX package in tests/test_torch_pm2.py and
tests/test_torch_pmx.py."""

import numpy as np
import pytest
import torch

from particle_sim_tpu_torch.core.params import (
    P_DT, Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import (
    pairwise_cuda, physics, pm2, pm_cuda, pmx, step_cuda,
)
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)

CFG = PMConfig(grid=32, softening=3.0)
L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=0.75)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.25)
WINDOW = pmx.PMXConfig(window_size=6.0, softening=0.1, capacity=2048)
CORE = (5.0, 4.0, -3.0)


def scene(seed, n_core, n_halo, device="cpu"):
    """(pos f32[3, cap], n): a dense clump at CORE in a halo, zeros to a
    multiple of 128."""
    rng = np.random.default_rng(seed)

    def ball(k, radius, off):
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius * rng.random(k).astype(np.float32) ** (1 / 3)
        return d * r[:, None] + np.float32(off)

    p = np.concatenate([ball(n_core, 3.0, CORE),
                        ball(n_halo, 40.0, (0.0, 0.0, 0.0))])
    n = p.shape[0]
    out = np.zeros((3, -(-n // 128) * 128), np.float32)
    out[:, :n] = p.T
    return torch.from_numpy(out).to(device), n


def params(device="cpu"):
    pv = SimParams(delta_time=0.016, is_mouse_dragging=True,
                   mouse_position=(4.0, 2.0, -6.0), mouse_force=30.0,
                   mouse_radius=20.0).pack()
    pp = PairwiseParams(0.8, CFG.softening).pack()
    return (torch.from_numpy(pv).to(device), torch.from_numpy(pp).to(device))


def launches():
    return (pm_cuda.MOMENTUM_LAUNCHES, pm_cuda.KICK_FUSED_LAUNCHES,
            step_cuda.LAUNCHES)


CASES = {
    "pmn_one": ((L1,), None, False),
    "pmn_two_masses": ((L1, L2), None, True),
    "pmx_mesh": ((), WINDOW, False),
    "pmx_levels_masses": ((L1,), WINDOW, True),
}


@pytest.mark.parametrize("case", [*CASES, "traced_engine"])
def test_kernel_path_step_is_its_accel_then_the_plain_kick(case):
    """On CPU tensors step_pmn / step_pmx with ``use_fast`` (the raw
    field, then the two-launch tail's plain versions) are bit for bit
    pmn_accel / pmx_accel (one clean and the G scale) followed by
    physics.kick_and_step_planes, in place, with the same member count
    and no launch counted. traced_engine: a traced per-frame two-level
    engine on the kernels' wrappers counts pm.kick_fused once a step."""
    before = launches()
    if case == "traced_engine":
        e = Engine(particle_count=4096, device="cpu", method=Method.TORCH,
                   pm=CFG, pm2=(L1, L2), pm_persist=False)
        e.method = Method.CUDA      # the wrappers, their plain versions here
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
        assert launches() == before
        return
    levels, cfgx, with_masses = CASES[case]
    flat, n = scene(3, 1200, 1800)
    shape = (3, -1, 128)
    rng = np.random.default_rng(4)
    vel = torch.from_numpy(rng.normal(size=flat.shape).astype(np.float32))
    masses = None
    if with_masses:
        masses = torch.from_numpy(
            (rng.random(flat.shape[1]) + 0.5).astype(np.float32))
    pv, pp = params()
    if cfgx is None:
        acc = pm2.pmn_accel(flat, n, pp[0], CFG, levels, masses=masses)
    else:
        acc, n_want = pmx.pmx_accel(flat, n, pp[0], CFG, levels, cfgx,
                                    masses=masses)
    want_p, want_v = physics.kick_and_step_planes(
        flat.view(shape), vel.view(shape), acc.view(shape), pv)
    p, v = flat.clone().view(shape), vel.clone().view(shape)
    if cfgx is None:
        out = pm2.step_pmn(p, v, pv, pp, n, CFG, levels, masses=masses)
    else:
        out = pmx.step_pmx(p, v, pv, pp, n, CFG, levels, cfgx,
                           masses=masses)
        assert int(out[2]) == int(n_want) > 0
    assert out[0] is p and out[1] is v
    assert torch.equal(p, want_p) and torch.equal(v, want_v)
    assert launches() == before


# -- on the card ---------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(PSIM_TEST_REAL_DEVICES=1 pytest -m chip)")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("stack", ["pmn", "pmx"])
def test_card_kernel_step_within_the_plain_bar(card, stack):
    """step_pmn (two levels) and step_pmx (one level and the exact
    window) at 100,000 particles, G = 64, from rest with no attractor:
    the kernel path's velocity change (the raw field, the float64 mean,
    the clean, the scale and the kick in the step kernel) within the
    bars chip_smoke holds the kernel path's accelerations to against the
    plain path's: 1e-4 of the largest change for pmn, plus 2e-4 of the
    largest exact-window correction for pmx; one momentum and one kicked
    launch a step; the same member count."""
    cfg = PMConfig(grid=64, softening=3.0)
    flat, n = scene(5, 50_000, 50_000, card)
    shape = (3, -1, 128)
    pv = torch.from_numpy(SimParams(delta_time=0.016,
                                    gravity=0.0).pack()).to(card)
    pp = torch.tensor([0.8, cfg.softening], device=card)
    n_active = torch.tensor(n, dtype=torch.int32, device=card)
    window = pmx.PMXConfig(window_size=4.0, softening=0.1, capacity=8192)

    def step(use_fast):
        p = flat.clone().view(shape)
        v = torch.zeros_like(p)
        if stack == "pmn":
            out = pm2.step_pmn(p, v, pv, pp, n_active, cfg, (L1, L2),
                               use_fast=use_fast)
            return out[1].reshape(3, -1), None
        out = pmx.step_pmx(p, v, pv, pp, n_active, cfg, (L1,), window,
                           use_fast=use_fast)
        return out[1].reshape(3, -1), int(out[2])

    before = launches()
    dv_k, n_k = step(True)
    torch.cuda.synchronize()
    after = launches()
    dv_p, n_p = step(False)
    assert after[:2] == (before[0] + 1, before[1] + 1)
    assert n_k == n_p
    bar = 1e-4 * float(dv_p.abs().max())
    if stack == "pmx":
        # the exact window's share of the plain field, as a velocity change
        a_x = (pmx.pmx_accel(flat, n_active, pp[0], cfg, (L1,), window,
                             use_fast=False)[0]
               - pm2.pmn_accel_ref(flat, n_active, pp[0], cfg, (L1,)))
        bar += 2e-4 * float(a_x.abs().max()) * float(pv[P_DT])
    gap = float((dv_k - dv_p).abs().max())
    assert gap <= bar, (gap, bar)


@pytest.mark.chip
def test_card_direct_kick_is_the_three_launch_form(card):
    """pairwise_cuda.step_pairwise at 65,536 (one launch of the kicked
    step kernel after the force) bit for bit the form it replaced: the
    transposed copy, ``vel += acc * dt`` as torch passes, then the step
    kernel."""
    flat, n = scene(7, 16_384, 49_152, card)
    shape = (3, -1, 128)
    pv = torch.from_numpy(SimParams(delta_time=0.004, is_mouse_dragging=True,
                                    mouse_position=(4.0, 2.0, -6.0),
                                    mouse_force=30.0,
                                    mouse_radius=20.0).pack()).to(card)
    pp = torch.tensor([1.0, 0.5], device=card)
    n_active = torch.tensor(n, dtype=torch.int32, device=card)
    vel = torch.randn(flat.shape, generator=torch.Generator(
        device=card).manual_seed(8), device=card)
    p, v = flat.clone().view(shape), vel.clone().view(shape)
    before = step_cuda.LAUNCHES
    pairwise_cuda.step_pairwise(p, v, pv, pp, n_active)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES == before + 1
    wp, wv = flat.clone().view(shape), vel.clone().view(shape)
    acc = pairwise_cuda.pairwise_accel(flat.T, flat, n_active, pp[0], pp[1],
                                       n_j=n_active)
    wv.add_(acc.T.reshape(wv.shape) * pv[P_DT])
    step_cuda.step(wp, wv, pv)
    assert torch.equal(p, wp) and torch.equal(v, wv)
