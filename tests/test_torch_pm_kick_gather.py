"""The single-level PM step's tail from the grids (ops/pm_cuda.py): the
momentum mean from the deposit and the interleaved grid
(``grid_momentum_mean``, csrc/momentum.cu's grid instance), then one
launch of the gather's kicked instance (``gather_kick_and_step``,
csrc/pm.cu), which never writes the raw f32[3, N] field.

The grid mean is the particle mean in exact arithmetic: the deposit and
the gather share their CIC weights and dead slots do neither, so
sum_i w_i a(x_i) = sum_c rho_c a_c for ANY grid field a, and sum_i w_i =
sum_c rho_c. On the CPU its plain version is held to ``pm.momentum_mean``
of ``gather_plain``'s field on random grids (and on the solve's own) in
the static and the auto box, isolated and periodic, with masses or unit
masses, a live mask or a live count, slots clamped outside the box and
dead slots, within :func:`rounding_bar`. The wrappers refuse dense planes
and wrong shapes or devices. On the CPU ``step_pm_planes`` keeps the
gather and ``clean_kick_and_step`` (no ``pm.kick_gathered``).

On a card (``chip``: skipped without one): the kicked gather is bit for
bit ``gather`` then ``clean_kick_and_step`` given the particle mean (a
persistent state, the auto box), the kernel's grid mean lies within
GRID_SUMS_ULPS of its plain version (on the solved grids and on a random
field; on the CPU that bar is shown to refuse a wrong weight, stride or
component) and within the bar of the particle mean, and a traced engine
counts ``pm.kick_gathered`` once a step on one interleaved grid and never
with levels or pmx. No JAX here: the plain PM path is held to the JAX
package in tests/test_torch_pm.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm, pm2, pm_cuda, pm_persist, pmx
from particle_sim_tpu_torch.utils import cuda_build, trace

torch.set_num_threads(1)

CSRC = Path(pm_cuda.__file__).resolve().parent.parent / "csrc"
G = 32


def rounding_bar(rho, grids, lower_max: int, n: int) -> torch.Tensor:
    """f64[3]: how far float32 rounding lets the grid mean lie from the
    particle mean, per component. A cell of rho is a float32 sum of at most
    8 * lower_max rounded corner weights (lower_max: the most live
    particles sharing one lower cell), so it is off by at most (8 lower_max
    + 3) u of its exact value; a gathered value is a float32 sum of 8
    rounded products, off by at most 10 u of sum_c W |a_c|; the particle
    side's float32 sum adds ceil(log2 n) roundings. Together u (8 lower_max
    + 16 + ceil(log2 n)) (sum rho |a| / sum rho + |mean|)."""
    u = 2.0 ** -24
    w = rho.double().reshape(-1)
    a = grids.double().reshape(3, -1)
    c = w.sum()
    scale = (a.abs() * w[None]).sum(1) / c
    mean = (a * w[None]).sum(1) / c
    k = 8 * lower_max + 16 + math.ceil(math.log2(max(n, 2)))
    return k * u * (scale + mean.abs())


def lower_max(pos, live, box_min, cell, periodic, g: int = G) -> int:
    """The most live particles of ``pos`` that share one CIC lower cell of
    a ``g``-grid."""
    lo = pm.cell_coords_dyn(pos, box_min, cell, g, periodic).floor().long()
    key = (lo[2] * g + lo[1]) * g + lo[0]
    return int(torch.bincount(key[live], minlength=1).max())


#: The grid sums kernel against grid_momentum_mean_plain: both float64
#: sums of the same float32 inputs in different orders (~1e-10 apart),
#: each rounded to float32, then divided. A few float32 ulps of the scale
#: sum rho |a| / sum rho + |mean| cover the roundings; a wrong weight,
#: stride or component misses by a share of the field.
GRID_SUMS_ULPS = 4


def grid_sums_hold(got, rho, grids) -> bool:
    """Whether the grid mean ``got`` lies within GRID_SUMS_ULPS float32
    ulps of the scale of grid_momentum_mean_plain(rho, grids)."""
    w = rho.double().reshape(-1)
    a = grids.double().reshape(3, -1)
    scale = ((a.abs() * w).sum(1) + (a * w).sum(1).abs()) / w.sum()
    want = pm_cuda.grid_momentum_mean_plain(rho, grids).double()
    return bool(((got.double() - want).abs()
                 <= GRID_SUMS_ULPS * 2.0 ** -24 * scale).all())


def assert_grid_sums_plain(rho, grids):
    """grid_momentum_mean (the kernel on a card) holds to its plain
    version by :func:`grid_sums_hold`."""
    got = pm_cuda.grid_momentum_mean(rho, grids)
    assert grid_sums_hold(got, rho, grids), (
        got, pm_cuda.grid_momentum_mean_plain(rho, grids))


def random_grids(seed, device="cpu"):
    """The interleaved f32[3, G, G, G] view of a random f32[G, G, G, 4]
    buffer (pm.interleaved_view), its pad lane poisoned with NaN."""
    buf = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(G, G, G, 4)).astype(np.float32)).to(device)
    buf[..., 3] = float("nan")
    return pm.interleaved_view(buf)


def scene(case, device="cpu"):
    """(pos f32[3, N], n_active, cfg, masses or None, live or None) for a
    mean case; N a multiple of 128."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n = 3072
    d = rng.normal(size=(3, n))
    p = 40.0 * d / np.linalg.norm(d, axis=0) * rng.random(n) ** (1 / 3)
    p[:, :200] += 10.0                          # an off-centre clump
    n_active, masses, live = n, None, None
    cfg = PMConfig(grid=G, softening=3.0)
    if "clamped" in case:                       # far past the box's faces
        p[:, ::7] *= 4.0
    if "periodic" in case:
        cfg = PMConfig(grid=G, softening=3.0, boundary="periodic",
                       gradient="fd")
        p[:, ::9] += 90.0                       # strays: the wrap
    if "auto" in case:
        cfg = PMConfig(grid=G, softening=3.0, auto_box=True)
    if "masses" in case:
        masses = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(
            np.float32))
        masses[3] = 200.0
    if "count" in case:                         # dead tail, far outside
        n_active = n - 700
        p[:, n_active:] = 5e3
    if "live" in case:                          # dead slots scattered
        live = torch.from_numpy(rng.random(n) < 0.7)
        p[:, ~live.numpy()] = -7e3
    pos = torch.from_numpy(p.astype(np.float32)).to(device)
    move = (lambda t: None if t is None else t.to(device))
    return pos, n_active, cfg, move(masses), move(live)


MEAN_CASES = ["static", "static_masses", "clamped_count", "live_masses",
              "periodic_live", "auto", "auto_masses_count",
              "solved_masses", "solved_auto"]


@pytest.mark.parametrize("case", MEAN_CASES)
def test_grid_mean_is_the_particle_mean(case):
    """The plain grid mean (float64 sum rho a / sum rho, rounded as
    pm.momentum_mean rounds) against pm.momentum_mean of gather_plain's
    field with the same weights, within rounding_bar: on a random field
    (the identity holds for any field) or, for ``solved_*``, the solve's
    own grids. Far from the bar is a wrong weight: a mean of unit weights,
    say, misses it by O(1) of the field."""
    pos, n_active, cfg, masses, live = scene(case)
    rho, grids, box, cell, periodic = pm_cuda._mesh(
        pos, n_active, cfg, masses=masses, live=live, coll=None, plain=True,
        cell_sorted=False)
    if not case.startswith("solved"):
        grids = random_grids(len(case))
    acc = pm_cuda.gather_plain(grids, pos, n_active, box, cell,
                               periodic=periodic, live=live)
    want = pm.momentum_mean(acc, n_active, masses, live=live)
    got = pm_cuda.grid_momentum_mean(rho, grids)
    assert torch.equal(got, pm_cuda.grid_momentum_mean_plain(rho, grids))
    lv = pm.live_mask(pos.shape[1], n_active, "cpu") if live is None else live
    bar = rounding_bar(rho, grids, lower_max(pos, lv, box, cell, periodic),
                       pos.shape[1])
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= bar).all()), (gap, bar, got, want)
    if not case.startswith("solved"):
        # the bar sees a wrong weight: the unweighted grid mean
        unweighted = grids.double().reshape(3, -1).mean(1)
        assert bool(((unweighted - want.double()).abs() > 10 * bar).any())


@pytest.mark.parametrize("fault", ["unweighted", "no_z", "lanes_shifted",
                                   "rho_transposed"])
def test_grid_sums_bar_refuses_a_wrong_kernel(fault):
    """The card's bar on the grid sums kernel (GRID_SUMS_ULPS of the
    scale) refuses what a wrong kernel would return on a random field:
    unweighted cells, a dropped component, the interleaved lanes read one
    off, rho read in the wrong order."""
    pos, n_active, cfg, masses, live = scene("live_masses")
    rho = pm_cuda._mesh(pos, n_active, cfg, masses=masses, live=live,
                        coll=None, plain=True, cell_sorted=False)[0]
    buf = torch.from_numpy(np.random.default_rng(11).normal(
        size=(G, G, G, 4)).astype(np.float32))
    grids = pm.interleaved_view(buf)
    plain = pm_cuda.grid_momentum_mean_plain
    assert grid_sums_hold(plain(rho, grids), rho, grids)
    if fault == "unweighted":
        wrong = grids.reshape(3, -1).double().mean(1).float()
    elif fault == "no_z":
        wrong = plain(rho, grids) * torch.tensor([1.0, 1.0, 0.0])
    elif fault == "lanes_shifted":
        wrong = plain(rho, buf[..., 1:].permute(3, 0, 1, 2))
    else:
        wrong = plain(rho.transpose(0, 2).contiguous(), grids)
    assert not grid_sums_hold(wrong, rho, grids)


def _cpu_tail():
    pos, n_active, cfg, masses, live = scene("live_masses")
    rho, grids, box, cell, periodic = pm_cuda._mesh(
        pos, n_active, cfg, masses=masses, live=live, coll=None, plain=True,
        cell_sorted=False)
    pv = torch.from_numpy(SimParams(delta_time=0.016).pack())
    vel = torch.zeros_like(pos)
    return dict(grids=grids, pos=pos.view(3, -1, 128),
                vel=vel.view(3, -1, 128), param_vec=pv,
                mean=torch.zeros(3), n_active=n_active,
                g_const=torch.tensor(0.7), box_min=box, cell=cell,
                periodic=periodic, live=live), rho


BAD = ["planar:grids", "shape:grids", "shape:mean", "dtype:mean",
       "device:mean", "dtype:live", "shape:vel", "planar:rho_grids",
       "shape:rho", "dtype:rho", "noncontig:rho", "device:rho"]


@pytest.mark.parametrize("case", BAD)
def test_grid_tail_wrappers_refuse_bad_input(case):
    """grid_momentum_mean and gather_kick_and_step raise on dense planes
    (the periodic 'exact' solve's layout, which the kicked gather does not
    read), a wrong shape, dtype or device, and leave the state alone."""
    kw, rho = _cpu_tail()
    what, field = case.split(":")
    if field in ("rho", "rho_grids"):
        grids = kw["grids"]
        if what == "planar":
            grids = grids.contiguous()
        elif what == "shape":
            rho = rho[:-1]
        elif what == "dtype":
            rho = rho.double()
        elif what == "noncontig":
            rho = rho.transpose(0, 2)
        elif what == "device":
            rho = rho.to("meta")
        with pytest.raises((TypeError, ValueError)):
            pm_cuda.grid_momentum_mean(rho, grids)
        return
    t = kw[field]
    if what == "planar":
        kw[field] = t.contiguous()
    elif what == "shape":
        kw[field] = (t[:, 1:] if field == "grids" else t[..., :-1])
    elif what == "dtype":
        kw[field] = t.double() if t.dtype != torch.float64 else t.float()
    elif what == "device":
        kw[field] = t.to("meta")
    pos0, vel0 = kw["pos"].clone(), kw["vel"].clone()
    with pytest.raises((TypeError, ValueError)):
        pm_cuda.gather_kick_and_step(**kw)
    assert torch.equal(kw["pos"], pos0) and torch.equal(kw["vel"], vel0)


def test_cpu_kicked_gather_is_the_gather_then_the_kick():
    """On CPU tensors gather_kick_and_step takes its plain versions:
    gather_plain, then clean_kick_and_step, bit for bit and in place; it
    counts pm.kick_gathered and pm.kick_fused once, and no launch."""
    kw, _ = _cpu_tail()
    kw["mean"] = torch.tensor([0.01, -0.02, 0.005])
    before = (pm_cuda.GATHER_LAUNCHES, pm_cuda.KICK_GATHER_LAUNCHES,
              pm_cuda.KICK_FUSED_LAUNCHES)
    p, v = kw["pos"].clone(), kw["vel"].clone()
    acc = pm_cuda.gather_plain(kw["grids"], p.reshape(3, -1), kw["n_active"],
                               kw["box_min"], kw["cell"],
                               periodic=kw["periodic"], live=kw["live"])
    pm_cuda.clean_kick_and_step(p, v, acc, kw["param_vec"], kw["mean"],
                                kw["n_active"], kw["g_const"],
                                live=kw["live"])
    trace.reset()
    trace.enable()
    try:
        out = pm_cuda.gather_kick_and_step(**kw)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert out[0] is kw["pos"] and out[1] is kw["vel"]
    assert torch.equal(kw["pos"], p) and torch.equal(kw["vel"], v)
    assert (counts.get("pm.kick_gathered"), counts.get("pm.kick_fused")) \
        == (1, 1)
    assert (pm_cuda.GATHER_LAUNCHES, pm_cuda.KICK_GATHER_LAUNCHES,
            pm_cuda.KICK_FUSED_LAUNCHES) == before


@pytest.mark.parametrize("persist", [False, True])
def test_cpu_engines_keep_the_field_tail(persist):
    """On the CPU the single-level kernel-path step (per-frame, or
    persistent) keeps the gather, momentum_mean and clean_kick_and_step:
    pm.kick_fused once a step, pm.kick_gathered never."""
    e = Engine(particle_count=4096, device="cpu", method=Method.TORCH,
               pm=PMConfig(grid=G, softening=3.0), pm_persist=persist)
    e.method = Method.CUDA      # the wrappers, their plain versions here
    trace.reset()
    trace.enable()
    try:
        for _ in range(2):
            e.step(SimParams(delta_time=0.016))
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert counts.get("pm.kick_fused") == 2, counts
    assert "pm.kick_gathered" not in counts


def _launched(entry: str) -> set:
    body = (CSRC / entry[0]).read_text().split(
        f"PSIM_EXPORT int {entry[1]}(")[1].split("PSIM_EXPORT")[0]
    return set(re.findall(r"(\w+<(?:true|false)>)<<<", body))


def test_grid_entries_are_bound_and_named_for_their_readers():
    """The C entries are bound, and the kicked gather launches an instance
    of pm_gather_interleaved_kernel: the benchmark's pm_gather_roofline
    matches that name. The grid sums are momentum_sums_kernel's grid
    instance."""
    sig = cuda_build.SIGNATURES
    assert len(sig["psim_pm_gather_kick"]) == 16
    assert len(sig["psim_momentum_sums_grid"]) == 8
    assert _launched(("pm.cu", "psim_pm_gather_kick")) == {
        "pm_gather_interleaved_kernel<true>"}
    assert _launched(("pm.cu", "psim_pm_gather")) >= {
        "pm_gather_interleaved_kernel<false>"}
    assert _launched(("momentum.cu", "psim_momentum_sums_grid")) == {
        "momentum_sums_kernel<true>"}


# -- on the card ---------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(PSIM_TEST_REAL_DEVICES=1 pytest -m chip)")
    return torch.device("cuda")


def _card_params(card):
    return torch.from_numpy(SimParams(
        delta_time=0.016, is_mouse_dragging=True,
        mouse_position=(4.0, 2.0, -6.0), mouse_force=30.0,
        mouse_radius=20.0).pack()).to(card)


@pytest.mark.chip
@pytest.mark.parametrize("case", ["persistent", "auto_box"])
def test_card_kicked_gather_is_the_chain(card, case):
    """Given the particle mean (momentum_mean of the gathered field), the
    kicked gather leaves pos and vel bit for bit where gather, then
    clean_kick_and_step leave them: a persistent 1M state at G = 128 with
    masses and the live mask, and the 1M sphere in the auto box. The grid
    sums kernel holds to its plain version and to the particle mean."""
    n = 1 << 20
    rng = np.random.default_rng(5)
    d = rng.normal(size=(3, n))
    p = torch.from_numpy((50.0 * d / np.linalg.norm(d, axis=0)
                          * rng.random(n) ** 0.3).astype(np.float32)).to(card)
    vel = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(
        card)
    if case == "persistent":
        cfg = PMConfig()
        masses = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(
            np.float32)).to(card)
        st = pm_persist.init_sorted(p, n - 4096, cfg, vel_flat=vel,
                                    masses=masses)
        flat, vel, masses = st.pos, st.vel, st.masses
        n_active, live = n - 4096, st.ids < n - 4096
    else:
        cfg = PMConfig(auto_box=True)
        flat, masses, live = p, None, None
        n_active = torch.tensor(n - 1000, dtype=torch.int32, device=card)
    rho, grids, box, cell, periodic = pm_cuda._mesh(
        flat, n_active, cfg, masses=masses, live=live, coll=None,
        plain=False, cell_sorted=case == "persistent")
    acc = pm_cuda.gather(grids, flat, n_active, box, cell, periodic=periodic,
                         live=live)
    mean = pm_cuda.momentum_mean(acc, n_active, masses=masses, live=live)
    pv, g = _card_params(card), torch.tensor(0.7, device=card)
    auto = cfg.auto_box
    po, vo = flat.clone().view(3, -1, 128), vel.clone().view(3, -1, 128)
    pm_cuda.clean_kick_and_step(po, vo, acc, pv, mean, n_active, g, live=live,
                                cell=cell if auto else None)
    pk, vk = flat.clone().view(3, -1, 128), vel.clone().view(3, -1, 128)
    before = (pm_cuda.KICK_GATHER_LAUNCHES, pm_cuda.GATHER_LAUNCHES)
    pm_cuda.gather_kick_and_step(grids, pk, vk, pv, mean, n_active, g, box,
                                 cell, periodic=periodic, live=live,
                                 auto_box=auto)
    torch.cuda.synchronize()
    assert (pm_cuda.KICK_GATHER_LAUNCHES, pm_cuda.GATHER_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(pk, po) and torch.equal(vk, vo)
    # the grid mean: two launches bit for bit, within GRID_SUMS_ULPS of
    # its plain version, within the rounding bar of the particle mean
    got = pm_cuda.grid_momentum_mean(rho, grids)
    assert torch.equal(got, pm_cuda.grid_momentum_mean(rho, grids))
    assert_grid_sums_plain(rho, grids)
    lv = pm.live_mask(n, n_active, card) if live is None else live
    bar = rounding_bar(rho, grids, lower_max(flat, lv, box, cell, periodic,
                                             cfg.grid), n)
    gap = (got.double() - mean.double()).abs()
    assert bool((gap <= bar).all()), (gap, bar)
    # and on a random field of the grids' shape (its pad lane NaN), whose
    # weighted mean stands far above that bar
    noise = torch.randn((cfg.grid,) * 3 + (4,), device=card,
                        generator=torch.Generator(card).manual_seed(7))
    noise[..., 3] = float("nan")
    assert_grid_sums_plain(rho, pm.interleaved_view(noise))


@pytest.mark.chip
@pytest.mark.parametrize("case", ["static", "auto_box", "persistent",
                                  "levels", "pmx"])
def test_card_engine_counts_kick_gathered(card, case):
    """A traced engine on the card counts pm.kick_gathered once a step on
    one interleaved grid (the per-frame PM in the static and the auto box,
    the persistent single level) and never with a refinement level or the
    exact window; pm.kick_fused once a step in all."""
    kw = dict(particle_count=1 << 20, device=card, pm_persist=False,
              pm=PMConfig(), pairwise=PairwiseParams(0.08, 2.0))
    if case == "auto_box":
        kw["pm"] = PMConfig(auto_box=True)
    elif case == "persistent":
        kw["pm_persist"] = True
    elif case == "levels":
        kw["pm2"] = pm2.PM2Config(None, 32.0, 0.75)
    elif case == "pmx":
        kw["pmx"] = pmx.PMXConfig(window_size=4.0, softening=0.1,
                                  capacity=8192)
    e = Engine(**kw)
    params = SimParams(delta_time=0.004)
    e.step(params)
    trace.reset()
    trace.enable()
    try:
        for _ in range(3):
            e.step(params)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    want = 0 if case in ("levels", "pmx") else 3
    assert counts.get("pm.kick_gathered", 0) == want, counts
    assert counts.get("pm.kick_fused") == 3, counts
