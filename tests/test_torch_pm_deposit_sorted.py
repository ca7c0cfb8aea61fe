"""The PM deposit of cell-sorted input (csrc/pm.cu ``psim_pm_deposit_sorted``,
``pm_cuda.deposit(..., cell_sorted=True)``) and the one caller that asks
for it: the persistent single-level step (ops/pm_persist.py), whose
slots are sorted by the deposit grid's own lower cells.

On the CPU: the route (a spy on ``pm_cuda.deposit``: only the persistent
steps with no refinement level and no window-exact correction pass
``cell_sorted=True``; the multi-level orders, the per-frame step and the
public accelerations do not), the plain version's bits with
``cell_sorted`` on CPU tensors (no launch, no count), the C entry's
binding and the kernel's name, which the benchmark's deposit roofline
reads. On a card (``chip``: skipped without one): the kernel against the
plain deposit and against the float64 sum of the same float32 corner
weights, within 1e-5 of max|rho|, on 1M cell-sorted states (with and
without masses), the same with a quarter of the adjacent slot pairs
swapped, dead slots by the live mask and by the live count, a cloud in
one cell, a cloud clamped onto the box's faces, the periodic seam and a
count that fills no whole block; a traced persistent engine counts
``pm.deposit.sorted`` once a step. No JAX here: the plain deposit is held
to the JAX package in tests/test_torch_pm.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm2, pm_cuda, pm_persist, pmx
from particle_sim_tpu_torch.utils import cuda_build, trace

torch.set_num_threads(1)

CFG32 = PMConfig(grid=32, softening=4.0)
L1 = pm2.PM2Config(window_min=None, window_size=32.0, softening=1.0)
L2 = pm2.PM2Config(window_min=None, window_size=8.0, softening=0.4)
WINDOW = pmx.PMXConfig(window_size=6.0, softening=0.1, capacity=1024)
PM_CU = Path(pm_cuda.__file__).resolve().parent.parent / "csrc" / "pm.cu"


def _flat(n=2048, device="cpu"):
    st = Engine(particle_count=n, device=device, method=Method.TORCH,
                pm=CFG32, pairwise=PairwiseParams(1.0, 4.0),
                pm_persist=False).state
    return st.pos.reshape(3, -1), st.n_active


def _vecs(device="cpu"):
    return (torch.from_numpy(SimParams().pack()).to(device),
            torch.from_numpy(PairwiseParams(1.0, 4.0).pack()).to(device))


def _masses(n, seed, device="cpu"):
    m = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 1.5, n).astype(np.float32)).to(device)
    m[0] = 1000.0
    return m


def _step(levels, cfgx=None, masses=False):
    flat, n_active = _flat()
    m = _masses(flat.shape[1], 3) if masses else None
    if isinstance(levels, tuple):
        st = pm_persist.init_sorted_multi(flat, n_active, CFG32, levels,
                                          masses=m)
    else:
        st = pm_persist.init_sorted(flat, n_active, CFG32, masses=m,
                                    cfg2=levels)
    pv, pp = _vecs()
    return lambda: pm_persist.step_sorted(st, pv, pp, n_active, CFG32,
                                          cfg2=levels, cfgx=cfgx,
                                          repair=False)


def _accel_sorted():
    flat, n_active = _flat()
    st = pm_persist.init_sorted(flat, n_active, CFG32)
    return lambda: pm_persist.accel_sorted(st, 1.0, CFG32, n_active=n_active,
                                           repair=False)


def _per_frame(fn):
    flat, n_active = _flat()
    pv, pp = _vecs()
    if fn == "step_pm_planes":
        return lambda: pm_cuda.step_pm_planes(
            flat.clone().view(3, -1, 128), torch.zeros_like(flat).view(
                3, -1, 128), pv, pp[0], n_active, CFG32)
    return lambda: pm_cuda.pm_accel(flat, n_active, 1.0, CFG32)


#: caller -> (the call, the ``cell_sorted`` of each deposit it makes)
ROUTES = {
    "step_sorted": (lambda: _step(None), [True]),
    "step_sorted masses": (lambda: _step(None, masses=True), [True]),
    "accel_sorted": (_accel_sorted, [True]),
    "step_sorted cfg2": (lambda: _step(L1), [False, False]),
    "step_sorted levels": (lambda: _step((L1, L2)), [False] * 3),
    "step_sorted levels cfgx": (lambda: _step((L1, L2), WINDOW),
                                [False] * 3),
    "step_pm_planes": (lambda: _per_frame("step_pm_planes"), [False]),
    "pm_accel": (lambda: _per_frame("pm_accel"), [False]),
}


@pytest.mark.parametrize("caller", sorted(ROUTES))
def test_only_the_single_level_persistent_step_asks_for_the_sorted_deposit(
        monkeypatch, caller):
    """The persistent state is sorted by the coarse deposit's own lower
    cells only without levels: there ``pm_persist`` passes
    ``cell_sorted=True``; the class orders of the multi-level stack (and
    its window-exact correction), the per-frame step and the public
    acceleration keep the deposit for any order."""
    make, want = ROUTES[caller]
    call = make()
    seen = []
    real = pm_cuda.deposit

    def spy(*args, cell_sorted=False, **kw):
        seen.append(cell_sorted)
        return real(*args, cell_sorted=cell_sorted, **kw)

    monkeypatch.setattr(pm_cuda, "deposit", spy)
    call()
    assert seen == want


@pytest.mark.parametrize("case", ["count", "live", "masses", "live+masses",
                                  "periodic"])
def test_cpu_tensors_take_the_plain_deposit_when_sorted(case):
    """``cell_sorted=True`` on CPU tensors is the plain deposit bit for bit
    (the same as without it): no launch and no ``pm.deposit.sorted``
    count."""
    flat, n_active = _flat(4096)
    n = flat.shape[1]
    periodic = case == "periodic"
    cfg = PMConfig(grid=32, boundary="periodic" if periodic else "isolated")
    live = None
    if "live" in case:
        live = torch.from_numpy(np.random.default_rng(5).random(n) < 0.8)
    masses = _masses(n, 6) if "masses" in case else None
    st = pm_persist.init_sorted(flat, n_active, cfg, masses=masses)
    box, cell = pm_cuda.static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   flat.device)
    kw = dict(periodic=periodic, masses=st.masses, live=live)
    before = (pm_cuda.DEPOSIT_SORTED_LAUNCHES, pm_cuda.DEPOSIT_LAUNCHES,
              pm_cuda.DEPOSIT_MASS_LAUNCHES)
    trace.enable()
    try:
        got = pm_cuda.deposit(st.pos, n_active, box, cell, 32,
                              cell_sorted=True, **kw)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    want = pm_cuda.deposit_plain(st.pos, n_active, box, cell, 32, **kw)
    assert torch.equal(got, want)
    assert torch.equal(got, pm_cuda.deposit(st.pos, n_active, box, cell, 32,
                                            **kw))
    assert (pm_cuda.DEPOSIT_SORTED_LAUNCHES, pm_cuda.DEPOSIT_LAUNCHES,
            pm_cuda.DEPOSIT_MASS_LAUNCHES) == before
    assert "pm.deposit.sorted" not in counts


def test_sorted_entry_is_bound_like_the_deposit_and_named_for_its_reader():
    """``psim_pm_deposit_sorted`` takes ``psim_pm_deposit``'s arguments
    (the wrapper passes the same ones), and the kernel it launches is a
    ``pm_deposit_kernel*``: the benchmark's pm_deposit_roofline matches
    that name and divides by its launches, one a deposit."""
    sig = cuda_build.SIGNATURES
    assert sig["psim_pm_deposit_sorted"] == sig["psim_pm_deposit"]
    src = PM_CU.read_text()
    body = src.split("PSIM_EXPORT int psim_pm_deposit_sorted(")[1]
    body = body.split("PSIM_EXPORT")[0]
    kernels = set(re.findall(r"(\w+)<(?:true|false)><<<", body))
    assert kernels and all(k.startswith("pm_deposit_kernel")
                           for k in kernels), kernels
    assert "pm_deposit_kernel<" not in body


# -- on the card ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(PSIM_TEST_REAL_DEVICES=1 pytest -m chip)")
    return torch.device("cuda")


CARD_N = 1 << 20
#: max|kernel - reference| over max|rho|: the bar the deposit kernels are
#: held to since they were ported (float32 sums in another order)
CARD_TOL = 1e-5


def _card_state(case, dev):
    """(pos f32[3, n], n_active, cfg, masses or None, live or None) for
    ``case``, in the order the persistent state keeps: sorted by the
    deposit grid's lower cells (pm_persist.cell_keys), dead slots last
    (apart from the cases that scatter them)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n, n_active = CARD_N, CARD_N
    cfg = PMConfig()                        # G = 128, box [-64, 64)^3
    if case == "ragged":
        n = n_active = CARD_N + 37
    if case == "one_cell":
        p = 10.25 + 0.5 * rng.random((3, n))
    elif case == "clamped":                 # far past the box: faces
        d = rng.normal(size=(3, n))
        p = 300.0 * d / np.linalg.norm(d, axis=0) * rng.random(n) ** 0.2
    elif case == "periodic":                # across the seam of every axis
        cfg = PMConfig(boundary="periodic")
        p = rng.normal(size=(3, n)) * 3.0 + 64.0
    else:                                   # a shell, as the main path
        d = rng.normal(size=(3, n))
        p = 50.0 * d / np.linalg.norm(d, axis=0) + rng.normal(
            size=(3, n)) * 2.0
    pos = torch.from_numpy(p.astype(np.float32)).to(dev)
    masses = None if case == "unit" else torch.from_numpy(
        rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
    if masses is not None:
        masses[0] = 1000.0
    if case == "n_active":
        n_active = n - 100_003
    live_all = torch.arange(n, device=dev) < n_active
    key = pm_persist.cell_keys(pos, live_all, cfg)
    order = torch.sort(key, stable=True)[1]
    pos = pos[:, order].contiguous()
    masses = None if masses is None else masses[order].contiguous()
    live = None
    if case == "swapped":                   # a quarter of adjacent pairs
        i = torch.nonzero(torch.from_numpy(rng.random(n // 2) < 0.5).to(
            dev))[:, 0] * 2
        perm = torch.arange(n, device=dev)
        perm[i], perm[i + 1] = i + 1, i
        pos = pos[:, perm].contiguous()
        masses = masses[perm].contiguous()
    if case == "live":
        live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    return pos, n_active, cfg, masses, live


def _float64_sum(pos, n_active, cfg, masses, live):
    """(f64[G^3] sum of the float32 corner weights, f64[G^3] terms a
    cell): chip_smoke's helper, the yardstick of the PM deposits."""
    import chip_smoke

    m = masses
    if live is not None:
        m = live.to(torch.float32) * (1.0 if m is None else m)
    box, cell = pm_cuda.static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   pos.device)
    idx, w = chip_smoke.cic_corners(pos, n_active, box, cell, cfg.grid,
                                    cfg.boundary == "periodic", masses=m)
    g3 = cfg.grid ** 3
    rho = torch.zeros(g3, dtype=torch.float64, device=pos.device)
    rho.index_add_(0, idx.reshape(-1), w.double().reshape(-1))
    terms = torch.zeros(g3, dtype=torch.float64, device=pos.device)
    terms.index_add_(0, idx.reshape(-1), (w != 0).double().reshape(-1))
    return rho, terms


@pytest.mark.chip
@pytest.mark.parametrize("case", ["masses", "unit", "swapped", "live",
                                  "n_active", "one_cell", "clamped",
                                  "periodic", "ragged"])
def test_card_sorted_deposit_matches_the_plain_and_float64(card, case):
    """The kernel for cell-sorted input against the float64 sum of the
    same float32 corner weights (within 1e-5 of max|rho|, and within
    K u |rho| at a cell of K terms, u = 2^-24) and against the plain
    deposit (within 1e-5 of max|rho| where the plain deposit itself is
    within half of that of the float64 sum, else 2 K u |rho|: both are
    float32 sums of the same terms); one launch, counted."""
    pos, n_active, cfg, masses, live = _card_state(case, card)
    g, periodic = cfg.grid, cfg.boundary == "periodic"
    box, cell = pm_cuda.static_box(tuple(cfg.box_min), float(cfg.cell_size),
                                   card)
    kw = dict(periodic=periodic, masses=masses, live=live)
    before = pm_cuda.DEPOSIT_SORTED_LAUNCHES
    got = pm_cuda.deposit(pos, n_active, box, cell, g, cell_sorted=True,
                          **kw).reshape(-1).double()
    plain = pm_cuda.deposit_plain(pos, n_active, box, cell, g,
                                  **kw).reshape(-1).double()
    torch.cuda.synchronize()
    assert pm_cuda.DEPOSIT_SORTED_LAUNCHES == before + 1
    exact, terms = _float64_sum(pos, n_active, cfg, masses, live)
    scale = float(exact.abs().max())
    u = 2.0 ** -24
    gap = float((got - exact).abs().max()) / scale
    assert gap <= CARD_TOL, gap
    assert bool(((got - exact).abs() <= terms * u * exact.abs()).all())
    plain_gap = float((plain - exact).abs().max()) / scale
    if plain_gap <= CARD_TOL / 2:
        assert float((got - plain).abs().max()) / scale <= CARD_TOL
    else:
        assert bool(((got - plain).abs()
                     <= 2 * terms * u * exact.abs()).all())


@pytest.mark.chip
def test_card_traced_persistent_engine_counts_one_sorted_deposit_a_step(card):
    """A traced persistent engine with no levels counts one
    ``pm.deposit.sorted`` a step; a per-frame engine and a two-level
    persistent one count none."""
    counts = {}
    for label, kw in (("persistent", dict(pm_persist=True)),
                      ("per-frame", dict(pm_persist=False)),
                      ("two-level", dict(pm_persist=True, pm2=L1))):
        e = Engine(particle_count=65536, device=card, pm=PMConfig(),
                   pairwise=PairwiseParams(1.0, 2.0), **kw)
        e.step(SimParams())
        torch.cuda.synchronize()
        trace.reset()
        trace.enable()
        try:
            for _ in range(5):
                e.step(SimParams())
            torch.cuda.synchronize()
            counts[label] = trace.counters().get("pm.deposit.sorted", 0)
        finally:
            trace.disable()
            trace.reset()
    assert counts == {"persistent": 5, "per-frame": 0, "two-level": 0}
