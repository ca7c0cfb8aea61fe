"""The isolated exact-gradient PM solve on CUDA (ops/pm_fft.py,
csrc/pm_fft.cu) and the spectra cache it reads (ops/pm.py).

On the CPU: each cache entry is one stacked tensor; the pruned forward
pass order equals the padded rfftn; the four cuFFT plans' layouts
(``pm_fft.plan_specs``), replayed with ``torch.fft`` over flat buffers
between the kernels' index maps, give the plain solve; the kernel path's
callers ask for the fused solve and the plain references never do; CPU
tensors never take the CUDA path. On a card (``chip``: skipped without
one): the solve against the plain torch.fft chain it replaces, at G = 32,
64, 96 and 128, for the base and the difference spectra, its layout, its
counter, and the solves and references that keep the plain path. No JAX
here: the plain path is held to the JAX package in
tests/test_torch_pm.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm, pm2, pm_cuda, pm_fft
from particle_sim_tpu_torch.utils import trace

torch.set_num_threads(1)


def density(g, seed, device="cpu"):
    """f32[g, g, g]: a lumpy positive mass grid."""
    rng = np.random.default_rng(seed)
    rho = rng.random((g, g, g)).astype(np.float32) ** 4
    rho[g // 3, g // 2, g // 4] += 50.0
    return torch.from_numpy(rho).to(device)


def host_spectra(g, which):
    if which == "base":
        return pm._isolated_kernels_host(g, 1.0, 1.5, "exact")
    return pm._isolated_diff_kernels_host(g, 1.0, 0.75, 2.0, "exact")


def device_spectra(g, which, device):
    if which == "base":
        return pm.base_kernels_device(PMConfig(grid=g, softening=1.5), 1.5,
                                      1.0, device=device)
    return pm.diff_kernels_device(g, 1.0, 0.75, 2.0, "exact", device=device)


# -- the spectra cache ---------------------------------------------------------------
@pytest.mark.parametrize("key", ["isolated-exact", "isolated-fd",
                                 "periodic-exact", "diff"])
def test_cached_spectra_are_views_of_one_stacked_tensor(key):
    """Each cache entry is one stacked complex64 tensor, indexed like the
    tuple of spectra: its rows are views equal to the host spectra."""
    pm._DEVICE_KERNELS.clear()
    if key == "diff":
        got = pm.diff_kernels_device(16, 1.0, 0.75, 2.0, "exact")
        want = pm._isolated_diff_kernels_host(16, 1.0, 0.75, 2.0, "exact")
    else:
        boundary, gradient = key.split("-")
        cfg = PMConfig(grid=16, softening=2.0, boundary=boundary,
                       gradient=gradient)
        got = pm.base_kernels_device(cfg, 2.0, 1.0)
        make = (pm._isolated_kernels_host if boundary == "isolated"
                else pm._periodic_kernels_host)
        want = make(16, 1.0, 2.0, gradient)
    assert isinstance(got, torch.Tensor) and got.is_contiguous()
    assert got.shape == (len(want),) + want[0].shape
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.complex64 and a.is_contiguous()
        assert a.untyped_storage().data_ptr() == \
            got.untyped_storage().data_ptr()
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(got[i].numpy(), b)
    pm._DEVICE_KERNELS.clear()


def test_solves_read_the_stacked_spectra_in_place(monkeypatch):
    """The plain isolated and periodic solves take the cached spectra as
    they are: no torch.stack on any solve."""
    def no_stack(*a, **k):
        raise AssertionError("the spectra were stacked again")

    rho = density(8, 3)
    for boundary in ("isolated", "periodic"):
        cfg = PMConfig(grid=8, softening=1.5, boundary=boundary)
        ks = pm.base_kernels_device(cfg, 1.5)
        want = pm.solve_accel(rho, cfg, 1.5, kernels=ks.clone())
        monkeypatch.setattr(torch, "stack", no_stack)
        got = pm.solve_accel(rho, cfg, 1.5)
        monkeypatch.undo()
        assert torch.equal(got, want)


# -- the pass order and the plans' layouts ----------------------------------------------
@pytest.mark.parametrize("g", [4, 6, 8, 12])
def test_pruned_forward_matches_the_padded_rfftn(g):
    """The forward order of the CUDA solve (a 2D r2c over the G live
    z-planes zero-extended to 2G in y and x, then a c2c along z over 2G
    with the upper half zero) equals the rfftn of the (2G)^3 zero pad,
    within float32 rounding."""
    rho = density(g, g)
    want = torch.fft.rfftn(F.pad(rho, (0, g) * 3))
    planes = torch.fft.rfftn(F.pad(rho, (0, g, 0, g)), dim=(1, 2))
    got = torch.fft.fft(planes, n=2 * g, dim=0)
    assert got.shape == want.shape == (2 * g, 2 * g, g + 1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def _offsets(n, embed, stride, dist, batch):
    """int64[batch, *n]: where each element of each transform lies."""
    base = torch.arange(batch)[:, None] * dist
    if len(n) == 1:
        return base + (torch.arange(n[0]) * stride)[None]
    inner = (torch.arange(n[0])[:, None] * embed[1]
             + torch.arange(n[1])[None, :]) * stride
    return base[:, :, None] + inner[None]


def _replay(spec, src, dst, size_in, size_out, inverse=False):
    """One cuFFT plan of plan_specs over flat CPU buffers (unnormalised,
    as cuFFT)."""
    n = spec.n
    half = n[:-1] + (n[-1] // 2 + 1,)
    n_in, n_out = {pm_fft.R2C: (n, half), pm_fft.C2C: (n, n),
                   pm_fft.C2R: (half, n)}[spec.kind]
    at_in = _offsets(n_in, spec.inembed, spec.istride, spec.idist,
                     spec.batch)
    at_out = _offsets(n_out, spec.onembed, spec.ostride, spec.odist,
                      spec.batch)
    assert int(at_in.max()) < size_in and int(at_out.max()) < size_out
    assert at_out.unique().numel() == at_out.numel()   # no two on one word
    dims = tuple(range(1, 1 + len(n)))
    x = src[at_in]
    if spec.kind == pm_fft.R2C:
        y = torch.fft.rfftn(x, dim=dims)
    elif spec.kind == pm_fft.C2R:
        y = torch.fft.irfftn(x, s=n, dim=dims, norm="forward")
    elif inverse:
        y = torch.fft.ifftn(x, dim=dims, norm="forward")
    else:
        y = torch.fft.fftn(x, dim=dims)
    dst[at_out] = y
    return at_out


@pytest.mark.parametrize("g", [4, 5, 8])
@pytest.mark.parametrize("which", ["base", "diff"])
def test_plan_layouts_replayed_give_the_plain_solve(g, which):
    """csrc/pm_fft.cu's sequence on the CPU: the pad, the four plans of
    plan_specs replayed in their advanced layouts over the scratch of
    scratch_shapes, the product into P[kz][c][ky][kx] and the crop into
    f32[G, G, G, 4], against the plain solve within float32 rounding. F12
    writes only below the zero half of b, and I1 is in place."""
    rho = density(g, 10 + g)
    ks = torch.from_numpy(np.stack(host_spectra(g, which)))
    n2 = 2 * g
    shapes = pm_fft.scratch_shapes(g)
    buf = {name: torch.zeros(int(np.prod(shape)), dtype=dtype)
           for name, (shape, dtype) in shapes.items()}
    size = {name: t.numel() for name, t in buf.items()}
    f12, f3, i1, i23 = pm_fft.plan_specs(g)
    buf["a"].view(g, n2, n2)[:, :g, :g] = rho                     # pad
    at = _replay(f12, buf["a"], buf["b"], size["a"], size["b"])
    assert int(at.max()) < size["b"] // 2                         # zero half
    _replay(f3, buf["b"], buf["rhat"], size["b"], size["rhat"])
    np.testing.assert_allclose(
        buf["rhat"].view(n2, n2, g + 1).numpy(),
        torch.fft.rfftn(F.pad(rho, (0, g) * 3)).numpy(),
        rtol=0, atol=1e-5 * float(rho.sum()))
    p = buf["p"].view(n2, 3, n2, g + 1)                           # product
    for c in range(3):
        p[:, c] = buf["rhat"].view(n2, n2, g + 1) * ks[c]
    at = _replay(i1, buf["p"], buf["p"], size["p"], size["p"], inverse=True)
    assert at.numel() == size["p"]                                # in place
    _replay(i23, buf["p"], buf["rr"], size["p"], size["rr"])
    rr = buf["rr"].view(g, 3, n2, n2)                             # crop
    out = (rr[:, :, :g, :g] / n2 ** 3).permute(1, 0, 2, 3)
    want = pm._solve_isolated(rho, ks, g, "exact", 1.0)
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= 1e-5 * scale


def test_solve_bytes_counts_each_pass_once():
    """The bound's bytes at G = 128: 1.36 GB (0.41 ms at 3.35 TB/s), a
    third of it the product (R and three spectra read, three products
    written)."""
    g = 128
    spec = 2 * g * 2 * g * (g + 1) * 8
    assert pm_fft.solve_bytes(g) == 1_359_478_784
    assert 7 * spec / pm_fft.solve_bytes(g) == pytest.approx(0.348, abs=1e-3)


@pytest.mark.parametrize("mode", ["isolated-exact", "isolated-fd",
                                  "periodic-exact", "pair", "diff"])
def test_cpu_tensors_keep_the_plain_path(mode):
    """On CPU tensors no solve goes to ops/pm_fft.py: no launch, no
    pm.solve.fused count."""
    rho = density(8, 5)
    before = pm_fft.LAUNCHES
    trace.enable()
    try:
        if mode == "pair":
            cfg = PMConfig(grid=8, softening=1.5)
            pm.solve_accel_pair(rho, rho * 0.5, cfg, 1.5,
                                device_spectra(8, "diff", "cpu"))
        elif mode == "diff":
            pm.solve_accel_diff(rho, 8, 1.0, 0.75, 2.0)
        else:
            boundary, gradient = mode.split("-")
            pm.solve_accel(rho, PMConfig(grid=8, softening=1.5,
                                         boundary=boundary,
                                         gradient=gradient), 1.5)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert pm_fft.LAUNCHES == before
    assert "pm.solve.fused" not in counts


CFG32 = PMConfig(grid=32, softening=4.0)
LEVEL = pm2.PM2Config(None, 24.0, 1.5)


def _engine(device="cpu", **kw):
    return Engine(particle_count=2048, device=device, method=Method.TORCH,
                  pm=CFG32, pairwise=PairwiseParams(1.0, 4.0), **kw)


def _flat(device="cpu"):
    st = _engine(device, pm_persist=False).state
    return st.pos.reshape(3, -1), st.n_active


#: caller -> (the call, the ``fused`` of each isolated solve it makes)
ROUTES = {
    "pm_cuda.pm_accel": (lambda f, n: pm_cuda.pm_accel(f, n, 1.0, CFG32),
                         [True]),
    "pm_cuda.pm_accel plain": (lambda f, n: pm_cuda.pm_accel(
        f, n, 1.0, CFG32, plain=True), [False]),
    "pm2.pmn_accel": (lambda f, n: pm2.pmn_accel(f, n, 1.0, CFG32,
                                                 (LEVEL,)), [True, True]),
    "pm.pm_accel_ref": (lambda f, n: pm.pm_accel_ref(f, n, 1.0, 4.0, CFG32),
                        [False]),
    "pm2.pmn_accel_ref": (lambda f, n: pm2.pmn_accel_ref(
        f, n, 1.0, CFG32, (LEVEL,)), [False, False]),
    "engine plain": (lambda f, n: _engine(pm_persist=False).step(
        SimParams()), [False]),
    "engine plain persistent": (lambda f, n: _engine(pm_persist=True).step(
        SimParams()), [False]),
    "engine plain pm2": (lambda f, n: _engine(pm_persist=False,
                                              pm2=LEVEL).step(SimParams()),
                         [False, False]),
}


@pytest.mark.parametrize("caller", sorted(ROUTES))
def test_only_the_kernel_path_asks_for_the_fused_solve(monkeypatch, caller):
    """The kernel path's callers (pm_cuda, pm2's fast levels) pass
    ``fused=True`` to every isolated solve; the plain references and the
    plain engine (Method.TORCH) never do, so on the card they keep the
    torch.fft chain the fused solve is held to."""
    call, want = ROUTES[caller]
    flat, n_active = _flat()
    seen = []
    real = pm._solve_isolated

    def spy(rho, ks, g, gradient, h, fused=False):
        seen.append(fused)
        return real(rho, ks, g, gradient, h, fused)

    monkeypatch.setattr(pm, "_solve_isolated", spy)
    call(flat, n_active)
    assert seen == want


@pytest.mark.parametrize("mode", ["solve_accel", "solve_accel_diff",
                                  "pm_cuda.pm_accel", "pm2.pmn_accel"])
def test_cpu_tensors_keep_the_plain_path_when_fused(mode):
    """``fused=True`` on CPU tensors still solves with torch.fft: no
    launch, no pm.solve.fused count, the plain solve's bits."""
    rho = density(32, 6)
    flat, n_active = _flat()
    before = pm_fft.LAUNCHES
    trace.enable()
    try:
        if mode == "solve_accel":
            got = pm.solve_accel(rho, CFG32, 4.0, fused=True)
            assert torch.equal(got, pm.solve_accel(rho, CFG32, 4.0))
        elif mode == "solve_accel_diff":
            got = pm.solve_accel_diff(rho, 32, 1.0, 0.75, 2.0, fused=True)
            assert torch.equal(got, pm.solve_accel_diff(rho, 32, 1.0, 0.75,
                                                        2.0))
        elif mode == "pm_cuda.pm_accel":
            pm_cuda.pm_accel(flat, n_active, 1.0, CFG32)
        else:
            pm2.pmn_accel(flat, n_active, 1.0, CFG32, (LEVEL,))
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert pm_fft.LAUNCHES == before
    assert "pm.solve.fused" not in counts


# -- on the card ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(PSIM_TEST_REAL_DEVICES=1 pytest -m chip)")
    return torch.device("cuda")


def plain_solve(rho, ks, g):
    """The plain torch.fft chain the CUDA path replaced (pm._solve_isolated
    on CPU tensors), on the card."""
    rho_hat = torch.fft.rfftn(F.pad(rho, (0, g) * 3))
    return pm._irfftn_octant_batch(rho_hat[None] * ks, g)[0]


#: The largest |fused - plain| over the largest |plain| the card may show:
#: both sides are float32 transforms of the same sizes in another pass
#: order.
CARD_TOL = 1e-5


@pytest.mark.chip
@pytest.mark.parametrize("g", [32, 64, 96, 128])
@pytest.mark.parametrize("which", ["base", "diff"])
def test_card_solve_matches_the_plain_chain(card, g, which):
    """The CUDA solve against the plain chain on the card, through
    solve_accel (base) and solve_accel_diff (difference) with
    ``fused=True``; the result is the interleaved view the gather reads;
    scratch reuse: a second density and then the first again give the
    first's bits."""
    rho = density(g, g, card)
    ks = device_spectra(g, which, card)
    if which == "base":
        cfg = PMConfig(grid=g, softening=1.5)
        run = lambda r: pm.solve_accel(r, cfg, 1.5, cell_size=1.0,  # noqa
                                       fused=True)
    else:
        run = lambda r: pm.solve_accel_diff(r, g, 1.0, 0.75, 2.0,  # noqa
                                            fused=True)
    before = pm_fft.LAUNCHES
    got = run(rho)
    assert pm_fft.LAUNCHES == before + 1
    pos = torch.zeros((3, 8), device=card)
    assert pm_cuda.grid_layout(got, pos) == "interleaved"
    want = plain_solve(rho, ks, g)
    gap = float((got - want).abs().max()) / float(want.abs().max())
    assert gap <= CARD_TOL, gap
    run(density(g, g + 1, card))
    assert torch.equal(run(rho), got)


@pytest.mark.chip
def test_card_any_grid_and_a_bounded_scratch(card):
    """Odd and uneven grids take the path too; past SCRATCH_CACHE_SIZE
    grids the oldest set of plans and scratch is dropped (its plans
    destroyed), and a grid solved again gets a new set and the same
    bits."""
    first = None
    for g in (9, 12, 17, 20, 24):
        rho = density(g, 30 + g, card)
        ks = device_spectra(g, "diff", card)
        got = pm.solve_accel_diff(rho, g, 1.0, 0.75, 2.0, fused=True)
        want = plain_solve(rho, ks, g)
        gap = float((got - want).abs().max()) / float(want.abs().max())
        assert gap <= CARD_TOL, (g, gap)
        first = got if first is None else first
        assert len(pm_fft._SCRATCH) <= pm_fft.SCRATCH_CACHE_SIZE
    assert not any(k[0] == 9 for k in pm_fft._SCRATCH)
    again = pm.solve_accel_diff(density(9, 39, card), 9, 1.0, 0.75, 2.0,
                                fused=True)
    assert torch.equal(again, first)


@pytest.mark.chip
def test_card_counts_one_fused_solve_a_solve(card):
    """pm.solve.fused and pm_fft.LAUNCHES count each solve on the CUDA
    path: solve_accel and solve_accel_diff with ``fused=True``, and the
    kernel path's pm_cuda.pm_accel and two-level pm2.pmn_accel (coarse
    and fine); the same solves without it count nothing."""
    g = 32
    rho = density(g, 7, card)
    cfg = PMConfig(grid=g, softening=1.5)
    flat, n_active = _flat(card)
    before = pm_fft.LAUNCHES
    trace.enable()
    try:
        pm.solve_accel(rho, cfg, 1.5, fused=True)
        pm.solve_accel_diff(rho, g, 1.0, 0.75, 2.0, fused=True)
        pm_cuda.pm_accel(flat, n_active, 1.0, CFG32)
        pm2.pmn_accel(flat, n_active, 1.0, CFG32, (LEVEL,))
        torch.cuda.synchronize()
        fused = trace.counters().get("pm.solve.fused")
        trace.reset()
        pm.solve_accel(rho, cfg, 1.5)
        pm.solve_accel_diff(rho, g, 1.0, 0.75, 2.0)
        torch.cuda.synchronize()
        plain = trace.counters().get("pm.solve.fused")
    finally:
        trace.disable()
        trace.reset()
    assert (fused, pm_fft.LAUNCHES - before) == (5, 5)
    assert plain is None


@pytest.mark.chip
@pytest.mark.parametrize("mode", ["isolated-fd", "periodic-exact",
                                  "periodic-fd"])
def test_card_other_modes_keep_the_plain_path(card, mode):
    """The periodic and 'fd' solves on the card keep the plain torch.fft
    path even with ``fused=True``: no launch of ops/pm_fft.py."""
    boundary, gradient = mode.split("-")
    cfg = PMConfig(grid=32, softening=1.5, boundary=boundary,
                   gradient=gradient)
    before = pm_fft.LAUNCHES
    grids = pm.solve_accel(density(32, 9, card), cfg, 1.5, fused=True)
    torch.cuda.synchronize()
    assert pm_fft.LAUNCHES == before
    assert torch.isfinite(grids).all()


@pytest.mark.chip
@pytest.mark.parametrize("caller", sorted(
    k for k, (_, want) in ROUTES.items() if not any(want)))
def test_card_plain_references_launch_no_fused_solve(card, caller):
    """On the card the plain references, solve_accel_pair and the plain
    engine (Method.TORCH) keep the torch.fft chain: no launch of
    ops/pm_fft.py, so a check of the kernel path against them holds the
    fused solve to the chain it replaced."""
    before = pm_fft.LAUNCHES
    if caller.startswith("engine"):
        kw = {"pm_persist": "persistent" in caller}
        if "pm2" in caller:
            kw["pm2"] = LEVEL
        _engine(card, **kw).step(SimParams())
    else:
        ROUTES[caller][0](*_flat(card))
        rho = density(32, 8, card)
        pm.solve_accel_pair(rho, rho * 0.5, CFG32, 4.0,
                            device_spectra(32, "diff", card))
    torch.cuda.synchronize()
    assert pm_fft.LAUNCHES == before
