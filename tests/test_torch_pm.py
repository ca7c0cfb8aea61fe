"""The port's particle-mesh modules (ops/pm.py, ops/pm_cuda.py,
ops/diagnostics.py) against the JAX package's on the CPU: the same inputs,
made with numpy from a seed, through both. ``pm_cuda`` runs its plain
versions here (CPU tensors); the JAX fast path runs in interpret mode.
The PM step's two-launch tail (``pm_cuda.momentum_mean`` and
``clean_kick_and_step``) is held to the plain chain it replaces, bit for
bit, on the CPU and, where a card is present, on it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.ops import diagnostics as jdiag
from particle_sim_tpu.ops import pm as jpm
from particle_sim_tpu.ops import pm_pallas as jpm_pallas

from particle_sim_tpu_torch.core.params import P_DT, PMConfig, SimParams
from particle_sim_tpu_torch.ops import diagnostics as diag
from particle_sim_tpu_torch.ops import physics, pm, pm_cuda, step_cuda

torch.set_num_threads(1)

N = 4096


def cloud(n, seed, radius=45.0, offset=(0.0, 0.0, 0.0)):
    """f32[3, n] uniform ball (the JAX PM tests' generator)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
    return np.ascontiguousarray(
        (x * r[:, None] + np.asarray(offset, np.float32)).T.astype(
            np.float32))


def jax_cfg(cfg: PMConfig) -> JPM:
    return JPM(**dataclasses.asdict(cfg))


def both(x):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def case_inputs(case):
    """(positions f32[3, N], n_active, masses or None, PMConfig)."""
    rng = np.random.default_rng(11)
    pos = cloud(N, 1)
    n_active, masses = N, None
    cfg = PMConfig(grid=32, softening=4.0)
    if case == "periodic_strays":
        pos[:, :600] = cloud(600, 2, radius=10.0, offset=(80.0, 0.0, -75.0))
        cfg = PMConfig(grid=32, softening=4.0, boundary="periodic")
    elif case == "masses":
        masses = (rng.random(N) + 0.5).astype(np.float32)
        masses[0] = 300.0
    elif case == "poisoned_padding":
        n_active = 3000
        pos[:, n_active:] = np.float32([[1.0], [2.0], [3.0]])
    elif case == "grid_aligned":
        g = np.arange(-48.0, 48.0, 12.0, dtype=np.float32)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), 0).reshape(3, -1)
        pos[:, :pts.shape[1]] = pts
    elif case == "odd_box":
        cfg = PMConfig(grid=64, box_min=(-70.0, -61.5, -66.25),
                       box_size=131.0, softening=3.0)
    return pos, n_active, masses, cfg


CASES = ["isolated", "periodic_strays", "masses", "poisoned_padding",
         "grid_aligned", "odd_box"]


# -- configuration and spectra ------------------------------------------------------
def test_pmconfig_matches_jax():
    assert [f.name for f in dataclasses.fields(PMConfig)] == [
        f.name for f in dataclasses.fields(JPM)]
    assert dataclasses.asdict(PMConfig()) == dataclasses.asdict(JPM())
    cfg = PMConfig(grid=64, box_size=100.0)
    assert cfg.cell_size == jax_cfg(cfg).cell_size


@pytest.mark.parametrize("boundary", ["isolated", "periodic"])
@pytest.mark.parametrize("gradient", ["exact", "fd"])
def test_host_spectra_bit_identical(boundary, gradient):
    ours = (pm._isolated_kernels_host if boundary == "isolated"
            else pm._periodic_kernels_host)(32, 1.25, 3.0, gradient)
    theirs = (jpm._isolated_kernels_host if boundary == "isolated"
              else jpm._periodic_kernels_host)(32, 1.25, 3.0, gradient)
    assert len(ours) == len(theirs) == (1 if gradient == "fd" else 3)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)
    dev = pm.base_kernels_device(PMConfig(grid=32, softening=3.0,
                                          boundary=boundary,
                                          gradient=gradient),
                                 3.0, 1.25)
    for a, b in zip(dev, theirs):
        assert a.dtype == torch.complex64
        np.testing.assert_array_equal(a.numpy(), b)


def test_device_spectra_cache_is_bounded_lru():
    pm._DEVICE_KERNELS.clear()
    cfg = PMConfig(grid=32)
    first = pm.base_kernels_device(cfg, 1.0)
    for eps in range(2, 2 + pm.DEVICE_CACHE_SIZE - 1):
        pm.base_kernels_device(cfg, float(eps))
    assert pm.base_kernels_device(cfg, 1.0) is first     # hit, now newest
    pm.base_kernels_device(cfg, 99.0)                    # evicts eps = 2
    assert len(pm._DEVICE_KERNELS) == pm.DEVICE_CACHE_SIZE
    assert pm.base_kernels_device(cfg, 1.0) is first
    assert all(k[3] != 2.0 for k in pm._DEVICE_KERNELS)
    # every entry is one stacked tensor of three spectra, and an entry of
    # another kind (the difference spectra) keeps the bound too
    pm.diff_kernels_device(32, 1.0, 1.0, 2.0)
    assert len(pm._DEVICE_KERNELS) == pm.DEVICE_CACHE_SIZE
    for ks in pm._DEVICE_KERNELS.values():
        assert isinstance(ks, torch.Tensor) and ks.is_contiguous()
        assert ks.shape == (3, 64, 64, 33)
    pm._DEVICE_KERNELS.clear()


# -- CIC deposit and gather ----------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_cic_deposit_matches_jax(case):
    pos, n_act, masses, cfg = case_inputs(case)
    jp, tp = both(pos)
    jm, tm = both(masses) if masses is not None else (None, None)
    want = np.asarray(jpm.cic_deposit_ref(jp, jnp.asarray(n_act, jnp.int32),
                                          jax_cfg(cfg), masses=jm))
    got = pm.cic_deposit_ref(tp, n_act, cfg, masses=tm).numpy()
    np.testing.assert_array_equal(
        pm.cell_coords(tp, cfg).numpy(),
        np.asarray(jpm.cell_coords(jp, jax_cfg(cfg))))
    # scatter-adds in another order: 1e-5 of the largest cell
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    total = n_act if masses is None else masses[:n_act].sum()
    assert got.sum() == pytest.approx(total, rel=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_cic_gather_matches_jax(case):
    pos, _, _, cfg = case_inputs(case)
    g = cfg.grid
    grids = np.random.default_rng(5).normal(size=(3, g, g, g)).astype(
        np.float32)
    want = np.asarray(jpm.cic_gather_ref(jnp.asarray(grids), jnp.asarray(pos),
                                         jax_cfg(cfg)))
    got = pm.cic_gather_ref(torch.from_numpy(grids), torch.from_numpy(pos),
                            cfg).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_periodic_wraps_out_of_box_particles():
    """As tests/test_pm.py: a particle past the +x face re-enters at -x; one
    in the last cell splits its mass across the seam."""
    cfg = PMConfig(boundary="periodic", softening=3.0)
    h = cfg.cell_size
    pos = torch.tensor([[64.0 + 2.5 * h], [0.0], [0.0]])
    rho = pm.cic_deposit_ref(pos, 1, cfg)
    z, y, x = np.unravel_index(int(rho.argmax()), rho.shape)
    assert x in (2, 3) and float(rho.sum()) == pytest.approx(1.0, rel=1e-5)
    pos2 = torch.tensor([[cfg.box_min[0] + 127.6 * h], [0.0], [0.0]])
    flat_x = pm.cic_deposit_ref(pos2, 1, cfg).sum(dim=(0, 1))
    assert flat_x[127] > 0 and flat_x[0] > 0


# -- the spectral solve and the plain pipeline --------------------------------------
@pytest.mark.parametrize("boundary,gradient,layout", [
    ("isolated", "exact", "interleaved"), ("isolated", "fd", "interleaved"),
    ("periodic", "exact", "planar"), ("periodic", "fd", "interleaved")])
def test_solve_accel_layout_and_plain_gather(boundary, gradient, layout):
    """solve_accel returns the interleaved view (or dense planes, periodic
    'exact'; test_solve_accel_matches_jax holds its values to JAX's), and
    the gather reads it exactly as it reads a contiguous copy."""
    cfg = PMConfig(grid=32, softening=3.0, boundary=boundary,
                   gradient=gradient)
    rho = np.random.default_rng(4).random((32, 32, 32)).astype(np.float32)
    grids = pm.solve_accel(torch.from_numpy(rho), cfg, cfg.softening)
    tp = torch.from_numpy(cloud(N, 3))
    assert grids.shape == (3, 32, 32, 32)
    assert pm_cuda.grid_layout(grids, tp) == layout
    periodic = boundary == "periodic"
    got = pm_cuda.gather_plain(grids, tp, 3000, cfg.box_min, cfg.cell_size,
                               periodic=periodic)
    dense = pm_cuda.gather_plain(grids.contiguous(), tp, 3000, cfg.box_min,
                                 cfg.cell_size, periodic=periodic)
    assert torch.equal(got, dense)
    assert torch.equal(pm_cuda.gather(grids, tp, 3000, cfg.box_min,
                                      cfg.cell_size, periodic=periodic), dense)


def _strided(storage_elems, offset=0):
    """An f32[3, 32, 32, 32] view with the interleaved strides on a flat
    buffer of ``storage_elems`` floats, starting at ``offset``."""
    flat = torch.arange(storage_elems, dtype=torch.float32)
    return torch.as_strided(flat, (3, 32, 32, 32), (1, 4096, 128, 4), offset)


@pytest.mark.parametrize("case,layout", [
    ("planar 3", "planar"), ("planar 1", "planar"),
    ("interleaved view", "interleaved"),
    ("interleaved on a flat buffer", "interleaved"),
    ("transposed planes", None), ("every other cell", None),
    ("one channel of the interleaved buffer", None),
    ("five-lane buffer", None), ("misaligned start", None),
    ("short storage", None), ("float64 planes", None)])
def test_grid_layout_accepts_two_layouts_only(case, layout):
    """The gather wrapper's stride check: dense planes and the interleaved
    view pass, every other layout raises ValueError (before any kernel)."""
    g = 32
    buf = torch.randn(g, g, g, 4)
    grids = {
        "planar 3": lambda: torch.randn(3, g, g, g),
        "planar 1": lambda: torch.randn(1, g, g, g),
        "interleaved view": lambda: pm.interleaved_view(buf),
        "interleaved on a flat buffer": lambda: _strided(4 * g ** 3),
        "transposed planes": lambda: torch.randn(3, g, g, g).transpose(1, 3),
        "every other cell": lambda: torch.randn(3, g, g, 2 * g)[..., ::2],
        "one channel of the interleaved buffer":
            lambda: buf[..., :1].permute(3, 0, 1, 2),
        "five-lane buffer":
            lambda: torch.randn(g, g, g, 5)[..., :3].permute(3, 0, 1, 2),
        "misaligned start": lambda: _strided(4 * g ** 3 + 1, offset=1),
        "short storage": lambda: _strided(4 * g ** 3 - 1),
        "float64 planes": lambda: torch.randn(3, g, g, g, dtype=torch.float64),
    }[case]()
    pos = torch.from_numpy(cloud(64, 2))
    if layout is None:
        with pytest.raises(ValueError, match="grids"):
            pm_cuda.grid_layout(grids, pos)
        with pytest.raises(ValueError, match="grids"):
            pm_cuda.gather(grids, pos, 64, (-64.0, -64.0, -64.0), 4.0,
                           periodic=False)
    else:
        assert pm_cuda.grid_layout(grids, pos) == layout
        out = pm_cuda.gather(grids, pos, 64, (-64.0, -64.0, -64.0), 4.0,
                             periodic=False)
        assert out.shape == (grids.shape[0], 64)


@pytest.mark.parametrize("boundary", ["isolated", "periodic"])
@pytest.mark.parametrize("gradient", ["exact", "fd"])
def test_solve_accel_matches_jax(boundary, gradient):
    cfg = PMConfig(grid=32, softening=3.0, boundary=boundary,
                   gradient=gradient)
    rho = np.random.default_rng(3).random((32, 32, 32)).astype(np.float32)
    want = np.asarray(jpm.solve_accel(jnp.asarray(rho), jax_cfg(cfg),
                                      cfg.softening))
    got = pm.solve_accel(torch.from_numpy(rho), cfg, cfg.softening).numpy()
    assert got.shape == want.shape == (3, 32, 32, 32)
    # torch's CPU FFT and XLA's round differently: 1e-4 of the largest value
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("auto_box", [False, True])
@pytest.mark.parametrize("with_masses", [False, True])
def test_pm_accel_and_step_ref_match_jax(auto_box, with_masses):
    pos = cloud(N, 4, radius=20.0, offset=(10.0, -5.0, 3.0))
    n_act = 3500
    cfg = PMConfig(grid=32, softening=4.0 if not auto_box else 2.0,
                   auto_box=auto_box)
    masses = None
    if with_masses:
        masses = np.ones(N, np.float32)
        masses[:10] = 50.0
    jm, tm = both(masses) if masses is not None else (None, None)
    jn = jnp.asarray(n_act, jnp.int32)
    want = np.asarray(jpm.pm_accel_ref(jnp.asarray(pos), jn, 1.3,
                                       cfg.softening, jax_cfg(cfg),
                                       masses=jm))
    got = pm.pm_accel_ref(torch.from_numpy(pos), n_act, 1.3, cfg.softening,
                          cfg, masses=tm).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert (got[:, n_act:] == 0).all()

    planes = pos.reshape(3, 32, 128)
    vel = np.random.default_rng(6).normal(size=planes.shape).astype(
        np.float32)
    pv = SimParams(delta_time=0.016, gravity=0.5).pack()
    pp = np.float32([1.3, cfg.softening])
    jpos, jvel = jpm.step_pm_ref(jnp.asarray(planes), jnp.asarray(vel),
                                 jnp.asarray(pv), jnp.asarray(pp), jn,
                                 jax_cfg(cfg), masses=jm)
    tpos, tvel = pm.step_pm_ref(torch.from_numpy(planes.copy()),
                                torch.from_numpy(vel), torch.from_numpy(pv),
                                torch.from_numpy(pp), n_act, cfg, masses=tm)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-5)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel),
                               atol=1e-4 * scale * 0.016 + 1e-6)


# -- the kernel path (its plain versions on the CPU) -----------------------------------
@pytest.mark.parametrize("case", ["isolated", "periodic_strays",
                                  "masses_auto_box"])
def test_pm_accel_matches_pallas_interpret(case):
    """pm_cuda.pm_accel against pm_pallas.pm_accel in interpret mode at
    the JAX tests' own bars (test_pm_pallas.py): 0.02 of the largest
    acceleration, 0.03 in periodic mode away from the one-cell seam the
    sorted TPU path clamps (the port wraps there, as the plain version)."""
    pos = cloud(2048, 7, radius=45.0)
    n_act, masses = 1900, None
    cfg = PMConfig(grid=64, softening=4.0)
    bar = 0.02
    if case == "periodic_strays":
        pos[:, :300] = cloud(300, 8, radius=10.0, offset=(80.0, 0.0, -75.0))
        cfg = PMConfig(grid=64, softening=4.0, boundary="periodic")
        bar = 0.03
    elif case == "masses_auto_box":
        cfg = PMConfig(grid=32, softening=4.0, auto_box=True)
        masses = (np.random.default_rng(9).random(2048) + 0.5).astype(
            np.float32)
    jm, tm = both(masses) if masses is not None else (None, None)
    want = np.asarray(jpm_pallas.pm_accel(
        jnp.asarray(pos), jnp.asarray(n_act, jnp.int32), 1.0, jax_cfg(cfg),
        masses=jm, interpret=True))
    got = pm_cuda.pm_accel(torch.from_numpy(pos), n_act, 1.0, cfg,
                           masses=tm).numpy()
    keep = np.ones(n_act, bool)
    if cfg.boundary == "periodic":
        c = pm.cell_coords(torch.from_numpy(pos), cfg).numpy()[:, :n_act]
        keep = (c < cfg.grid - 1.0).all(axis=0)
        assert keep.sum() > 0.9 * n_act
    scale = np.abs(want[:, :n_act]).max()
    np.testing.assert_allclose(got[:, :n_act][:, keep],
                               want[:, :n_act][:, keep], atol=bar * scale)
    assert (got[:, n_act:] == 0).all() and (want[:, n_act:] == 0).all()


@pytest.mark.parametrize("case", ["isolated", "periodic_strays", "masses",
                                  "poisoned_padding", "auto_box",
                                  "periodic_fd", "grid_48"])
def test_pm_accel_matches_plain_reference(case):
    """pm_cuda.pm_accel (deposit_plain / gather_plain here) against
    pm.pm_accel_ref: 1e-4 of the largest acceleration; padding exactly 0;
    the mass-weighted net force 0."""
    pos, n_act, masses, cfg = case_inputs(
        case if case in CASES else "isolated")
    if case == "auto_box":
        cfg = dataclasses.replace(cfg, auto_box=True, softening=2.0)
    elif case == "periodic_fd":
        cfg = dataclasses.replace(cfg, boundary="periodic", gradient="fd")
    elif case == "grid_48":      # outside the TPU kernels' grids
        cfg = dataclasses.replace(cfg, grid=48)
    tp = torch.from_numpy(pos)
    tm = None if masses is None else torch.from_numpy(masses)
    got = pm_cuda.pm_accel(tp, n_act, 0.7, cfg, masses=tm)
    want = pm.pm_accel_ref(tp, n_act, 0.7, cfg.softening, cfg, masses=tm)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert (got[:, n_act:] == 0).all()
    m = torch.ones(N) if tm is None else tm
    net = (got[:, :n_act].double() * m[:n_act].double()).sum(1).abs()
    typical = float(got[:, :n_act].norm(dim=0).mean()) * float(
        m[:n_act].sum())
    assert float(net.max()) < 1e-5 * typical


def test_deposit_and_gather_wrappers():
    """The wrappers' argument forms agree: a live mask equals n_active,
    device-tensor box and cell equal tuple and float; dead particles
    gather exactly 0; one grid (a potential) gathers as one of three; any
    grid size works; bad tensors raise."""
    pos, _, _, cfg = case_inputs("isolated")
    tp = torch.from_numpy(pos)
    live = torch.arange(N) < 3000
    a = pm_cuda.deposit(tp, 3000, cfg.box_min, cfg.cell_size, 32,
                        periodic=False)
    b = pm_cuda.deposit(tp, 0, torch.tensor(cfg.box_min).reshape(3, 1),
                        torch.tensor(cfg.cell_size), 32, periodic=False,
                        live=live)
    assert torch.equal(a, b)
    masses = torch.linspace(0.5, 2.0, N)
    c = pm_cuda.deposit(tp, 3000, cfg.box_min, cfg.cell_size, 32,
                        periodic=False, masses=masses)
    assert float(c.sum()) == pytest.approx(float(masses[:3000].sum()),
                                           rel=1e-5)
    grids = torch.randn(3, 32, 32, 32)
    acc = pm_cuda.gather(grids, tp, 3000, cfg.box_min, cfg.cell_size,
                         periodic=False)
    ref = pm.cic_gather_ref(grids, tp, cfg)
    assert torch.equal(acc[:, :3000], ref[:, :3000])
    assert (acc[:, 3000:] == 0).all()
    phi = pm_cuda.gather(grids[1:2].contiguous(), tp, 3000, cfg.box_min,
                         cfg.cell_size, periodic=False)
    assert phi.shape == (1, N) and torch.equal(phi[0], acc[1])
    cfg48 = PMConfig(grid=48, softening=4.0)
    d48 = pm_cuda.deposit(tp, 3000, cfg48.box_min, cfg48.cell_size, 48,
                          periodic=False)
    assert torch.equal(d48, pm.cic_deposit_ref(tp, 3000, cfg48))
    with pytest.raises(ValueError, match="grids"):
        pm_cuda.gather(grids[:2].contiguous(), tp, 10, cfg.box_min, 1.0,
                       periodic=False)
    with pytest.raises(ValueError, match="float32"):
        pm_cuda.deposit(tp.double(), 10, cfg.box_min, 1.0, 32,
                        periodic=False)
    with pytest.raises(ValueError, match="masses"):
        pm_cuda.deposit(tp, 10, cfg.box_min, 1.0, 32, periodic=False,
                        masses=masses[:5])


def test_nonfinite_grid_comes_out_nonfinite():
    """A solver blowup propagates: NaN in the x grid gives NaN x
    accelerations at every live particle, the y and z components stay
    finite (per component, finer than the TPU pack), dead ones stay 0."""
    pos, _, _, cfg = case_inputs("isolated")
    tp = torch.from_numpy(pos)
    grids = torch.randn(3, 32, 32, 32)
    grids[0] = float("nan")
    acc = pm_cuda.gather(grids, tp, 3000, cfg.box_min, cfg.cell_size,
                         periodic=False)
    assert torch.isnan(acc[0, :3000]).all()
    assert torch.isfinite(acc[1:, :3000]).all()
    assert (acc[:, 3000:] == 0).all()


def test_step_pm_updates_in_place():
    planes = cloud(N, 12).reshape(3, 32, 128)
    pos, vel = torch.from_numpy(planes.copy()), torch.zeros(3, 32, 128)
    pv = torch.from_numpy(SimParams(delta_time=0.02).pack())
    pp = torch.tensor([1.0, 4.0])
    cfg = PMConfig(grid=32, softening=4.0)
    want = pm.step_pm_ref(pos.clone(), vel.clone(), pv, pp, N, cfg)
    p, v = pm_cuda.step_pm(pos, vel, pv, pp, N, cfg)
    assert p is pos and v is vel
    assert torch.equal(pos, want[0]) and torch.equal(vel, want[1])


# -- the momentum clean, the scale and the kick in two launches ---------------------
def _tail_inputs(case, n, device):
    """(pos, vel, acc, pv, n_active, masses, live, g, cell) for one case
    of the PM step's tail; planes f32[3, n]."""
    rng = np.random.default_rng(23)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pos = t(rng.normal(scale=20.0, size=(3, n)))
    vel = t(rng.normal(size=(3, n)))
    # a bias the clean must take off, as the PM solve leaves one
    acc = t(rng.normal(size=(3, n)) + np.array([[0.3], [-0.2], [0.1]]))
    pv = t(SimParams(delta_time=0.016, is_mouse_dragging=True,
                     mouse_position=(5.0, -3.0, 8.0), mouse_force=40.0,
                     mouse_radius=30.0).pack())
    n_active = t(n, torch.int32)
    masses = live = cell = None
    g = t([0.7, 4.0])[0]                           # pair_vec[0]: a 0-d view
    if case in ("masses", "cuda_100k"):
        masses = t(rng.random(n) + 0.5)
        masses[0] = 300.0
    if case in ("live_shuffled", "cuda_100k"):
        # a live mask in a shuffled slot order (the persistent PM's)
        live = t(rng.permutation(n) < n - n // 5, torch.bool)
    if case == "n_active":
        n_active = t(n - 1000, torch.int32)
        acc[:, n - 1000:] = 1e3                    # dead slots: cleaned to 0
    if case in ("auto_box", "cuda_100k"):
        cell = t(1.37)                             # the scale is g / h^2
    return pos, vel, acc, pv, n_active, masses, live, g, cell


def _plain_tail(pos, vel, acc, pv, n_active, masses, live, g, cell):
    """The plain chain: pm.momentum_clean, the scale, then
    physics.kick_and_step_planes (new tensors)."""
    a = pm.momentum_clean(acc, n_active, masses, live=live)
    a = (g if cell is None else g / (cell * cell)) * a
    return physics.kick_and_step_planes(pos, vel, a, pv)


@pytest.mark.parametrize("case", ["plain", "masses", "live_shuffled",
                                  "n_active", "auto_box", "cuda_100k"])
def test_momentum_mean_and_clean_kick_match_the_plain_chain(case):
    """On CPU tensors the two-launch tail takes its plain versions: bit for
    bit the plain chain, and no launch counted. On the card (cuda_100k,
    100,000 particles with masses, a shuffled live mask and the auto-box
    scale): the kernel's mean within 1e-6 of the largest |mean| of a
    float64 mean, and the state bit for bit the chain it replaced (the
    clean, the scale and vel += a*dt as torch passes, then the step
    kernel) fed the kernel's mean."""
    on_card = case.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the kernels with the "
                    "plain chain at 100,000 particles")
    n = 100_000 if on_card else N
    args = _tail_inputs(case, n, "cuda" if on_card else "cpu")
    pos, vel, acc, pv, n_active, masses, live, g, cell = args
    before = (pm_cuda.MOMENTUM_LAUNCHES, pm_cuda.KICK_FUSED_LAUNCHES,
              step_cuda.LAUNCHES)
    mean = pm_cuda.momentum_mean(acc, n_active, masses=masses, live=live)
    p, v = pos.clone(), vel.clone()
    out = pm_cuda.clean_kick_and_step(p, v, acc, pv, mean, n_active, g,
                                      live=live, cell=cell)
    assert out[0] is p and out[1] is v
    after = (pm_cuda.MOMENTUM_LAUNCHES, pm_cuda.KICK_FUSED_LAUNCHES,
             step_cuda.LAUNCHES)
    if not on_card:
        assert after == before                    # no kernel on the CPU
        assert torch.equal(mean, pm.momentum_mean(acc, n_active, masses,
                                                  live=live))
        want_p, want_v = _plain_tail(*args)
        assert torch.equal(p, want_p) and torch.equal(v, want_v)
        return
    assert after == tuple(b + 1 for b in before)
    w = live.double() * masses.double()
    exact = (acc.double() * w).sum(dim=1) / w.sum()
    gap = float((mean.double() - exact).abs().max())
    assert gap <= 1e-6 * float(exact.abs().max()), gap
    a = (acc - mean[:, None]) * live.to(torch.float32)[None]
    a = (g / (cell * cell)) * a
    wp, wv = pos.clone(), vel.clone()
    wv.add_(a * pv[P_DT])
    step_cuda.step(wp, wv, pv)
    assert torch.equal(p, wp) and torch.equal(v, wv)


def _bad_tail(case):
    """Keyword arguments of clean_kick_and_step with one fault."""
    pos, vel, acc, pv, n_active, _, live, g, _ = _tail_inputs(
        "live_shuffled", 1024, "cpu")
    mean = torch.zeros(3)
    kw = dict(pos=pos, vel=vel, acc=acc, param_vec=pv, mean=mean,
              n_active=n_active, g_const=g, live=live)
    what, field = case.split(":")
    t = kw[field]
    if what == "dtype":
        kw[field] = t.to(torch.float64 if t.dtype != torch.float64
                         else torch.float32)
    elif what == "shape":
        kw[field] = t[..., :-1] if t.ndim else t.reshape(1).repeat(2)
    elif what == "device":
        kw[field] = t.to("meta")
    elif what == "noncontig":
        kw[field] = (t.T.contiguous().T if t.ndim == 2
                     else torch.stack([t, t], -1)[..., 0])
    return kw


@pytest.mark.parametrize("case", [
    "dtype:acc", "dtype:mean", "dtype:live", "dtype:g_const", "shape:acc",
    "shape:mean", "shape:live", "shape:g_const", "device:acc", "device:mean",
    "device:live", "noncontig:acc", "noncontig:mean", "noncontig:live"])
def test_clean_kick_and_momentum_mean_refuse_bad_input(case):
    """The two wrappers raise on a wrong dtype, shape, device or a
    non-contiguous operand, and leave the state alone."""
    kw = _bad_tail(case)
    pos0, vel0 = kw["pos"].clone(), kw["vel"].clone()
    with pytest.raises((TypeError, ValueError)):
        pm_cuda.clean_kick_and_step(**kw)
    assert torch.equal(kw["pos"], pos0) and torch.equal(kw["vel"], vel0)
    if case.endswith((":acc", ":live")):
        with pytest.raises((TypeError, ValueError)):
            pm_cuda.momentum_mean(kw["acc"], kw["n_active"], live=kw["live"])


# -- diagnostics -------------------------------------------------------------------------
def _diag_state(n, cap, seed, v_scale=1.5):
    rng = np.random.default_rng(seed)
    pos = np.zeros((3, cap), np.float32)
    vel = np.zeros((3, cap), np.float32)
    pos[:, :n] = cloud(n, seed, radius=30.0)
    vel[:, :n] = v_scale * rng.normal(size=(3, n))
    return pos.reshape(3, -1, 128), vel.reshape(3, -1, 128)


@pytest.mark.parametrize("with_masses", [False, True])
def test_measure_direct_matches_jax(with_masses):
    n, cap = 2000, 3072
    pos, vel = _diag_state(n, cap, 1)
    masses = None
    if with_masses:
        masses = np.ones(cap, np.float32)
        masses[:50] = 20.0
    jm, tm = both(masses) if masses is not None else (None, None)
    want = jdiag.measure(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(n, jnp.int32), g_const=0.5,
                         softening=3.0, potential=True, masses=jm)
    got = diag.measure(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.tensor(n, dtype=torch.int32), g_const=0.5,
                       softening=3.0, potential=True, masses=tm)
    for k in ("kinetic", "potential", "mean_radius", "max_speed"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-5)
    np.testing.assert_allclose(got.momentum, want.momentum, rtol=1e-4,
                               atol=1e-3)
    assert got.as_dict().keys() == want.as_dict().keys()
    assert diag.measure(torch.from_numpy(pos), torch.from_numpy(vel), n
                        ).potential is None


@pytest.mark.parametrize("auto_box", [False, True])
def test_measure_pm_potential_matches_jax(auto_box):
    """Above 12,288 live particles the potential is the mesh estimate."""
    n = 16384
    pos, vel = _diag_state(n, n, 2)
    cfg = PMConfig(grid=32, softening=6.0 if not auto_box else 2.0,
                   auto_box=auto_box)
    want = jdiag.measure(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(n, jnp.int32), g_const=1.0,
                         softening=cfg.softening, pm_cfg=jax_cfg(cfg),
                         potential=True)
    got = diag.measure(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.tensor(n, dtype=torch.int32), g_const=1.0,
                       softening=cfg.softening, pm_cfg=cfg, potential=True)
    assert got.potential is not None and got.potential < 0
    assert got.potential == pytest.approx(want.potential, rel=1e-4)
    assert got.kinetic == pytest.approx(want.kinetic, rel=1e-5)


def test_measure_pm_potential_periodic_masses_matches_jax():
    """The mesh potential in periodic mode, with masses and padding."""
    n, cap = 14000, 14336
    pos, vel = _diag_state(n, cap, 4)
    masses = np.ones(cap, np.float32)
    masses[:40] = 25.0
    cfg = PMConfig(grid=32, softening=6.0, boundary="periodic")
    jm, tm = both(masses)
    want = jdiag.measure(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(n, jnp.int32), g_const=0.8,
                         softening=cfg.softening, pm_cfg=jax_cfg(cfg),
                         potential=True, masses=jm)
    got = diag.measure(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.tensor(n, dtype=torch.int32), g_const=0.8,
                       softening=cfg.softening, pm_cfg=cfg, potential=True,
                       masses=tm)
    assert got.potential is not None and got.potential < 0
    assert got.potential == pytest.approx(want.potential, rel=1e-4)
