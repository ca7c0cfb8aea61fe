"""The refinement windows' bookkeeping in one pass a window
(``pm2.window_pass``, csrc/windows.cu): every level's origin and mask, and
the exact window's origin, members and count.

On the CPU: the pass's launch plan (``pm2._plan``), run here by
:func:`emulate` in the kernel's arithmetic (float64 sums of each launch's
members, rounded to float32, then the origin in float32), holds to the
plain functions (``_nested_wmins``, ``_in_window``, ``pmx.window_origin``)
on static and tracked mixes, with masses and without, with the exact
window and without levels, and where the clamp binds; the plan launches
once a window and once more when the outermost origin is tracked; the
plumbing gives the plain path's bits (``fine_accel_fast(inner=)``,
``pmn_accel_raw(exact=)``, ``exact_accel(window=)``, ``state_keys``), and
the plain pass counts no fused pass; the C entry is bound with its
arguments.

On a card (``chip``: skipped without one): the kernel against the plain
functions on the deep-zoom exact cell's scene at 500,000 and a hollow
sphere at 4M (origins within a few float32 ulps of the float32 centroid
of float64 sums over the kernel's own parent members, masks bit for bit
``_in_window`` at the kernel's origin, and equal to the plain masks but
within 1e-5 of a face; two calls give the same bits; the capacity scene
where the clamp binds), ``pmn_accel_raw(exact=)`` hands back the pass's
exact window, and a traced engine counts ``pm2.windows.fused`` once a
step and once a verdict. No JAX here."""

import math
import re
from pathlib import Path

import pytest
import torch

from particle_sim_tpu_torch.core.params import (
    Method, PMConfig, SimParams,
)
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.ops import pm2, pm_persist, pmx
from particle_sim_tpu_torch.ops.pm2 import PM2Config
from particle_sim_tpu_torch.ops.pmx import PMXConfig
from particle_sim_tpu_torch.utils import cuda_build, trace

torch.set_num_threads(1)

CSRC = Path(pm2.__file__).resolve().parent.parent / "csrc"
CFG = PMConfig(grid=32, softening=3.0)
U = 2.0 ** -24

T32 = PM2Config(None, 32.0, 0.6)
T8 = PM2Config(None, 8.0, 0.2)
S32 = PM2Config((-14.0, -15.0, -17.0), 32.0, 0.6, margin=0.5)
S8 = PM2Config((-2.0, -3.5, -5.0), 8.0, 0.2, margin=0.25)
X2 = PMXConfig(2.0, 0.05, capacity=4096)
XS = PMXConfig(2.0, 0.05, capacity=4096, window_min=(-0.5, -1.0, -2.5))
#: levels, exact window, masses: static and tracked mixes
CASES = {
    "tracked": ((T32, T8), None, False),
    "tracked_masses": ((T32, T8), None, True),
    "static": ((S32, S8), None, False),
    "static_under_tracked": ((T32, S8), None, True),
    "tracked_under_static": ((S32, T8), None, False),
    "one_level": ((T32,), None, True),
    "exact": ((T32, T8), X2, False),
    "exact_masses": ((T32, T8), X2, True),
    "exact_static": ((T32, T8), XS, False),
    "exact_no_levels": ((), X2, True),
    "exact_one_static_level": ((S32,), X2, False),
}


def scene(n: int = 8192, seed: int = 3, device="cpu") -> tuple:
    """(pos f32[3, n], live, masses): a core of radius ~1, a cluster of
    ~4 and a halo of ~15 off the origin, the last 300 slots dead."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn((3, n), generator=g)
    pos[:, n // 4: n // 2] *= 4.0
    pos[:, n // 2:] *= 15.0
    pos += torch.tensor([1.5, -0.5, 0.7])[:, None]
    masses = torch.rand(n, generator=g) + 0.5
    live = torch.arange(n) < n - 300
    return pos.to(device), live.to(device), masses.to(device)


def off_centre(n: int = 4096) -> tuple:
    """Two balls of radius 1 on the x axis, balanced about the origin
    (3,110 at 3.8, 986 at -12): the levels centre on the origin, level 2's
    face (x = 4) cuts the first ball, and the exact window's origin is
    clamped into level 2 by ~0.45."""
    g = torch.Generator().manual_seed(29)

    def ball(count, x):
        d = torch.randn((3, count), generator=g)
        d = d / d.norm(dim=0, keepdim=True)
        r = torch.rand(count, generator=g) ** (1.0 / 3.0)
        return d * r + torch.tensor([x, 0.0, 0.0])[:, None]

    pos = torch.cat([ball(3110, 3.8), ball(n - 3110, -12.0)], dim=1)
    return pos, torch.ones(n, dtype=torch.bool), None


def windows_of(levels, cfgx) -> tuple:
    return tuple(levels) + (() if cfgx is None else (cfgx,))


def plan_of(levels, cfgx) -> tuple:
    return pm2._plan(tuple(pm2.Win.of(c) for c in windows_of(levels, cfgx)),
                     cfgx is not None)


def emulate(pos, live, levels, masses=None, cfgx=None) -> tuple:
    """(origins, masks) a window, levels then the exact one: the plan's
    launches in csrc/windows.cu's arithmetic with torch on any device."""
    wins = windows_of(levels, cfgx)
    origins, masks, sums = [None] * len(wins), [None] * len(wins), None
    x64 = pos.double()
    for ln in plan_of(levels, cfgx):
        member = live
        if ln.win >= 0:
            if ln.tracked:
                o = sums[:3] / torch.clamp_min(sums[3], 1e-12) - ln.half
            else:
                o = torch.tensor(ln.static, dtype=torch.float32,
                                 device=pos.device)
            if ln.parent >= 0:
                p = origins[ln.parent]
                o = torch.clamp(o, p + ln.clamp_lo, p + ln.clamp_hi)
            lo = o[:, None] + ln.shrink
            hi = lo + ln.extent
            member = ((pos >= lo) & (pos < hi)).all(dim=0) & live
            origins[ln.win], masks[ln.win] = o, member
        w = member.double() if masses is None else (member.double()
                                                    * masses.double())
        sums = torch.cat([(x64 * w[None]).sum(dim=1),
                          w.sum().reshape(1)]).float()
    return origins, masks


def plain(pos, live, levels, masses=None, cfgx=None) -> tuple:
    """(origins, masks) of the plain functions, as :func:`emulate`."""
    wins = windows_of(levels, cfgx)
    origins = (list(pm2._nested_wmins(pos, live, None, levels, masses))
               if levels else [])
    if cfgx is not None:
        origins.append(pmx.window_origin(pos, live, cfgx, levels,
                                         masses=masses))
    masks = [pm2._in_window(pos, o, c.window_size, c.margin) & live
             for o, c in zip(origins, wins)]
    return origins, masks


def ulp(x: torch.Tensor) -> torch.Tensor:
    x = x.float().abs()
    return (torch.nextafter(x, torch.full_like(x, math.inf)) - x).double()


def sum_bar(pos, member, masses) -> torch.Tensor:
    """f64[3]: how far the plain float32 centroid of ``member`` may lie
    from the float64 one: the float32 sums' roundings, ceil(log2 n) + 4
    units of sum w |x| / sum w."""
    w = member.double()
    if masses is not None:
        w = w * masses.double()
    tot = float(w.sum())
    if tot == 0.0:
        return torch.zeros(3, dtype=torch.float64, device=pos.device)
    scale = (pos.double().abs() * w[None]).sum(dim=1) / tot
    k = math.ceil(math.log2(max(int(member.sum()), 2))) + 4
    return k * U * scale


def assert_like_plain(pos, live, levels, masses, cfgx, got_o, got_m):
    """``got`` (a window's origins and masks) against the plain functions:
    a tracked origin within the float32 sums' bar of its parent's members,
    any origin within its parent's bar (the clamp) and 4 ulps of its
    centroid; the masks equal but for slots within ``tol`` of a face of
    either window, tol the larger of 1e-5 and twice the origins' gap."""
    want_o, want_m = plain(pos, live, levels, masses, cfgx)
    wins = windows_of(levels, cfgx)
    parent = live
    prev = torch.zeros(3, dtype=torch.float64, device=pos.device)
    for k, c in enumerate(wins):
        gap = (got_o[k].double() - want_o[k].double()).abs()
        bar = prev
        if c.window_min is None:
            bar = torch.maximum(bar, sum_bar(pos, parent, masses))
        bar = bar + 4 * ulp(want_o[k].abs() + c.window_size)
        assert bool((gap <= bar).all()), (k, gap, bar)
        prev = bar
        tol = max(1e-5, 2 * float(gap.max()))
        differ = got_m[k] != want_m[k]
        if bool(differ.any()):
            p = pos[:, differ].double()
            near = torch.zeros(p.shape[1], dtype=torch.bool,
                               device=pos.device)
            for o in (got_o[k], want_o[k]):
                lo = o.double()[:, None] + c.margin
                hi = lo + (c.window_size - 2.0 * c.margin)
                near |= (((p - lo).abs() < tol) | ((p - hi).abs() < tol)
                         ).any(dim=0)
            assert bool(near.all()), (k, int(differ.sum()))
        parent = got_m[k]


# -- on the CPU: the plan ------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_the_plan_in_the_kernels_arithmetic_is_the_plain_bookkeeping(case):
    levels, cfgx, with_masses = CASES[case]
    pos, live, masses = scene()
    masses = masses if with_masses else None
    got_o, got_m = emulate(pos, live, levels, masses, cfgx)
    assert_like_plain(pos, live, levels, masses, cfgx, got_o, got_m)
    assert all(int(m.sum()) > 0 for m in got_m)


def test_the_plan_clamps_where_the_clamp_binds():
    pos, live, masses = off_centre()
    levels, cfgx = (T32, T8), X2
    got_o, got_m = emulate(pos, live, levels, masses, cfgx)
    assert_like_plain(pos, live, levels, masses, cfgx, got_o, got_m)
    # unclamped, the origin would lie ~0.45 further out
    free = (pm2.window_min(pos, None, cfgx, None, live=got_m[1]))
    assert float((free - got_o[2]).abs().max()) > 0.1


@pytest.mark.parametrize("case,launches", [
    ("tracked", 3), ("static", 2), ("static_under_tracked", 3),
    ("tracked_under_static", 2), ("one_level", 2), ("exact", 4),
    ("exact_static", 4), ("exact_no_levels", 2),
    ("exact_one_static_level", 2)])
def test_a_launch_a_window_and_one_for_a_tracked_outermost(case, launches):
    levels, cfgx, _ = CASES[case]
    plan = plan_of(levels, cfgx)
    wins = windows_of(levels, cfgx)
    assert len(plan) == launches
    assert [ln.win for ln in plan if ln.win >= 0] == list(range(len(wins)))
    # a launch reduces its members' sums only for a tracked window after it
    for a, b in zip(plan, plan[1:]):
        assert a.sums == b.tracked
    assert not plan[-1].sums
    # two static levels are validated, not clamped; the exact window and
    # every other nested pair are clamped
    for ln in plan:
        if ln.win <= 0:
            assert ln.parent == -1
        else:
            c, pc = wins[ln.win], wins[ln.win - 1]
            both = c.window_min is not None and pc.window_min is not None
            exact = cfgx is not None and ln.win == len(wins) - 1
            assert ln.parent == (-1 if both and not exact else ln.win - 1)


def test_the_plan_refuses_a_static_level_that_does_not_nest():
    bad = PM2Config((20.0, 0.0, 0.0), 8.0, 0.2)
    pos, live, _ = scene(2048)
    with pytest.raises(ValueError, match="does not nest") as plain_err:
        pm2._nested_wmins(pos, live, None, (S32, bad), None)
    with pytest.raises(ValueError, match="does not nest") as plan_err:
        plan_of((S32, bad), None)
    assert str(plan_err.value) == str(plain_err.value)


# -- on the CPU: the plumbing ------------------------------------------------------
def test_fine_accel_fast_takes_the_passes_mask():
    """A level's field from the pass's origin and mask is the one from the
    plain origin and a mask built from it; both are required."""
    pos, live, masses = scene()
    win = pm2.window_pass(pos, live, (T32, T8), masses=masses)
    wmins = pm2._nested_wmins(pos, live, None, (T32, T8), masses)
    for k, c2 in enumerate((T32, T8)):
        kw = dict(masses=masses, eps_outer=3.0)
        own = pm2.fine_accel_fast(
            pos, live, pos.shape[1], CFG, c2, wmin=wmins[k],
            inner=pm2._in_window(pos, wmins[k], c2.window_size, c2.margin)
            & live, **kw)
        given = pm2.fine_accel_fast(pos, live, pos.shape[1], CFG, c2,
                                    wmin=win.origins[k], inner=win.masks[k],
                                    **kw)
        assert torch.equal(own, given)
        assert bool((own != 0).any())
    with pytest.raises(TypeError, match="inner"):
        pm2.fine_accel_fast(pos, live, pos.shape[1], CFG, T32,
                            wmin=win.origins[0])


@pytest.mark.parametrize("with_masses", [False, True])
def test_pmn_accel_raw_hands_back_the_exact_window(with_masses):
    """pmn_accel_raw hands back its pass's windows: on CPU tensors the
    plain origins and masks and no exact window (pmx takes that from
    window_origin, so pmx_accel_raw is the levels' field plus
    exact_accel at window_origin); the field is the same with ``exact``."""
    pos, live, masses = scene()
    masses = masses if with_masses else None
    n = pos.shape[1]
    kw = dict(masses=masses, live=live)
    alone, w0 = pm2.pmn_accel_raw(pos, n, CFG, (T32, T8), **kw)
    acc, win = pm2.pmn_accel_raw(pos, n, CFG, (T32, T8),
                                 exact=pm2.Win.of(X2), **kw)
    assert torch.equal(acc, alone)
    assert win.x_origin is None and win.x_member is None
    assert win.x_count is None and w0.x_origin is None
    want = pm2._nested_wmins(pos, live, None, (T32, T8), masses)
    for o, m, w, c in zip(win.origins, win.masks, want, (T32, T8)):
        assert torch.equal(o, w)
        assert torch.equal(m, pm2._in_window(pos, w, c.window_size,
                                             c.margin) & live)
    wx = pmx.window_origin(pos, live, X2, (T32, T8), masses=masses)
    corr, n_c = pmx.exact_accel(pos, live, X2, pmx._eps_prev(CFG, (T32, T8)),
                                masses=masses, wmin=wx)
    got, n_g = pmx.pmx_accel_raw(pos, n, CFG, (T32, T8), X2, **kw)
    assert torch.equal(got, acc + corr)
    assert int(n_g) == int(n_c) > 0


@pytest.mark.parametrize("levels", [(), (T32, T8)])
def test_exact_accel_takes_the_passes_window(levels):
    """exact_accel takes a pass's exact members and count as they are, and
    without them (a CPU pass has none) the members at window_origin."""
    pos, live, masses = scene()
    eps = pmx._eps_prev(CFG, levels)
    wx = pmx.window_origin(pos, live, X2, levels, masses=masses)
    member = pmx._member_mask(pos, wx, X2, live)
    passed = pm2.Windows((), (), wx, member, member.sum(dtype=torch.int32))
    a, n_a = pmx.exact_accel(pos, live, X2, eps, masses=masses,
                             levels=levels)
    b, n_b = pmx.exact_accel(pos, live, X2, eps, masses=masses,
                             levels=levels, window=passed)
    c, n_c = pmx.exact_accel(pos, live, X2, eps, masses=masses, wmin=wx)
    d, n_d = pmx.exact_accel(pos, live, X2, eps, masses=masses,
                             levels=levels, window=pm2.window_pass(
                                 pos, live, levels, masses=masses,
                                 exact=pm2.Win.of(X2)))
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert int(n_a) == int(n_b) == int(n_c) == int(n_d) > 0


def test_state_keys_are_the_plain_class_keys():
    pos, live, masses = scene()
    n = pos.shape[1]
    levels = (T32, T8)
    st = pm_persist.init_sorted_multi(pos, n - 300, CFG, levels,
                                      masses=masses)
    live = st.ids < n - 300
    want = pm_persist.class_keys(st.pos, live, CFG, levels,
                                 pm2._nested_wmins(st.pos, live, None, levels,
                                                   st.masses))
    for kernels in (True, False):
        got = pm_persist.state_keys(st, n - 300, CFG, levels,
                                    use_kernels=kernels)
        assert torch.equal(got, want)


def test_a_pass_is_counted_once():
    """``pm2.windows.fused`` counts the kernel's passes only (on the card,
    test_card_engine_counts_a_pass_a_step_and_a_verdict): the plain pass
    on CPU tensors counts none, alone or inside pmx_accel_raw."""
    pos, live, masses = scene()
    n = pos.shape[1]
    trace.reset()
    trace.enable()
    try:
        pm2.window_pass(pos, live, (T32, T8), masses=masses,
                        exact=pm2.Win.of(X2))
        pmx.pmx_accel_raw(pos, n, CFG, (T32, T8), X2, masses=masses,
                          live=live)
        pmx.pmx_accel_raw(pos, n, CFG, (), X2, masses=masses, live=live)
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert "pm2.windows.fused" not in counts


def test_the_entry_is_bound_with_its_arguments():
    body = (CSRC / "windows.cu").read_text().split(
        "PSIM_EXPORT int psim_window_pass(")[1]
    params = body.split(")")[0]
    assert len(cuda_build.SIGNATURES["psim_window_pass"]) == len(
        params.split(","))
    assert re.findall(r"(\w+)<<<", body.split("PSIM_EXPORT")[0]) == [
        "window_pass_kernel"]


# -- on the card ------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 "
                    "(PSIM_TEST_REAL_DEVICES=1 pytest -m chip)")
    return torch.device("cuda")


def exact_scene(card) -> tuple:
    """The deep-zoom exact cell's scene at 500,000 (benchmark/state.py)."""
    from benchmark import spec, state

    init = state.initial(spec.config("deep_zoom_exact_500k"), 2 ** 33 + 7,
                         card)
    n = init.pos.shape[1]
    live = torch.arange(n, device=card) < init.n
    return init.pos, live, None


def hollow(card, n: int = 1 << 22) -> tuple:
    """A hollow sphere of radius 10 off the origin at 4M, with masses: the
    8-unit window cuts its shell."""
    g = torch.Generator(card).manual_seed(11)
    d = torch.randn((3, n), device=card, generator=g)
    r = 10.0 * (0.9 + 0.1 * torch.rand(n, device=card, generator=g))
    pos = d / d.norm(dim=0, keepdim=True) * r
    pos += torch.tensor([3.0, -2.0, 1.0], device=card)[:, None]
    masses = 0.5 + torch.rand(n, device=card, generator=g)
    live = torch.arange(n, device=card) < n - 4096
    return pos.contiguous(), live, masses


def assert_the_kernel(pos, live, levels, masses, cfgx):
    exact = None if cfgx is None else pm2.Win.of(cfgx)
    win = pm2.window_pass(pos, live, levels, masses=masses, exact=exact)
    again = pm2.window_pass(pos, live, levels, masses=masses, exact=exact)
    torch.cuda.synchronize()
    got_o = list(win.origins) + ([] if cfgx is None else [win.x_origin])
    got_m = list(win.masks) + ([] if cfgx is None else [win.x_member])
    got_a = list(again.origins) + ([] if cfgx is None else [again.x_origin])
    for a, b in zip(got_o, got_a):
        assert torch.equal(a, b)
    for a, b in zip(got_m, list(again.masks) + (
            [] if cfgx is None else [again.x_member])):
        assert torch.equal(a, b)
    wins = windows_of(levels, cfgx)
    # each mask is _in_window at the kernel's origin, bit for bit; each
    # origin the float32 centroid of float64 sums over the kernel's own
    # parent members within 4 ulps
    parent = live
    for k, c in enumerate(wins):
        assert torch.equal(got_m[k], pm2._in_window(
            pos, got_o[k], c.window_size, c.margin) & live)
        if c.window_min is None:
            w = parent.double() if masses is None else (parent.double()
                                                        * masses.double())
            s = torch.cat([(pos.double() * w[None]).sum(dim=1),
                           w.sum().reshape(1)]).float()
            want = s[:3] / torch.clamp_min(s[3], 1e-12) - 0.5 * pm2._f32(
                c.window_size)
            if k > 0:
                want = pm2.clamp_nested(want, got_o[k - 1], wins[k - 1],
                                        c.window_size)
            gap = (got_o[k].double() - want.double()).abs()
            bar = 4 * ulp(want.abs() + c.window_size)
            assert bool((gap <= bar).all()), (k, gap, bar)
        parent = got_m[k]
    if cfgx is not None:
        assert int(win.x_count) == int(win.x_member.sum())
    assert_like_plain(pos, live, levels, masses, cfgx, got_o, got_m)
    return win


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("where", ["exact_scene", "hollow_4m"])
def test_card_pass_is_the_plain_bookkeeping(card, where, case):
    levels, cfgx, with_masses = CASES[case]
    if where == "exact_scene":
        pos, live, _ = exact_scene(card)
        masses = (0.5 + torch.rand(pos.shape[1], device=card)
                  if with_masses else None)
    else:
        pos, live, masses = hollow(card)
        masses = masses if with_masses else None
    before = pm2.WINDOW_LAUNCHES
    assert_the_kernel(pos, live, levels, masses, cfgx)
    assert pm2.WINDOW_LAUNCHES - before == 2 * len(plan_of(levels, cfgx))


@pytest.mark.chip
def test_card_clamp_binds_on_the_capacity_scene(card):
    pos, live, _ = off_centre()
    pos, live = pos.to(card), live.to(card)
    win = assert_the_kernel(pos, live, (T32, T8), None, X2)
    free = pm2.window_min(pos, None, X2, None, live=win.masks[1])
    assert float((free - win.x_origin).abs().max()) > 0.1


@pytest.mark.chip
def test_card_pmn_accel_raw_hands_back_the_exact_window(card):
    """On the card pmn_accel_raw's pass finds the exact window too: the
    same bits as the pass alone, and pmx_accel_raw's member count is its
    count; window_origin is not called."""
    pos, live, _ = exact_scene(card)
    n = pos.shape[1]
    calls = []
    origin = pmx.window_origin
    pmx.window_origin = lambda *a, **k: calls.append(1) or origin(*a, **k)
    try:
        _, win = pm2.pmn_accel_raw(pos, n, CFG, (T32, T8), live=live,
                                   exact=pm2.Win.of(X2))
        _, n_m = pmx.pmx_accel_raw(pos, n, CFG, (T32, T8), X2, live=live)
    finally:
        pmx.window_origin = origin
    alone = assert_the_kernel(pos, live, (T32, T8), None, X2)
    for a, b in zip((*win.origins, *win.masks, win.x_origin, win.x_member,
                     win.x_count),
                    (*alone.origins, *alone.masks, alone.x_origin,
                     alone.x_member, alone.x_count)):
        assert torch.equal(a, b)
    assert int(n_m) == int(win.x_count) > 0
    assert not calls


@pytest.mark.chip
@pytest.mark.parametrize("exact", [False, True])
def test_card_engine_counts_a_pass_a_step_and_a_verdict(card, exact):
    """The persistent deep-zoom stack on the card: one pass a step (the
    levels' and, with the exact window, its own in the same pass) and one
    a verdict; window_origin is not called."""
    kw = dict(particle_count=1 << 20, device=card, pm=PMConfig(),
              pm2=(T32, T8), pm_persist=True)
    if exact:
        kw["pmx"] = PMXConfig(2.0, 0.05, capacity=65536)
    e = Engine(**kw)
    params = SimParams(delta_time=0.004)
    e.step(params)
    calls = []
    origin = pmx.window_origin
    pmx.window_origin = lambda *a, **k: calls.append(1) or origin(*a, **k)
    trace.reset()
    trace.enable()
    steps = pm_persist.CHECK_EVERY + 1
    try:
        for _ in range(steps):
            e.step(params)
        torch.cuda.synchronize()
        counts = trace.counters()
        names = [r.name for r in trace.records()]
    finally:
        pmx.window_origin = origin
        trace.disable()
        trace.reset()
    verdicts = names.count("persist.verdict")
    repairs = names.count("persist.repair")   # a repair sorts by the keys
    assert verdicts >= 1
    assert counts.get("pm2.windows.fused") == steps + verdicts + repairs, \
        counts
    assert not calls
    assert e.method == Method.CUDA
