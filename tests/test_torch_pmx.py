"""The port's window-exact correction (ops/pmx.py, Engine(pmx=...)) and the
pm2/pmx wiring (checkpoints both ways, the CLI, the server's "pm" event)
against the JAX package's on the CPU: the same inputs, made with numpy
from a seed, through both. ``exact_accel`` runs its compaction, pairwise
passes and scatter on the wrappers' plain versions here (CPU tensors);
the JAX fast path runs in interpret mode, as tests/test_pmx.py runs it."""

import dataclasses
import functools
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_sim_tpu.app import cli as jcli
from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import checkpoint as jckpt
from particle_sim_tpu.ops import pm2 as jpm2
from particle_sim_tpu.ops import pmx as jpmx

from particle_sim_tpu_torch.app import cli, server
from particle_sim_tpu_torch.core.params import (
    Method, PairwiseParams, PMConfig, SimParams, SphereGeneration,
)
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.io import checkpoint as ckpt
from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda, pm2, pmx, psort

torch.set_num_threads(1)

CFG = PMConfig(grid=32, softening=3.0)
CORE = np.array([6.0, -2.0, 3.0], np.float32)
EPS_X = 0.15
CFGX = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=2048)
L1 = pm2.PM2Config(window_min=None, window_size=24.0, softening=0.8)


def jax_cfg(cfg):
    cls = {PMConfig: JPM, pm2.PM2Config: jpm2.PM2Config,
           pmx.PMXConfig: jpmx.PMXConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def scene(seed=0, n_core=1200, n_halo=1600):
    """tests/test_pmx.py's scene: a core (r 1.5) at CORE and a halo (r 40),
    padded to a multiple of 512. -> (pos f32[3, cap], n)."""
    rng = np.random.default_rng(seed)

    def cloud(n, radius, offset=(0, 0, 0)):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        r = radius * rng.random(n).astype(np.float32) ** (1 / 3)
        return (x * r[:, None] + np.asarray(offset, np.float32)).astype(
            np.float32)

    pos = np.concatenate([cloud(n_core, 1.5, CORE), cloud(n_halo, 40.0)])
    n = pos.shape[0]
    cap = -(-n // 512) * 512
    pos = np.concatenate([pos, np.zeros((cap - n, 3), np.float32)])
    return np.ascontiguousarray(pos.T), n


def live_of(pos, n):
    live = np.arange(pos.shape[1]) < n
    return jnp.asarray(live), torch.from_numpy(live)


def scale_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the configuration ----------------------------------------------------------------
def test_pmxconfig_matches_jax():
    assert [f.name for f in dataclasses.fields(pmx.PMXConfig)] == [
        f.name for f in dataclasses.fields(jpmx.PMXConfig)]
    assert dataclasses.asdict(CFGX) == dataclasses.asdict(jax_cfg(CFGX))
    assert [f.name for f in dataclasses.fields(pm2.PM2Config)] == [
        f.name for f in dataclasses.fields(jpm2.PM2Config)]
    for kw in (dict(window_size=8.0, softening=0.0),
               dict(window_size=8.0, softening=0.1, capacity=1000)):
        with pytest.raises(ValueError) as want:
            jpmx.PMXConfig(**kw)
        with pytest.raises(ValueError) as got:
            pmx.PMXConfig(**kw)
        assert str(got.value) == str(want.value)


# -- the correction ------------------------------------------------------------------
@pytest.mark.parametrize("with_masses", [False, True])
def test_exact_accel_matches_jax(with_masses):
    """exact_accel (the compaction, two passes and the scatter) and
    exact_accel_ref against JAX's exact_accel_ref and exact_accel
    (interpret): 2e-5 of the scale (test_pmx.py:92-93); the member count
    exactly."""
    pos, n = scene(1)
    jl, tl = live_of(pos, n)
    m = None
    if with_masses:
        m = (np.random.default_rng(5).random(pos.shape[1]) + 0.5).astype(
            np.float32)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    jcx = jax_cfg(CFGX)
    wmin = jpm2.window_min(jnp.asarray(pos), None, jcx, jm, live=jl)
    ref = np.asarray(jpmx.exact_accel_ref(jnp.asarray(pos), jl, jcx,
                                          CFG.softening, masses=jm,
                                          wmin=wmin))
    fast, jn = jpmx.exact_accel(jnp.asarray(pos), jl, jcx, CFG.softening,
                                masses=jm, wmin=wmin, interpret=True)
    tw = torch.from_numpy(np.array(wmin))
    tp = torch.from_numpy(pos)
    got, tn = pmx.exact_accel(tp, tl, CFGX, CFG.softening, masses=tm,
                              wmin=tw)
    plain, pn = pmx.exact_accel(tp, tl, CFGX, CFG.softening, masses=tm,
                                wmin=tw, use_kernels=False)
    oracle = pmx.exact_accel_ref(tp, tl, CFGX, CFG.softening, masses=tm,
                                 wmin=tw).numpy()
    assert tn.dtype == torch.int32 and int(tn) == int(jn) == int(pn)
    assert 0 < int(tn) <= CFGX.capacity
    for a in (got.numpy(), plain.numpy(), oracle):
        assert scale_err(a, ref) <= 2e-5
        assert scale_err(a, np.asarray(fast)) <= 2e-5
    assert torch.equal(got, plain)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_exact_accel_is_one_difference_pass(monkeypatch, use_kernels):
    """The correction takes one difference pass (the kernel's wrapper, or
    its plain version), never the kernel's single pass, with the
    in-budget member count min(n_members, capacity) as both live counts,
    an int32 on the receivers' device; the result stays JAX's exact_accel
    (interpret) at 2e-5 of the scale."""
    mod = pairwise_cuda if use_kernels else pairwise
    calls = []
    real = mod.pairwise_accel_diff

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    def single(*args, **kw):
        raise AssertionError("exact_accel ran a single pass")

    monkeypatch.setattr(mod, "pairwise_accel_diff", spy)
    monkeypatch.setattr(pairwise_cuda, "pairwise_accel", single)
    pos, n = scene(4)
    jl, tl = live_of(pos, n)
    small = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=512)
    tp = torch.from_numpy(pos)
    wmin = pm2.window_min(tp, None, small, None, live=tl)
    got, n_m = pmx.exact_accel(tp, tl, small, CFG.softening, wmin=wmin,
                               use_kernels=use_kernels)
    assert len(calls) == 1
    for key in ("n_i", "n_j"):
        c = calls[0][key]
        assert c.dtype == torch.int32 and c.device == tp.device
        assert int(c) == min(int(n_m), 512) == 512 < int(n_m)
    monkeypatch.undo()
    fast, _ = jpmx.exact_accel(jnp.asarray(pos), jl, jax_cfg(small),
                               CFG.softening, wmin=jnp.asarray(wmin.numpy()),
                               interpret=True)
    assert scale_err(got.numpy(), np.asarray(fast)) <= 2e-5


def test_members_first_is_the_stable_flag_sort():
    """The compaction order: members first, each group in slot order, with
    the radix sort's one digit (on CPU tensors psort.sort runs
    radix_sort_ref) and no torch.sort route."""
    member = torch.from_numpy(np.random.default_rng(2).random(5000) < 0.3)
    calls = psort.LIBRARY_CALLS
    idx = pmx.members_first(member)
    assert psort.LIBRARY_CALLS == calls
    assert psort.radix_plan_ref((~member).to(torch.int32)) == (0,)
    want = np.concatenate([np.flatnonzero(member.numpy()),
                           np.flatnonzero(~member.numpy())])
    np.testing.assert_array_equal(idx.numpy(), want)
    assert torch.equal(pmx.members_first(member, use_kernels=False), idx)


def test_capacity_truncation_is_loud_not_wrong():
    """test_pmx.py:96-116: past the capacity the first ``capacity``
    members by slot order keep the correction, the rest get exactly 0,
    and the count says so; the count is JAX's."""
    pos, n = scene(2)
    jl, tl = live_of(pos, n)
    small = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=512)
    tp = torch.from_numpy(pos)
    wmin = pm2.window_min(tp, None, small, None, live=tl)
    corr, n_m = pmx.exact_accel(tp, tl, small, CFG.softening, wmin=wmin)
    _, jn = jpmx.exact_accel(jnp.asarray(pos), jl, jax_cfg(small),
                             CFG.softening, wmin=jnp.asarray(wmin.numpy()),
                             interpret=True)
    assert int(n_m) == int(jn) > 512
    corr = corr.numpy()
    assert np.isfinite(corr).all()
    member = pmx._member_mask(tp, wmin, small, tl).numpy()
    slots = np.flatnonzero(member)
    assert np.abs(corr[:, slots[512:]]).max() == 0.0
    assert np.abs(corr[:, slots[:512]]).max() > 0.0
    assert np.abs(corr[:, ~member]).max() == 0.0


def test_momentum_antisymmetric():
    pos, n = scene(3)
    _, tl = live_of(pos, n)
    corr, _ = pmx.exact_accel(torch.from_numpy(pos), tl, CFGX,
                              CFG.softening)
    c = corr.numpy()[:, :n]
    typical = np.abs(c).max() + 1e-12
    assert np.abs(c.sum(axis=1)).max() < 1e-3 * typical * n ** 0.5


@pytest.mark.parametrize("levels", [(), (L1,)], ids=["mesh", "pm2_stack"])
def test_pmx_accel_matches_jax(levels):
    """The whole stack against JAX's pmx_accel (use_fast=False: the plain
    mesh and the interpret-mode correction): a static window over the
    coarse mesh at 1e-4 of the scale (the plain PM's bar); a tracked one
    inside a pm2 level at the fast-path bar, 0.02 (test_pmx.py:131-152
    composes them). The member counts agree, and both port paths agree."""
    pos, n = scene(4)
    cfgx = CFGX if levels else dataclasses.replace(
        CFGX, window_min=tuple(float(v) for v in CORE - 4.0))
    want, jn = jpmx.pmx_accel(jnp.asarray(pos), jnp.int32(n), 1.0,
                              jax_cfg(CFG), tuple(jax_cfg(c) for c in levels),
                              jax_cfg(cfgx), use_fast=False)
    tp = torch.from_numpy(pos)
    got, tn = pmx.pmx_accel(tp, n, 1.0, CFG, levels, cfgx, use_fast=False)
    fast, fn_ = pmx.pmx_accel(tp, n, 1.0, CFG, levels, cfgx)
    want = np.asarray(want)
    assert int(tn) == int(fn_) == int(jn) > 100
    assert scale_err(got.numpy(), want) <= (0.02 if levels else 1e-4)
    assert scale_err(fast.numpy(), got.numpy()) <= 1e-4
    assert (got[:, n:] == 0).all()


def test_validation_matches_jax():
    """test_pmx.py:155-168: the same ValueErrors, word for word."""
    pos, n = scene(5)
    for levels, cfgx in (
            ((), pmx.PMXConfig(window_size=8.0, softening=5.0)),
            ((pm2.PM2Config(None, 16.0, softening=0.8),),
             pmx.PMXConfig(window_size=24.0, softening=0.1)),
            ((pm2.PM2Config(None, 16.0, softening=0.8, margin=5.0),),
             pmx.PMXConfig(window_size=8.0, softening=0.1))):
        with pytest.raises(ValueError) as want:
            jpmx.pmx_accel(jnp.asarray(pos), jnp.int32(n), 1.0, jax_cfg(CFG),
                           tuple(jax_cfg(c) for c in levels), jax_cfg(cfgx),
                           use_fast=False)
        with pytest.raises(ValueError) as got:
            pmx.pmx_accel(torch.from_numpy(pos), n, 1.0, CFG, levels, cfgx)
        assert str(got.value) == str(want.value)


# -- the engine ------------------------------------------------------------------
def make_engine(n=1500, **kw):
    return Engine(particle_count=n, device="cpu", method=Method.TORCH, **kw)


def test_set_pm2_and_set_pmx_validate_at_call_site():
    """test_pmx.py:198-223: a swap incompatible with the installed window
    raises in set_pm2 / set_pmx and keeps the old configuration."""
    e = make_engine(pm=CFG, pmx=CFGX)
    assert e.pm_persist is False and e.persist_resolved() is False
    with pytest.raises(ValueError, match="softening"):
        e.set_pm2(pm2.PM2Config(window_min=None, window_size=24.0,
                                softening=5.0))
    with pytest.raises(ValueError, match="nest"):
        e.set_pm2(pm2.PM2Config(window_min=None, window_size=6.0,
                                softening=0.8))
    assert e.pm2 is None
    e.set_pm2(L1)
    assert e.pm2 == L1
    with pytest.raises(ValueError, match="innermost"):
        e.set_pmx(pmx.PMXConfig(window_size=8.0, softening=1.0))
    assert e.pmx == CFGX
    e.set_pmx(None)
    assert e.pmx is None and e.pmx_member_count() is None
    with pytest.raises(ValueError, match="pm="):
        make_engine(1024, pmx=CFGX)
    with pytest.raises(ValueError, match="MULTI-level"):
        make_engine(1024, pm=CFG, pmx=CFGX, pm_persist=True)


def seeded(pos_np, **kw):
    e = make_engine(pos_np.shape[0], **kw)
    e.state = ParticleState.from_arrays(pos_np, np.zeros_like(pos_np),
                                        np.full_like(pos_np, 0.5),
                                        device="cpu", capacity=e.capacity)
    return e


def test_truncation_overflow_is_warned(caplog):
    """test_pmx.py:238-271: the engine polls the counts, warns once per
    overflow episode, and pmx_member_count() reads them."""
    pos, n = scene(2)
    pos_np = np.ascontiguousarray(pos[:, :n].T)
    small = pmx.PMXConfig(window_size=8.0, softening=EPS_X, capacity=512,
                          window_min=tuple(float(v) for v in CORE - 4.0))
    e = seeded(pos_np, pm=CFG, pmx=small)
    pv = SimParams(delta_time=0.004, gravity=0.0)
    with caplog.at_level(logging.WARNING, logger="particle_sim_tpu_torch"):
        e.step(pv)
    n_mem, n_corr = e.pmx_member_count()
    assert n_mem > 512 >= n_corr
    assert sum("pmx window overflow" in r.message
               for r in caplog.records) == 1
    caplog.clear()
    e._pmx_check_at = 0
    with caplog.at_level(logging.WARNING, logger="particle_sim_tpu_torch"):
        e.step(pv)
    assert not any("pmx window overflow" in r.message
                   for r in caplog.records)
    # a new window starts a new episode
    e.set_pmx(dataclasses.replace(small, capacity=1024))
    assert e.pmx_member_count() is None and not e._pmx_overflowing
    e.step(pv)
    n_mem2, n_corr2 = e.pmx_member_count()
    assert n_corr2 == min(n_mem2, 1024)


@pytest.mark.parametrize("stack", [None, (L1,)], ids=["mesh", "pm2_stack"])
def test_engine_pmx_matches_jax(stack):
    """Engine(pm, pm2, pmx) against the JAX engine (plain paths, 3 frames
    from tests/test_pmx.py's scene): positions within 0.02 of the
    velocity change times the elapsed time, velocities within 0.02 of
    the velocity change (the fast-path bar on the accelerations); the
    member counts equal."""
    pos, n = scene(6)
    pos_np = np.ascontiguousarray(pos[:, :n].T)
    kw = dict(pairwise=(1.5, CFG.softening))
    je = JEngine(particle_count=n, method=JMethod.JNP,
                 pairwise=JPairwise(*kw["pairwise"]), pm=jax_cfg(CFG),
                 pm2=None if stack is None else jax_cfg(stack[0]),
                 pmx=jax_cfg(CFGX))
    from particle_sim_tpu.core.state import ParticleState as JState
    je.state = JState.from_arrays(pos_np, np.zeros_like(pos_np),
                                  np.full_like(pos_np, 0.5),
                                  capacity=je.capacity)
    te = seeded(pos_np, pairwise=PairwiseParams(*kw["pairwise"]), pm=CFG,
                pm2=None if stack is None else stack[0], pmx=CFGX)
    for _ in range(3):
        je.step(JSimParams(delta_time=0.01, gravity=0.0))
        te.step(SimParams(delta_time=0.01, gravity=0.0))
    assert te.pmx_member_count() == je.pmx_member_count()
    jv = je.state.velocities()
    dv = np.abs(jv).max()
    assert np.abs(te.state.velocities() - jv).max() <= 0.02 * dv
    assert np.abs(te.state.positions() - je.state.positions()).max() \
        <= 0.02 * dv * 0.03


# -- checkpoints both ways ----------------------------------------------------------------
STACK = (pm2.PM2Config(window_min=(-16.0, -16.0, -16.0), window_size=32.0,
                       softening=0.75),
         pm2.PM2Config(window_min=None, window_size=8.0, softening=0.25,
                       margin=0.5))
WINDOW = pmx.PMXConfig(window_size=4.0, softening=0.1, capacity=1024,
                       window_min=(-2.0, -2.0, -2.0))


def test_checkpoint_pm2_pmx_jax_to_port(tmp_path):
    path = str(tmp_path / "j.npz")
    je = JEngine(particle_count=900, method=JMethod.JNP,
                 generation_mode=SphereGeneration.FILLED,
                 pm=jax_cfg(CFG), pm2=tuple(jax_cfg(c) for c in STACK),
                 pmx=jax_cfg(WINDOW))
    je.step(JSimParams(delta_time=0.01))
    jckpt.save(path, je, step_index=4)
    te, idx = ckpt.load(path, device="cpu")
    assert idx == 4 and te.pm == CFG
    assert te.pm2 == STACK and te.pmx == WINDOW
    assert te.pm_persist is False
    np.testing.assert_array_equal(te.state.positions(), je.state.positions())
    je.step(JSimParams(delta_time=0.01))
    te.step(SimParams(delta_time=0.01))
    np.testing.assert_allclose(te.state.positions(), je.state.positions(),
                               atol=1e-4)


def test_checkpoint_pm2_pmx_port_to_jax(tmp_path):
    path_t, path_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    te = make_engine(900, generation_mode=SphereGeneration.FILLED, pm=CFG,
                     pm2=STACK[0], pmx=WINDOW)
    te.step(SimParams(delta_time=0.01))
    ckpt.save(path_t, te, step_index=2)
    je, idx = jckpt.load(path_t)
    assert idx == 2 and je.pm2 == jax_cfg(STACK[0])
    assert je.pmx == jax_cfg(WINDOW)
    jckpt.save(path_j, je, step_index=2)
    meta = [json.loads(str(np.load(p)["meta"])) for p in (path_t, path_j)]
    assert meta[0] == meta[1] and isinstance(meta[0]["pm2"], dict)
    te2, _ = ckpt.load(path_j, device="cpu")
    assert te2.pm2 == STACK[0] and te2.pmx == WINDOW
    assert isinstance(te2.pm2.window_min, tuple)


# -- the CLI ----------------------------------------------------------------------
def test_cli_pm2_pmx_run(tmp_path, capsys):
    """--pm2-size (two levels) and --pmx-size imply --pm and run to the
    done line; the stack and the window reach the checkpoint."""
    path = str(tmp_path / "c.npz")
    rc = cli.main(["--device", "cpu", "--count", "1500", "--steps", "2",
                   "--pm-grid", "32", "--pm-softening", "3.0",
                   "--pm2-size", "32", "8", "--pm2-softening", "0.75",
                   "0.25", "--pmx-size", "4", "--pmx-softening", "0.1",
                   "--pmx-capacity", "1024", "--stats-every", "0",
                   "--checkpoint-every", "2", "--checkpoint", path])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["done"] is True and final["steps"] == 2
    e, _ = ckpt.load(path, device="cpu")
    assert e.pm == PMConfig(grid=32, softening=3.0)
    assert [c.window_size for c in e.pm2] == [32.0, 8.0]
    assert e.pmx == pmx.PMXConfig(window_size=4.0, softening=0.1,
                                  capacity=1024)


def test_cli_pmx_like_jax(capsys):
    """tests/test_pmx.py:418's run (--pmx-size implies --pm) on both CLIs,
    at G = 32, to the done line; mismatched softening counts exit."""
    argv = ["--count", "600", "--steps", "2", "--pm-grid", "32",
            "--pmx-size", "8", "--pmx-softening", "0.2", "--pmx-capacity",
            "1024", "--stats-every", "0"]
    assert jcli.main(argv + ["--method", "jnp"]) == 0
    assert cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["done"] is True
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--count", "512", "--steps", "1",
                  "--pm2-size", "32", "8", "--pm2-softening", "0.5"])


# -- the server -------------------------------------------------------------------
def test_server_pm2_pmx_event_over_the_wire(monkeypatch):
    """A "pm" event with pm2_sizes and pmx_size over loopback installs the
    stack and the window; a later frame reflects its seq and a new
    client's hello reports them; a "direct" event clears both."""
    from test_torch_server import WsClient, header, wait_for_frame

    monkeypatch.setattr(server, "PMConfig",
                        functools.partial(PMConfig, grid=32))
    eng = make_engine(2048, generation_mode=SphereGeneration.FILLED)
    srv = server.StreamServer(eng, port=0, target_fps=30)
    srv.start()
    try:
        c = WsClient(srv.port)
        hello = c.text()
        assert hello["pm2_sizes"] == [] and hello["pmx_size"] == 0
        c.binary()
        # g, the softening (2.0), pmx_softening (0.1) and pmx_capacity
        # (65536) at their defaults: the client sends short frames only
        c.send({"type": "solver", "name": "pm", "pm2_sizes": [32, 16],
                "pm2_softenings": [0.75, 0.25], "pmx_size": 16, "seq": 3})
        frame = wait_for_frame(c, lambda f: header(f)[7] >= 3)
        assert header(frame)[7] == 3
        c.close()
        c2 = WsClient(srv.port)
        hello = c2.text()
        c2.close()
        with srv.lock:
            counts = eng.pmx_member_count()
    finally:
        srv.stop()
    assert hello["solver"] == "pm"
    assert hello["pm2_sizes"] == [32.0, 16.0]
    assert hello["pm2_softenings"] == [0.75, 0.25]
    assert hello["pmx_size"] == 16.0 and hello["pmx_softening"] == 0.1
    assert eng.pm2 == (pm2.PM2Config(None, 32.0, 0.75),
                       pm2.PM2Config(None, 16.0, 0.25))
    assert eng.pm == PMConfig(grid=32, softening=2.0)
    assert eng.pmx == pmx.PMXConfig(16.0, 0.1)
    assert counts is not None and counts[0] > 0
    assert np.isfinite(eng.state.positions()).all()
    srv.handle_event({"type": "solver", "name": "direct", "g": 1.0,
                      "softening": 0.5})
    assert eng.pm is None and eng.pm2 is None and eng.pmx is None
