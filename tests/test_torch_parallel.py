"""The port's mesh path (particle_sim_tpu_torch/parallel/) against the
JAX package's shard_map functions, on the CPU.

The port runs SPMD: a gloo group of 2 or 4 CPU processes, one a rank,
each stepping its shard (tests/torch_mesh_workers.py, started once a
world size by a module fixture). The JAX side runs the same functions of
``particle_sim_tpu/parallel/`` on ``make_mesh(jax.devices()[:k])`` of the
8 virtual CPU devices (tests/conftest.py), its Pallas paths in interpret
mode, on the same inputs (numpy, from a seed). The legs are those of
``MULTICHIP_r05.json``: the dp step and the global mean speed; the ring,
plain and on the kernel path, with and without masses; pm_dp, plain, on
the kernel path (with masses) and with the auto box; the persistent PM
with one level, two levels, the multi-level order and the window-exact
correction (compared by ``ids``); render_dp.

Bars, from the JAX tests: the dp step 1e-5 (tests/test_parallel_dp.py);
the ring 1e-4 (tests/test_engine_mesh.py); pm_dp's kick within 1e-4 of
its largest against the JAX plain path and 0.02 against the Pallas path
(tests/test_torch_pm.py's bars, the TPU kernels' bf16 one-hots); the
persistent PM at tests/test_pm_persist_dp.py's bars (positions 1e-2,
velocities 0.02 of max|v|) and its kick within 0.02 of its largest
(tests/test_torch_pm_persist.py's JAX_BAR); the frame 1e-5
(tests/test_torch_raster_deposit.py's compact bar). The kernel path of
the port runs its wrappers' plain versions here (CPU tensors); the
kernels themselves are held to those on the card by chip_smoke.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from particle_sim_tpu.core.params import PMConfig as JPM
from particle_sim_tpu.ops import pm2 as jpm2
from particle_sim_tpu.ops import pmx as jpmx
from particle_sim_tpu.parallel import dp as jdp
from particle_sim_tpu.parallel import mesh as jml
from particle_sim_tpu.parallel import pm_dp as jpm_dp
from particle_sim_tpu.parallel import pm_persist_dp as jpdp
from particle_sim_tpu.parallel import render_dp as jrender_dp
from particle_sim_tpu.parallel import ring as jring

from particle_sim_tpu_torch.core.params import PMConfig, SimParams
from particle_sim_tpu_torch.ops import pm2, pmx
from particle_sim_tpu_torch.parallel import distributed, mesh
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

WORLDS = (2, 4)
DAMPING = SimParams().damping


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: every rank's results of every leg}: one group a size."""
    d = str(tmp_path_factory.mktemp("mesh"))
    return {k: W.run_group(k, "legs", d) for k in WORLDS}


def jax_cfg(cfg):
    cls = {PMConfig: JPM, pm2.PM2Config: jpm2.PM2Config,
           pmx.PMXConfig: jpmx.PMXConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def jax_setup(k):
    g = W.inputs(k)
    cf = {name: (tuple(jax_cfg(c) for c in v) if isinstance(v, tuple)
                 else jax_cfg(v)) for name, v in W.configs(k).items()}
    return jml.make_mesh(jax.devices()[:k]), g, cf


def jplanes(a):
    return jnp.asarray(a.reshape(3, -1, 128))


def flat(a):
    return np.asarray(a).reshape(3, -1)


def port_pair(results, key):
    return W.shards(results, key + "_pos"), W.shards(results, key + "_vel")


def by_ids(a, ids):
    """(..., N) in slot order -> identity order."""
    out = np.zeros_like(a)
    out[..., np.asarray(ids)] = a
    return out


def kick(vel, vel0):
    """The velocity the solver added: v1 - damping v0 (no attractor, no
    uniform gravity in the PM legs)."""
    return vel - DAMPING * vel0


# -- dp --------------------------------------------------------------------------------
@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("leg", ["dp", "dp_k"])
def test_dp_step_matches_jax(port, k, leg):
    jmesh, g, _ = jax_setup(k)
    step = jdp.make_sharded_step(jmesh, use_pallas=leg == "dp_k",
                                 interpret=True)
    jp, jv = step(*jml.shard_state_planes(jmesh, jplanes(g["pos"]),
                                          jplanes(g["vel"])),
                  jnp.asarray(g["pv"]))
    p, v = port_pair(port[k], leg)
    np.testing.assert_allclose(p, flat(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v, flat(jv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", WORLDS)
def test_global_mean_speed_matches_jax(port, k):
    jmesh, g, _ = jax_setup(k)
    (vel,) = jml.shard_state_planes(jmesh, jplanes(g["vel"]))
    want = float(jdp.make_global_mean_speed(jmesh)(vel))
    for res in port[k]:                 # the same number on every rank
        assert res["speed"] == pytest.approx(want, rel=1e-5)


# -- the ring --------------------------------------------------------------------------
@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("leg", ["ring", "ring_m", "ring_k", "ring_km"])
def test_ring_matches_jax(port, k, leg):
    jmesh, g, _ = jax_setup(k)
    with_m = leg.endswith("m")
    step = jring.make_ring_pairwise_step(
        jmesh, interpret=True, use_pallas="_k" in leg, with_masses=with_m)
    extra = (jnp.asarray(g["masses"]),) if with_m else ()
    jp, jv = step(*jml.shard_state_planes(jmesh, jplanes(g["pos"]),
                                          jplanes(g["vel"])),
                  jnp.asarray(g["pv"]), jnp.asarray(g["pp"]),
                  jnp.int32(g["n_active"]), *extra)
    p, v = port_pair(port[k], leg)
    np.testing.assert_allclose(p, flat(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v, flat(jv), rtol=1e-4, atol=1e-4)


# -- pm_dp -----------------------------------------------------------------------------
@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("leg,cfg,pallas,bar", [
    ("pm", "pm", False, 1e-4), ("pm_km", "pm", True, 0.02),
    ("pm_auto", "pm_auto", False, 1e-4)])
def test_pm_dp_matches_jax(port, k, leg, cfg, pallas, bar):
    jmesh, g, cf = jax_setup(k)
    with_m = leg == "pm_km"
    step = jpm_dp.make_pm_step(jmesh, cf[cfg], use_pallas=pallas,
                               interpret=True, with_masses=with_m)
    extra = (jnp.asarray(g["masses"]),) if with_m else ()
    jp, jv = step(*jml.shard_state_planes(jmesh, jplanes(g["pos"]),
                                          jplanes(g["vel"])),
                  jnp.asarray(g["pv_pm"]), jnp.asarray(g["pp_pm"]),
                  jnp.int32(g["n_active"]), *extra)
    p, v = port_pair(port[k], leg)
    want = kick(flat(jv), g["vel"])
    np.testing.assert_allclose(p, flat(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(kick(v, g["vel"]), want, rtol=0,
                               atol=bar * np.abs(want).max() + 1e-6)


# -- the persistent PM on the mesh ---------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_persist(k, leg):
    jmesh, g, cf = jax_setup(k)
    cfg2 = {"persist": None, "persist2": cf["pm2"]}.get(leg, cf["levels"])
    cfgx = cf["pmx"] if leg == "persistX" else None
    src = g["dense"] if leg == "persistX" else g["pos"]
    n_levels = len(cfg2) if isinstance(cfg2, tuple) else 0
    init = jpdp.make_persist_init(jmesh, cf["pm"], n_levels=n_levels)
    carry = init(jnp.asarray(src), jnp.asarray(g["vel"]),
                 jnp.int32(g["n_active"]))
    ker = () if cfg2 is None else (
        (jpm2.levels_kernels(cf["pm"], cfg2),) if n_levels
        else (jpm2.fine_kernels(cf["pm"], cfg2),))
    step = jpdp.make_persist_pm_step(jmesh, cf["pm"], interpret=True,
                                     cfg2=cfg2, cfgx=cfgx)
    out = step(*carry, jnp.asarray(g["pv_pm"]), jnp.asarray(g["pp_pm"]),
               jnp.int32(g["n_active"]), *ker)
    ids = np.asarray(out[2])
    counts = np.asarray(out[-1]) if cfgx is not None else None
    return (by_ids(flat(out[0]), ids), by_ids(flat(out[1]), ids), counts)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("leg", ["persist", "persist2", "persistN",
                                 "persistX"])
def test_persist_dp_matches_jax(port, k, leg):
    g = W.inputs(k)
    res = port[k]
    ids = W.shards(res, leg + "_ids")
    # per-shard sorts: every identity stays on its home rank
    np.testing.assert_array_equal(ids // W.PER_SHARD,
                                  np.repeat(np.arange(k), W.PER_SHARD))
    p, v = (by_ids(a, ids) for a in port_pair(res, leg))
    jp, jv, counts = jax_persist(k, leg)
    live = slice(0, g["n_active"])
    scale = np.abs(jv).max()
    np.testing.assert_allclose(p[:, live], jp[:, live], rtol=0, atol=1e-2)
    np.testing.assert_allclose(v[:, live], jv[:, live], rtol=0,
                               atol=max(0.02 * scale, 2e-3))
    want = kick(jv, g["vel"])[:, live]
    np.testing.assert_allclose(kick(v, g["vel"])[:, live], want, rtol=0,
                               atol=0.02 * np.abs(want).max())
    if counts is not None:               # (members, corrected), global
        assert counts[0] > 0
        for r in res:
            np.testing.assert_array_equal(r[leg + "_counts"], counts)


# -- render_dp --------------------------------------------------------------------------
@pytest.mark.parametrize("k", WORLDS)
def test_render_dp_matches_jax(port, k):
    jmesh, g, _ = jax_setup(k)
    vp = jnp.asarray(Camera(aspect=2.0).view_proj())
    planes = [jplanes(g["pos"]), jplanes(g["vel"]),
              jnp.full(jplanes(g["pos"]).shape, 0.8, jnp.float32)]
    fn = jrender_dp.make_render_dp(jmesh, width=256, height=128,
                                   interpret=True)
    want = np.asarray(fn(*jml.shard_state_planes(jmesh, *planes),
                         jnp.asarray(g["pv"]), vp, jnp.int32(g["n_active"])))
    assert want.max() > 0
    for res in port[k]:                  # the same frame on every rank
        np.testing.assert_allclose(res["render"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", WORLDS)
def test_render_dp_from_persistent_carry(port, k):
    """flat=True draws the sorted carry without the identity rebuild:
    the frame of the same points in identity order."""
    for res in port[k]:
        assert res["render_flat"].max() > 0
        np.testing.assert_allclose(res["render_flat"], res["render_ident"],
                                   rtol=0, atol=1e-5)


# -- the group's plumbing, in this process -----------------------------------------------
def test_initialize_without_a_group_is_single_process(monkeypatch):
    for key in distributed.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert not torch.distributed.is_initialized()
    assert distributed.initialize(device="cpu") is False
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.make_mesh("cpu")


def test_backend_follows_the_device():
    assert mesh.backend_for("cuda") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        mesh.backend_for("meta")
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("tcp://localhost:1", device="cpu")
