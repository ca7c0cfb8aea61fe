"""Port sorted-deposit rasterizer (render/raster_sorted.py on its plain CPU
path) and stream packing (raster.pack_points) against the JAX package's
sorted renderer in interpret mode, its scatter oracle, its pack and the
golden frame."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.render import raster as jraster
from particle_sim_tpu.render import raster_sorted as jsorted
from particle_sim_tpu.render.camera import Camera as JCamera

from particle_sim_tpu_torch.core.params import SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.render import raster, raster_compact, raster_sorted
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

W, H = 256, 128
# the bar of tests/test_raster_sorted.py: the additive blend sums in
# another order, and the TPU kernel's one-hot matmul carries colour as
# bf16 (relative 2^-9 per point)
ATOL = 5e-3


def both_args(pos, vel, col, color_mode=1):
    js = JState.from_arrays(pos, vel, col)
    ts = ParticleState.from_arrays(pos, vel, col, device="cpu")
    jargs = (js.pos, js.vel, js.init_color,
             jnp.asarray(JSimParams(color_mode=color_mode).pack()),
             jnp.asarray(JCamera(aspect=W / H).view_proj()), js.n_active)
    targs = (ts.pos, ts.vel, ts.init_color,
             torch.from_numpy(SimParams(color_mode=color_mode).pack()),
             torch.from_numpy(Camera(aspect=W / H).view_proj()), ts.n_active)
    return jargs, targs


def sphere_args(n, color_mode=1, seed=0):
    pos, _, col = G.generate(n, G.SphereGeneration.HOLLOW)
    vel = np.random.default_rng(seed).normal(size=pos.shape)
    return both_args(pos, vel.astype(np.float32), col, color_mode)


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_matches_jax_sorted_interpret(n, mode):
    jargs, targs = sphere_args(n, color_mode=mode)
    ref = np.asarray(jsorted.render(*jargs, width=W, height=H,
                                    interpret=True))
    got = raster_sorted.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (got.sum(-1) > 0).sum() == (ref.sum(-1) > 0).sum()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_matches_scatter_oracle(mode):
    """Against the JAX scatter oracle: f32 payload and f32 sums, so the
    bar is the sum order's."""
    jargs, targs = sphere_args(5000, color_mode=mode)
    ref = np.asarray(jraster.render(*jargs, width=W, height=H))
    got = raster_sorted.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_partial_occupancy_masked():
    """900 active in a 1024 capacity: padding deposits nothing."""
    jargs, targs = sphere_args(900)
    ref = np.asarray(jsorted.render(*jargs, width=W, height=H,
                                    interpret=True))
    got = raster_sorted.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    oracle = raster.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-5)


def test_hotspot_single_pixel():
    """Every particle on one pixel: one tile holds the whole slice."""
    n = 4096
    pos = np.zeros((n, 3), np.float32)
    vel = np.full((n, 3), 5.0, np.float32)
    col = np.full((n, 3), 1.0 / n, np.float32)
    _, targs = both_args(pos, vel, col, color_mode=0)
    got = raster_sorted.render(*targs, width=W, height=H).numpy()
    lit = got.sum(-1) > 0
    assert lit.sum() == 1
    np.testing.assert_allclose(got[lit][0], [1.0, 1.0, 1.0], atol=1e-4)


def test_order_independence():
    pos, _, col = G.generate(3000, G.SphereGeneration.HOLLOW)
    vel = np.random.default_rng(1).normal(size=pos.shape).astype(np.float32)
    perm = np.random.default_rng(2).permutation(3000)
    a = raster_sorted.render(*both_args(pos, vel, col)[1], width=W, height=H)
    b = raster_sorted.render(*both_args(pos[perm], vel[perm], col[perm])[1],
                             width=W, height=H)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_rejects_unaligned_resolution():
    _, targs = sphere_args(1000)
    with pytest.raises(ValueError, match="multiple"):
        raster_sorted.render(*targs, width=250, height=100)


def test_golden_frame():
    """The golden-frame scene through the sorted pipeline, within 3 u8
    levels of tests/data/golden_raster_256x128.npz."""
    pos, vel, col = G.generate(3000, G.SphereGeneration.HOLLOW)
    vel = (pos * 0.02).astype(np.float32)   # brightness = min(2|v|, 1)
    st = ParticleState.from_arrays(pos, vel, col, device="cpu")
    fb = raster_sorted.render(
        st.pos, st.vel, st.init_color, torch.from_numpy(SimParams().pack()),
        torch.from_numpy(Camera(aspect=W / H).view_proj()), st.n_active,
        width=W, height=H)
    rgba = raster.to_rgba8(fb).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "golden_raster_256x128.npz"))["rgba"]
    assert (golden[..., :3].sum(-1) > 0).sum() > 2000  # not vacuous
    diff = np.abs(rgba.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 3, f"raster pixels drifted: max {diff.max()}"


def test_sorted_and_compact_frames_agree():
    _, targs = sphere_args(5000)
    a = raster_sorted.render(*targs, width=W, height=H)
    b = raster_compact.render(*targs, width=W, height=H)
    assert np.abs(raster.to_rgba8(a).numpy().astype(np.int16)
                  - raster.to_rgba8(b).numpy().astype(np.int16)).max() <= 1


def test_tile_slices_hold_their_points():
    """Each tile's slice [offsets[t], offsets[t+1]) of the sorted keys
    holds exactly the points of tile t; sentinels follow the last."""
    _, targs = sphere_args(5000)
    keys = raster.tile_keys(*targs, width=W, height=H)
    sp = raster_sorted.sort_points(keys)
    key, off = sp.key.numpy(), sp.offsets.numpy()
    assert off[0] == 0 and (np.diff(off) >= 0).all()
    for t in range(sp.n_tiles):
        assert ((key[off[t]:off[t + 1]] >> 10) == t).all()
    assert (key[off[-1]:] == keys.sentinel).all()
    assert off[-1] == int((keys.key < keys.sentinel).sum())


def test_deposit_wrapper_on_cpu_takes_plain_version():
    _, targs = sphere_args(5000)
    sp = raster_sorted.sort_points(
        raster.tile_keys(*targs, width=W, height=H))
    launches = raster_sorted.LAUNCHES
    got = raster_sorted.deposit(sp.key, sp.rgb, sp.offsets,
                                n_tiles=sp.n_tiles)
    ref = raster_sorted.deposit_plain(sp.key, sp.rgb, sp.offsets,
                                      n_tiles=sp.n_tiles)
    assert got.shape == (sp.n_tiles, 3, 8, 128)
    assert torch.equal(got, ref)
    assert raster_sorted.LAUNCHES == launches


@pytest.mark.parametrize("case", ["key_dtype", "rgb_shape", "offsets_len",
                                  "not_contiguous", "no_tiles"])
def test_deposit_rejects_bad_input(case):
    _, targs = sphere_args(1000)
    sp = raster_sorted.sort_points(
        raster.tile_keys(*targs, width=W, height=H))
    key, rgb, off, nt = sp.key, sp.rgb, sp.offsets, sp.n_tiles
    if case == "key_dtype":
        key = key.to(torch.int64)
    elif case == "rgb_shape":
        rgb = rgb[:2]
    elif case == "offsets_len":
        off = off[:-1]
    elif case == "not_contiguous":
        rgb = torch.cat([rgb, rgb], dim=1)[:, ::2]
    elif case == "no_tiles":
        nt, off = 0, off[:1]
    with pytest.raises((TypeError, ValueError)):
        raster_sorted.deposit(key, rgb, off, n_tiles=nt)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("n_stop", [5000, 1234])
def test_pack_points_matches_jax(stride, n_stop):
    """Positions and rgba8 of the stream pack equal the JAX package's."""
    jargs, targs = sphere_args(5000, color_mode=1)
    jp, jc = jraster.pack_points_jit(*jargs[:4], n_stop=n_stop, stride=stride)
    tp, tc = raster.pack_points(*targs[:4], n_stop=n_stop, stride=stride)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc[(n_stop + stride - 1) // stride:, 3] == 0).all()
    assert (tc[:(n_stop + stride - 1) // stride, 3] == 255).all()
