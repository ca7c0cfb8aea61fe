"""Port rasterizers (render/raster.py, render/raster_compact.py on their
plain CPU path) against the JAX package's renderers and the golden frame."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.render import raster as jraster
from particle_sim_tpu.render import raster_compact as jcompact
from particle_sim_tpu.render.camera import Camera as JCamera
from particle_sim_tpu.utils.search import rank_right_iota as j_rank

from particle_sim_tpu_torch.core.params import SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.render import raster, raster_compact
from particle_sim_tpu_torch.render.camera import Camera
from particle_sim_tpu_torch.utils.search import rank_right_iota

torch.set_num_threads(1)

W, H = 256, 128
# the port's compact render against the JAX compact render: both carry
# colour as bf16 words and deposit in f32, so only the order of the f32
# sums differs
ATOL_COMPACT = 1e-5
# against the scatter oracle: the bar of tests/test_raster_compact.py
# (bf16 colour is relative 2^-9 per point)
ATOL_ORACLE = 5e-3


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


@pytest.mark.parametrize("aspect", [W / H, 4 / 3])
def test_camera_view_proj_equal(aspect):
    jc, tc = JCamera(aspect=aspect), Camera(aspect=aspect)
    for cam in (jc, tc):
        cam.process_mouse_movement(37.0, -12.0)
        cam.process_keyboard({"w", "d"}, False, 0.1)
    np.testing.assert_array_equal(tc.view_proj(), jc.view_proj())
    np.testing.assert_array_equal(tc.uniform(), jc.uniform())


@pytest.mark.parametrize("cursor", [(0.0, 0.0), (640.0, 360.0),
                                    (1100.5, 20.25)])
def test_camera_cursor_equal(cursor):
    jc, tc = JCamera(), Camera()
    world = np.array([3.0, -2.0, 48.0])
    for cam in (jc, tc):
        cam.process_mouse_movement(-20.0, 8.0)
    np.testing.assert_array_equal(
        tc.unproject_cursor(cursor, (1280.0, 720.0), world),
        jc.unproject_cursor(cursor, (1280.0, 720.0), world))
    np.testing.assert_array_equal(tc.scroll_cursor_depth(world, 3.0),
                                  jc.scroll_cursor_depth(world, 3.0))


@pytest.mark.parametrize("n", [1000, 5000])
def test_project_to_pixels_exact(n):
    jargs, targs = sphere_args(n)
    jp = jraster.project_to_pixels(jargs[0].reshape(3, -1), jargs[4], W, H)
    tp = raster.project_to_pixels(targs[0].reshape(3, -1), targs[4], W, H)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp[0].dtype == torch.int32 and tp[2].dtype == torch.float32


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_shaded_rgb_exact(mode):
    jargs, targs = sphere_args(3000, color_mode=mode, seed=1)
    flat = lambda a: a.reshape(3, -1)
    jr = jraster.shaded_rgb(flat(jargs[0]), flat(jargs[1]), flat(jargs[2]),
                            jargs[3])
    tr = raster.shaded_rgb(flat(targs[0]), flat(targs[1]), flat(targs[2]),
                           targs[3])
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_scatter_render_matches_jax(n, mode):
    jargs, targs = sphere_args(n, color_mode=mode)
    ref = np.asarray(jraster.render(*jargs, width=W, height=H))
    got = raster.render(*targs, width=W, height=H).numpy()
    # same f32 terms, scatter sums in another order
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_compact_matches_jax_compact(n, mode):
    jargs, targs = sphere_args(n, color_mode=mode)
    ref = np.asarray(jcompact.render(*jargs, width=W, height=H,
                                     interpret=True))
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_COMPACT)


@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_compact_matches_scatter_oracle(n, mode):
    jargs, targs = sphere_args(n, color_mode=mode)
    ref = np.asarray(jraster.render(*jargs, width=W, height=H))
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_ORACLE)
    assert (got.sum(-1) > 0).sum() == (ref.sum(-1) > 0).sum()


def test_partial_occupancy_masked():
    # padding (capacity 1024) must not deposit anything
    jargs, targs = sphere_args(900)
    ref = np.asarray(jraster.render(*jargs, width=W, height=H))
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_ORACLE)


def test_bucket_switch_offscreen_cloud():
    """tests/test_raster_compact.py's off-screen cloud: most chunks are
    behind the camera, so a small bucket is taken."""
    n = 40960
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    pos[:, 2] += 160.0
    pos[: n // 64, 2] -= 140.0
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.random((n, 3), dtype=np.float32)
    jargs, targs = both_args(pos, vel, col, color_mode=0)
    words = raster_compact.point_words(*targs, width=W, height=H)
    kept = int(words.kept_n) * raster_compact.CHUNK
    assert kept < raster_compact.buckets(n)[-1]     # a smaller bucket
    ref = np.asarray(jraster.render(*jargs, width=W, height=H))
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_ORACLE)
    assert (ref.sum(-1) > 0).any()


def test_order_independence():
    _, targs = sphere_args(5000)
    pos, vel, col, pv, vp, _ = targs
    perm = torch.from_numpy(
        np.random.default_rng(1).permutation(pos[0].numel()))
    shuf = [a.reshape(3, -1)[:, perm].reshape(a.shape) for a in (pos, vel, col)]
    na = torch.tensor(pos[0].numel(), dtype=torch.int32)
    ref = raster_compact.render(pos, vel, col, pv, vp, na, width=W, height=H)
    got = raster_compact.render(*shuf, pv, vp, na, width=W, height=H)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL_ORACLE)


def test_hotspot_single_pixel():
    n = 4096
    pos = np.zeros((n, 3), np.float32)
    vel = np.full((n, 3), 5.0, np.float32)
    col = np.full((n, 3), 1.0 / n, np.float32)
    _, targs = both_args(pos, vel, col, color_mode=0)
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    ys, xs = np.nonzero(got.sum(-1))
    assert list(zip(ys, xs)) == [(H // 2, W // 2)]
    assert got[H // 2, W // 2] == pytest.approx([1.0] * 3, abs=0.02)


def test_rejects_unaligned_resolution():
    _, targs = sphere_args(1000)
    with pytest.raises(ValueError, match="multiple"):
        raster_compact.render(*targs, width=250, height=100)


def test_golden_frame():
    """The scene of tests/test_viewer_decode.py's golden-frame test,
    rendered by the port's compact pipeline, within 3 u8 levels of
    tests/data/golden_raster_256x128.npz."""
    pos, vel, col = G.generate(3000, G.SphereGeneration.HOLLOW)
    vel = (pos * 0.02).astype(np.float32)   # brightness = min(2|v|, 1)
    st = ParticleState.from_arrays(pos, vel, col, device="cpu")
    pv = torch.from_numpy(SimParams().pack())
    vp = torch.from_numpy(Camera(aspect=W / H).view_proj())
    fb = raster_compact.render(st.pos, st.vel, st.init_color, pv, vp,
                               st.n_active, width=W, height=H)
    rgba = raster.to_rgba8(fb).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "golden_raster_256x128.npz"))["rgba"]
    assert rgba.shape == golden.shape
    assert (golden[..., :3].sum(-1) > 0).sum() > 2000  # not vacuous
    diff = np.abs(rgba.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 3, f"raster pixels drifted: max {diff.max()}"


def test_to_rgba8_matches_jax():
    fb = np.random.default_rng(3).uniform(-0.2, 1.2, (H, W, 3))
    fb = fb.astype(np.float32)
    np.testing.assert_array_equal(
        raster.to_rgba8(torch.from_numpy(fb)).numpy(),
        np.asarray(jraster.to_rgba8(jnp.asarray(fb))))


def test_pack_rgb_bf16_bit_identical():
    v = np.random.default_rng(4).normal(size=(3, 4096)).astype(np.float32)
    v[:, :4] = [0.0, 1.0, -0.0, 3.0e-39]   # zero, one, -0, denormal
    jw = jcompact._pack_rgb_bf16(*(jnp.asarray(c) for c in v))
    tw = raster_compact.pack_rgb_bf16(*(torch.from_numpy(c) for c in v))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # unpacking gives the round-to-nearest bf16 value of each channel
    r, g, b = raster_compact.unpack_rgb_bf16(*tw)
    bf = torch.from_numpy(v).to(torch.bfloat16).float()
    for got, want in zip((r, g, b), bf):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("c_max", [1, 50, 4096])
def test_rank_right_iota_matches_jax(c_max):
    base = np.sort(np.random.default_rng(5).integers(0, 5000, 300))
    base = np.concatenate([[0], base]).astype(np.int32)
    np.testing.assert_array_equal(
        rank_right_iota(torch.from_numpy(base), c_max).numpy(),
        np.asarray(j_rank(jnp.asarray(base), c_max)))


def test_kernel_wrappers_on_cpu_take_plain_versions():
    _, targs = sphere_args(5000)
    words = raster_compact.point_words(*targs, width=W, height=H)
    n = words.key.shape[0]
    c0 = raster_compact.COMPACT_LAUNCHES
    d0 = raster_compact.DEPOSIT_LAUNCHES
    out = raster_compact.compact(words.key, words.rg, words.b,
                                 words.kept_list, words.kept_n, bucket=n,
                                 sentinel=words.sentinel)
    ref = raster_compact.compact_plain(words.key, words.rg, words.b,
                                       words.kept_list, words.kept_n,
                                       bucket=n, sentinel=words.sentinel)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    pt = raster_compact.pair_table(*out, n_tiles=words.n_tiles,
                                   sentinel=words.sentinel)
    tiles = raster_compact.deposit(pt.table, pt.offsets, pt.key, pt.rg, pt.b,
                                   n_tiles=words.n_tiles)
    assert tiles.shape == (words.n_tiles, 3, 8, 128)
    assert raster_compact.COMPACT_LAUNCHES == c0
    assert raster_compact.DEPOSIT_LAUNCHES == d0


def test_pair_table_offsets_cover_each_tile():
    _, targs = sphere_args(5000)
    words = raster_compact.point_words(*targs, width=W, height=H)
    out = raster_compact.compact(words.key, words.rg, words.b,
                                 words.kept_list, words.kept_n,
                                 bucket=words.key.shape[0],
                                 sentinel=words.sentinel)
    pt = raster_compact.pair_table(*out, n_tiles=words.n_tiles,
                                   sentinel=words.sentinel)
    off = pt.offsets.numpy()
    tab = pt.table.numpy()
    assert off[0] == 0 and (np.diff(off) >= 1).all()   # a PAD entry each
    for t in range(words.n_tiles):
        seg = tab[off[t]:off[t + 1]]
        assert ((seg >> 18) & 0x1FFF == t).all()
        assert seg[0] & (1 << 17)                       # first visit first
    assert (tab[off[-1]:] == 0x7FFFFFFF).all()          # then trash slots


@pytest.mark.parametrize("case", ["dtype", "length", "bucket", "tiles"])
def test_kernel_wrappers_reject_bad_input(case):
    _, targs = sphere_args(1000)
    words = raster_compact.point_words(*targs, width=W, height=H)
    key, rg, b = words.key, words.rg, words.b
    kw = dict(bucket=key.shape[0], sentinel=words.sentinel)
    if case == "dtype":
        rg = rg.to(torch.int64)
    elif case == "length":
        b = b[:-1]
    elif case == "bucket":
        kw["bucket"] = 100
    if case == "tiles":
        with pytest.raises(ValueError):
            raster_compact.deposit(key, torch.zeros(1, dtype=torch.int32),
                                   key, rg, b, n_tiles=9000)
        return
    with pytest.raises((TypeError, ValueError)):
        raster_compact.compact(key, rg, b, words.kept_list, words.kept_n,
                               **kw)
