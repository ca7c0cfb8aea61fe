"""The port's two tiled renderers (render/raster_compact.py and
render/raster_sorted.py, on their plain CPU path) against the JAX
package's in interpret mode, on frames that load the deposits unevenly:
one tile fed by many chunks, every point on one pixel, points only in the
last tile, a frame that draws nothing, and a chunk whose sorted run
straddles three tiles. Also the bf16 words of ``raster_compact.words_of``
against a numpy reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.render import raster as jraster
from particle_sim_tpu.render import raster_compact as jcompact
from particle_sim_tpu.render import raster_sorted as jsorted
from particle_sim_tpu.render.camera import Camera as JCamera

from particle_sim_tpu_torch.core.params import SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.render import raster, raster_compact, raster_sorted
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

W, H = 256, 128                 # 2 x 16 tiles of 8 x 128
# the bars of tests/test_torch_raster.py and test_torch_raster_sorted.py:
# both compact renderers carry colour as bf16 words and sum in f32; the
# JAX sorted kernel's one-hot matmul rounds colour to bf16 (2^-9), the
# port's sorted deposit and the scatter oracle sum f32 colour in f32
ATOL_COMPACT = 1e-5
ATOL_SORTED_JAX = 5e-3
ATOL_F32 = 1e-5


def pixel_positions(px, py, rng):
    """World positions (f32[n, 3]) in the z = 0 plane that the default
    camera projects onto pixels (px, py), jittered inside each pixel."""
    vp = Camera(aspect=W / H).view_proj().astype(np.float64)
    origin = vp @ np.array([0.0, 0.0, 0.0, 1.0])
    ndc_z = origin[2] / origin[3]
    fx = px + 0.5 + rng.uniform(-0.3, 0.3, px.shape)
    fy = py + 0.5 + rng.uniform(-0.3, 0.3, py.shape)
    clip = np.stack([fx / W * 2.0 - 1.0, 1.0 - fy / H * 2.0,
                     np.full(px.shape, ndc_z), np.ones(px.shape)])
    world = np.linalg.inv(vp) @ clip
    return (world[:3] / world[3]).T.astype(np.float32)


def frame_case(name, rng):
    """(pos, vel, col) of one adversarial frame; capacities are multiples
    of 512 and colour is small enough that no pixel saturates."""
    if name == "many_chunks_one_tile":
        # 80 chunks' worth of points in tile 5 (rows 16-23, lanes
        # 128-255): ~40 a pixel
        n = 80 * 512
        px = 128 + rng.integers(0, 128, n)
        py = 16 + rng.integers(0, 8, n)
        scale = 1.0 / 80
    elif name == "one_pixel":
        n = 4096
        px, py = np.full(n, 100), np.full(n, 37)
        scale = 1.0 / (2 * n)
    elif name == "last_tile":
        n = 3072
        px = 128 + rng.integers(0, 128, n)
        py = H - 8 + rng.integers(0, 8, n)
        scale = 0.1
    elif name == "all_sentinel":
        # behind the camera (it sits at z = 100 looking at the origin)
        n = 2048
        pos = rng.normal(size=(n, 3)).astype(np.float32)
        pos[:, 2] += 150.0
        vel = np.full((n, 3), 1.0, np.float32)
        return pos, vel, rng.random((n, 3), dtype=np.float32)
    elif name == "run_straddles_three_tiles":
        # one chunk: thirds in tiles 4, 5 and 6 (keys ascend across them),
        # so its sorted run spans three tiles
        n = 512
        t = np.arange(n) * 3 // n
        px = np.where(t == 1, 128, 0) + rng.integers(0, 128, n)
        py = np.where(t == 2, 24, 16) + rng.integers(0, 8, n)
        scale = 0.05
    else:
        raise ValueError(name)
    pos = pixel_positions(px, py, rng)
    vel = np.full((n, 3), 1.0, np.float32)        # brightness min(2|v|, 1) = 1
    col = (rng.random((n, 3)) * scale).astype(np.float32)
    return pos, vel, col


CASES = ["many_chunks_one_tile", "one_pixel", "last_tile", "all_sentinel",
         "run_straddles_three_tiles"]


def both_args(name, seed=0):
    pos, vel, col = frame_case(name, np.random.default_rng(seed))
    js = JState.from_arrays(pos, vel, col)
    ts = ParticleState.from_arrays(pos, vel, col, device="cpu")
    jargs = (js.pos, js.vel, js.init_color,
             jnp.asarray(JSimParams(color_mode=0).pack()),
             jnp.asarray(JCamera(aspect=W / H).view_proj()), js.n_active)
    targs = (ts.pos, ts.vel, ts.init_color,
             torch.from_numpy(SimParams(color_mode=0).pack()),
             torch.from_numpy(Camera(aspect=W / H).view_proj()), ts.n_active)
    return jargs, targs


def lit_pixels(fb):
    return set(zip(*np.nonzero(np.asarray(fb).sum(-1) > 0)))


@pytest.mark.parametrize("name", CASES)
def test_compact_matches_jax_compact(name):
    jargs, targs = both_args(name)
    ref = np.asarray(jcompact.render(*jargs, width=W, height=H,
                                     interpret=True))
    got = raster_compact.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_COMPACT)
    assert lit_pixels(got) == lit_pixels(ref)
    assert got.max() < 1.0 or name == "all_sentinel"   # nothing saturates


@pytest.mark.parametrize("name", CASES)
def test_sorted_matches_jax_sorted(name):
    jargs, targs = both_args(name)
    ref = np.asarray(jsorted.render(*jargs, width=W, height=H,
                                    interpret=True))
    got = raster_sorted.render(*targs, width=W, height=H).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_SORTED_JAX)
    assert lit_pixels(got) == lit_pixels(ref)
    oracle = np.asarray(jraster.render(*jargs, width=W, height=H))
    np.testing.assert_allclose(got, oracle, atol=ATOL_F32)


@pytest.mark.parametrize("name", CASES)
def test_frames_land_where_the_case_puts_them(name):
    """The cases load the deposits as their names say: which tiles are
    lit, and the compact table's entries for the loaded tile."""
    _, targs = both_args(name)
    keys = raster.tile_keys(*targs, width=W, height=H)
    live = keys.key[keys.key < keys.sentinel]
    tiles = set((live >> 10).tolist())
    words = raster_compact.words_of(keys)
    kept = int(words.kept_n) * raster_compact.CHUNK
    bucket = next(b for b in raster_compact.buckets(keys.key.shape[0])
                  if kept <= b)
    pt = raster_compact.pair_table(
        *raster_compact.compact(words.key, words.rg, words.b,
                                words.kept_list, words.kept_n,
                                bucket=bucket, sentinel=words.sentinel),
        n_tiles=words.n_tiles, sentinel=words.sentinel)
    table = pt.table[:int(pt.offsets[-1])]
    real = table[(table & raster_compact._F_BIT) == 0]
    per_tile = torch.bincount((real >> raster_compact._T_SHIFT)
                              & raster_compact._MAX_TILES,
                              minlength=keys.n_tiles)
    if name == "many_chunks_one_tile":
        assert tiles == {5} and int(per_tile[5]) >= 64
    elif name == "one_pixel":
        assert set(live.tolist()) == {(37 // 8) * 2 * 1024
                                      + (37 % 8) * 128 + 100}
    elif name == "last_tile":
        assert tiles == {keys.n_tiles - 1}
    elif name == "all_sentinel":
        assert live.numel() == 0 and int(words.kept_n) == 0
    else:
        chunk = pt.key[:512]
        assert set((chunk[chunk < keys.sentinel] >> 10).tolist()) \
            == {4, 5, 6}
        assert per_tile[4:7].tolist() == [1, 1, 1]


def bf16_bits(x):
    """Round-to-nearest bf16 bits of f32 values, as numpy computes them
    from the f32 bit pattern (0x8000 added, then the top 16 bits)."""
    raw = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((raw + 0x8000) >> 16) & 0xFFFF


@pytest.mark.parametrize("name", ["many_chunks_one_tile", "all_sentinel"])
def test_words_of_matches_numpy(name):
    """raster_compact.words_of: colour packed as bf16 bits (r low and g
    high half of one word, b low half of another) and the visible chunks
    listed first, in order."""
    _, targs = both_args(name, seed=3)
    keys = raster.tile_keys(*targs, width=W, height=H)
    words = raster_compact.words_of(keys)
    r, g, b = (np.asarray(c) for c in (keys.r, keys.g, keys.b))
    rg = (bf16_bits(r) | (bf16_bits(g) << 16)).astype(np.uint32)
    np.testing.assert_array_equal(words.rg.numpy().view(np.uint32), rg)
    np.testing.assert_array_equal(words.b.numpy(), bf16_bits(b))
    vis = (keys.key.numpy().reshape(-1, 512) < keys.sentinel).any(axis=1)
    order = np.concatenate([np.nonzero(vis)[0], np.nonzero(~vis)[0]])
    np.testing.assert_array_equal(words.kept_list.numpy(), order)
    assert int(words.kept_n) == vis.sum()
    assert torch.equal(words.key, keys.key)
