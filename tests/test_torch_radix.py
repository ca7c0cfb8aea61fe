"""The port's radix sort (ops/psort.py) on CPU tensors: its plain versions
(radix_pass_ref, radix_plan_ref, radix_sort_ref) against numpy's stable
argsort and the merge sort's plain chain, the plan on the keys the repo
sorts, psort.sort's CPU route and ``out`` argument, the workspace size
the kernels check, and the sorted renderer's sort through psort.sort.

The kernels themselves (csrc/radix_sort.cu) run only on the card; the
sort's words there are held to these plain versions by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from particle_sim_tpu.core import generate as G

from particle_sim_tpu_torch.core.params import SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.ops import psort
from particle_sim_tpu_torch.render import raster, raster_sorted
from particle_sim_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

U32_MAX = 0xFFFFFFFF


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def words_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def ordered_np(key):
    """uint64 with the order of a uint32/int32 key (sign bit flipped)."""
    flip = 1 << 31 if key.dtype == np.int32 else 0
    return key.view(np.uint32).astype(np.uint64) ^ flip


def stable_numpy(ops):
    order = np.argsort(ordered_np(ops[0]), kind="stable")
    return [o[order] for o in ops]


def pm_cell_keys(n, rng, grid=128):
    """int32 PM cell keys at G: cells in [0, G^3), dead particles G^3."""
    key = rng.integers(0, grid ** 3, n).astype(np.int32)
    key[rng.random(n) < 0.1] = grid ** 3
    return key


def raster_keys(n=5000, width=1920, height=1080):
    """The sorted renderer's tile keys of a hollow sphere, with the
    sentinel for points that draw nothing."""
    pos, _, col = G.generate(n, G.SphereGeneration.HOLLOW)
    vel = np.random.default_rng(0).normal(size=pos.shape).astype(np.float32)
    st = ParticleState.from_arrays(pos, vel, col, device="cpu")
    return raster.tile_keys(
        st.pos, st.vel, st.init_color,
        torch.from_numpy(SimParams(color_mode=1).pack()),
        torch.from_numpy(Camera(aspect=width / height).view_proj()),
        st.n_active, width=width, height=height)


def make_keys(kind, n, rng):
    if kind == "unique":
        return rng.permutation(n).astype(np.uint32)
    if kind == "sentinel_tail":
        key = np.sort(rng.integers(0, 1 << 21, n)).astype(np.uint32)
        key[n // 2:] = U32_MAX
        rng.shuffle(key)
        return key
    if kind == "duplicates":
        return rng.integers(0, 50, n).astype(np.uint32)
    if kind == "all_equal":
        return np.full(n, 7, np.uint32)
    if kind == "sorted":
        return np.sort(rng.integers(0, 1 << 30, n)).astype(np.uint32)
    if kind == "reversed":
        return np.sort(rng.integers(0, 1 << 30, n))[::-1].astype(np.uint32)
    if kind == "clustered":
        return (rng.integers(0, 4, n) * (1 << 28)
                + rng.integers(0, 100, n)).astype(np.uint32)
    if kind == "negative_i32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    raise ValueError(kind)


# -- one pass: a stable reorder by one digit -----------------------------------
@pytest.mark.parametrize("bits,shift", [(8, 0), (8, 8), (8, 16), (8, 24),
                                        (11, 0), (11, 11), (11, 22)])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_radix_pass_ref_is_stable_reorder_by_digit(bits, shift, dtype):
    rng = np.random.default_rng(bits * 100 + shift)
    n = 6000
    info = np.iinfo(dtype)
    key = rng.integers(info.min, info.max, n, dtype=np.int64,
                       endpoint=True).astype(dtype)
    key[::7] = key[0]                    # repeated digits: ties to keep
    key[3::11] = info.min
    pays = [np.arange(n, dtype=np.int32),
            rng.standard_normal(n).astype(np.float32)]
    got = psort.radix_pass_ref([t(key)] + [t(p) for p in pays], shift, bits)
    digit = (ordered_np(key) >> np.uint64(shift)) & np.uint64((1 << bits) - 1)
    order = np.argsort(digit, kind="stable")
    words_equal(got, [key[order]] + [p[order] for p in pays])


# -- the plan: which digits a sort takes ------------------------------------
def test_radix_plan_ref_on_the_repo_keys():
    rng = np.random.default_rng(5)
    pm = t(pm_cell_keys(100_000, rng))
    assert psort.radix_plan_ref(pm) == (0, 8, 16)           # 22 bits
    assert psort.radix_plan_ref(pm, 11) == (0, 11)
    tk = raster_keys().key
    assert tk.dtype == torch.int32
    assert int(tk.max()) < 1 << 21
    assert psort.radix_plan_ref(tk) == (0, 8, 16)
    assert psort.radix_plan_ref(tk, 11) == (0, 11)


@pytest.mark.parametrize("kind,want", [
    ("random_u32", (0, 8, 16, 24)), ("all_equal", ()),
    ("negative_i32", (0, 8, 16, 24)), ("low_byte_only", (0,)),
    ("top_byte_only", (24,))])
def test_radix_plan_ref_counts(kind, want):
    rng = np.random.default_rng(6)
    n = 20000
    if kind == "random_u32":
        key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    elif kind == "all_equal":
        key = np.full(n, 123456, np.int32)
    elif kind == "negative_i32":
        key = make_keys(kind, n, rng)
    elif kind == "low_byte_only":
        key = (0x5A5A5A00 + rng.integers(0, 256, n)).astype(np.uint32)
    else:
        key = (rng.integers(0, 256, n) << 24 | 0x123456).astype(np.uint32)
    assert psort.radix_plan_ref(t(key)) == want
    assert len(psort.radix_plan_ref(t(key[:1]))) == 0       # one key: none
    assert psort.radix_plan_ref(t(key[:0])) == ()


# -- the whole sort -----------------------------------------------------------
@pytest.mark.parametrize("kind", [
    "unique", "sentinel_tail", "duplicates", "all_equal", "sorted",
    "reversed", "clustered", "negative_i32"])
def test_radix_sort_ref_matches_merge_sort_and_numpy(kind):
    rng = np.random.default_rng(11)
    n = 131072
    key = make_keys(kind, n, rng)
    ops = [key, np.arange(n, dtype=np.int32),
           rng.standard_normal(n).astype(np.float32),
           rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    got = psort.radix_sort_ref([t(o) for o in ops])
    words_equal(got, stable_numpy(ops))
    words_equal(got, psort.merge_sort_ref([t(o) for o in ops]))


@pytest.mark.parametrize("n", [1, 2, 5, 2047, 4095, 4096, 4097, 80000,
                               1_000_448 // 8])
@pytest.mark.parametrize("bits", [8, 11])
def test_radix_sort_ref_ragged_lengths(n, bits):
    rng = np.random.default_rng(n + bits)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    key[rng.random(n) < 0.05] = U32_MAX
    p = np.arange(n, dtype=np.int32)
    got = psort.radix_sort_ref((t(key), t(p)), bits)
    words_equal(got, stable_numpy([key, p]))


def test_radix_sort_ref_pm_words(monkeypatch):
    """The PM forward-sort words (int32 cell key, index, packed
    fractions) in three passes, equal to the merge sort's words."""
    rng = np.random.default_rng(12)
    n = 50000
    ops = [pm_cell_keys(n, rng), np.arange(n, dtype=np.int32),
           rng.integers(0, 1 << 30, n).astype(np.int32)]
    calls = []
    orig = psort.radix_pass_ref

    def counting(operands, shift, bits=psort.RADIX_BITS):
        calls.append(shift)
        return orig(operands, shift, bits)

    monkeypatch.setattr(psort, "radix_pass_ref", counting)
    got = psort.radix_sort_ref([t(o) for o in ops])
    assert calls == [0, 8, 16]
    words_equal(got, stable_numpy(ops))
    words_equal(got, psort.merge_sort_ref([t(o) for o in ops]))


def test_sort_on_cpu_takes_the_radix_plain_version():
    rng = np.random.default_rng(13)
    ops = [t(make_keys("negative_i32", 9000, rng)),
           t(rng.standard_normal(9000).astype(np.float32))]
    before = (psort.RADIX_HIST_LAUNCHES, psort.RADIX_PASS_LAUNCHES,
              psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES,
              psort.LIBRARY_CALLS)
    got = psort.sort(ops)
    assert (psort.RADIX_HIST_LAUNCHES, psort.RADIX_PASS_LAUNCHES,
            psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES,
            psort.LIBRARY_CALLS) == before
    words_equal(got, psort.radix_sort_ref(ops))
    words_equal(psort.merge_sort(ops), psort.merge_sort_ref(ops))


def test_sort_writes_out():
    rng = np.random.default_rng(14)
    n = 7000
    ops = [t(rng.integers(0, 1 << 21, n).astype(np.int32)),
           t(rng.standard_normal(n).astype(np.float32))]
    out = (torch.empty(n, dtype=torch.int32), torch.empty(n))
    got = psort.sort(ops, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    words_equal(out, psort.radix_sort_ref(ops))
    # outside the contract the torch.sort route fills out too
    calls = psort.LIBRARY_CALLS
    psort.sort(ops, num_keys=2, out=out)
    assert psort.LIBRARY_CALLS == calls + 1
    with pytest.raises(ValueError, match="out"):
        psort.sort(ops, out=(out[0],))
    with pytest.raises(ValueError, match="out"):
        psort.sort(ops, out=(out[0], torch.empty(n, dtype=torch.float64)))


@pytest.mark.parametrize("n,bits,want", [
    (1, 8, 8 * 4 * 256 + 4 * 4 * 256 + 16),
    (4096, 8, 8 * 4 * 256 + 4 * 4 * 256 + 16),
    (4097, 8, 8 * 4 * 2 * 256 + 4 * 4 * 256 + 16),
    (16_777_216, 8, 8 * 4 * 4096 * 256 + 4 * 4 * 256 + 16),
    (1_000_000, 11, 8 * 3 * 245 * 2048 + 4 * 3 * 2048 + 12)])
def test_radix_workspace_bytes(n, bits, want):
    assert psort.radix_workspace_bytes(n, bits) == want
    assert psort.radix_digits(bits) == (4 if bits == 8 else 3)


def test_radix_kernel_wrappers_need_cuda_tensors():
    key = t(np.arange(10, dtype=np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        psort.radix_histogram(key)
    with pytest.raises(ValueError, match="CUDA"):
        psort.radix_pass((key,), (key.clone(),), (key.clone(),),
                         torch.empty(0, dtype=torch.uint8), 0)


# -- the consumer: the sorted renderer -----------------------------------------
def torch_sort_points(keys):
    """sort_points as it was before it called psort.sort: torch.sort of
    the key, then a gather of the stacked colours."""
    key_s, order = torch.sort(keys.key)
    rgb_s = torch.stack([keys.r, keys.g, keys.b])[:, order].contiguous()
    return key_s, rgb_s


@pytest.mark.parametrize("width,height", [(256, 128), (1280, 720)])
def test_sort_points_matches_torch_sort(width, height):
    keys = raster_keys(8000, width, height)
    sp = raster_sorted.sort_points(keys)
    key_t, rgb_t = torch_sort_points(keys)
    assert torch.equal(sp.key, key_t)
    # stable: each key's colours in input order
    order = np.argsort(keys.key.numpy(), kind="stable")
    rgb = torch.stack([keys.r, keys.g, keys.b]).numpy()
    np.testing.assert_array_equal(sp.rgb.numpy(), rgb[:, order])
    # the same per-tile sums within the renderer's bar (tests/
    # test_torch_raster_sorted.py's ATOL)
    a = raster_sorted.deposit_plain(sp.key, sp.rgb, sp.offsets,
                                    n_tiles=sp.n_tiles)
    b = raster_sorted.deposit_plain(key_t, rgb_t, sp.offsets,
                                    n_tiles=sp.n_tiles)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)
