"""The port's matrix-product all-pairs force (ops/pairwise.py:
pairwise_accel_mxu_ref, and ops/pairwise_cuda.py:pairwise_accel_mxu on
CPU tensors, where it takes that plain version) against the JAX package's
pairwise_pallas.pairwise_accel_mxu (its Pallas kernel in interpret mode)
and the jnp oracle pairwise.pairwise_accel.

Tolerances. Port and JAX compute the same expanded f32 form, r^2 =
-2 xi.xj + (|xi|^2 + eps^2) + |xj|^2, in different summation orders. Its
terms reach 2 R^2 = 5,000 at radius 50 and round by up to ~3e-4 each,
against r^2 = eps^2 = 0.25 for the nearest pairs: each version sits a few
1e-3 of max|a| from the exact sum (measured here: ~7e-4 of max|a| for
the port, ~8e-4 for JAX). Two of them differ by at most the sum: the
bar is 2e-3 max|a|. Against the direct-sum oracle the JAX test's own
bar holds (tests/test_pairwise.py: max |d| / (|a| + 1e-2) < 0.05).

The CUDA kernels (csrc/pairwise_mxu.cu, csrc/hilbert.cu) run only on the
card (chip_smoke.py phase 14). Here the Hilbert keys' plain version is
held bit for bit to the expression it was split from, and a numpy
emulation of the force kernel's numerics (TF32 parts, r^2 from the
widened-K product, block centring on Hilbert-ordered receivers) is held
to phase 14's bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.ops import pairwise as jpairwise
from particle_sim_tpu.ops import pairwise_pallas

from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda, psort

torch.set_num_threads(1)

GC, EPS = 2.5, 0.5


def both_flat(n):
    """Filled-sphere positions as (JAX f32[3, cap], torch f32[3, cap]) with
    the same values (the JAX test's make_state)."""
    pos, _, col = G.generate(n, G.SphereGeneration.FILLED)
    js = JState.from_arrays(pos, np.zeros_like(pos), col)
    ts = ParticleState.from_arrays(pos, np.zeros_like(pos), col,
                                   device="cpu")
    return js.pos.reshape(3, -1), ts.pos.reshape(3, -1)


def assert_close_mxu(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0.0, atol=2e-3 * scale)


def assert_jax_bar(got, oracle):
    rel = np.abs(got - oracle) / (np.abs(oracle) + 1e-2)
    assert rel.max() < 0.05


def jax_mxu(jflat_i, jflat_j, n_active, j_base=0):
    return np.asarray(pairwise_pallas.pairwise_accel_mxu(
        jflat_i, jflat_j, n_active, GC, EPS, j_base=j_base, tile_i=256,
        tile_j=512, interpret=True))


@pytest.fixture(scope="module")
def sphere():
    return both_flat(2048)


def test_matches_jax_mxu_and_oracle(sphere):
    jflat, tflat = sphere
    n = tflat.shape[1]
    launches = pairwise_cuda.MXU_LAUNCHES
    got = pairwise_cuda.pairwise_accel_mxu(tflat, tflat, n, GC, EPS)
    assert pairwise_cuda.MXU_LAUNCHES == launches     # CPU: no kernel
    assert got.shape == (3, n) and got.dtype == torch.float32
    assert_close_mxu(got.numpy(), jax_mxu(jflat, jflat, n))
    oracle = np.asarray(jpairwise.pairwise_accel(jflat, n, GC, EPS))
    assert_jax_bar(got.numpy(), oracle)


def test_rectangular_receivers(sphere):
    """Ni = 1024 receivers x Nj = 2048 sources."""
    jflat, tflat = sphere
    n = tflat.shape[1]
    got = pairwise_cuda.pairwise_accel_mxu(tflat[:, :1024].contiguous(),
                                           tflat, n, GC, EPS)
    assert got.shape == (3, 1024)
    assert_close_mxu(got.numpy(), jax_mxu(jflat[:, :1024], jflat, n))


def test_j_base_halves_sum_to_full(sphere):
    """Sources split at j_base = N/2: each half matches the JAX kernel's,
    and the halves add up to the full sum."""
    jflat, tflat = sphere
    n = tflat.shape[1]
    half = n // 2
    full = pairwise.pairwise_accel_mxu_ref(tflat, tflat, n, GC, EPS)
    parts = []
    for lo, hi in ((0, half), (half, n)):
        got = pairwise_cuda.pairwise_accel_mxu(
            tflat, tflat[:, lo:hi].contiguous(), n, GC, EPS, j_base=lo)
        assert_close_mxu(got.numpy(), jax_mxu(jflat, jflat[:, lo:hi], n,
                                              j_base=lo))
        parts.append(got)
    assert_close_mxu((parts[0] + parts[1]).numpy(), full.numpy())


def test_ragged_n_active_with_poisoned_padding():
    """1500 active in a 2048 capacity: masked sources add exactly 0, so
    padding poisoned to 1e3 gives the same bits as zero padding, and both
    match the JAX kernel and the oracle."""
    jflat, tflat = both_flat(1500)
    assert tflat.shape[1] == 2048
    poisoned = tflat.clone()
    poisoned[:, 1500:] = 1e3
    a0 = pairwise_cuda.pairwise_accel_mxu(tflat, tflat, 1500, GC, EPS)
    a1 = pairwise_cuda.pairwise_accel_mxu(poisoned, poisoned, 1500, GC, EPS)
    assert torch.equal(a0[:, :1500], a1[:, :1500])
    assert_close_mxu(a1.numpy()[:, :1500], jax_mxu(
        jnp.asarray(poisoned.numpy()), jnp.asarray(poisoned.numpy()),
        1500)[:, :1500])
    oracle = np.asarray(jpairwise.pairwise_accel(jflat, 1500, GC, EPS))
    assert_jax_bar(a0.numpy()[:, :1500], oracle[:, :1500])


def test_tiles_are_ignored_hints(sphere):
    _, tflat = sphere
    n = tflat.shape[1]
    a = pairwise_cuda.pairwise_accel_mxu(tflat, tflat, n, GC, EPS)
    b = pairwise_cuda.pairwise_accel_mxu(tflat, tflat, n, GC, EPS,
                                         tile_i=128, tile_j=256)
    assert torch.equal(a, b)


def test_plain_in_chunks_equals_one_chunk(sphere, monkeypatch):
    """The source chunking changes only the order of the f32 sum."""
    _, tflat = sphere
    n = tflat.shape[1]
    whole = pairwise.pairwise_accel_mxu_ref(tflat, tflat, n, GC, EPS)
    monkeypatch.setattr(pairwise, "CHUNK_PAIRS", 100 * n)
    chunked = pairwise.pairwise_accel_mxu_ref(tflat, tflat, n, GC, EPS)
    assert_close_mxu(chunked.numpy(), whole.numpy())


def test_tf32_flag_restored(sphere):
    _, tflat = sphere
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        pairwise.pairwise_accel_mxu_ref(tflat[:, :256], tflat[:, :256], 256,
                                        GC, EPS)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_source_terms_mask():
    """Masked sources (global index >= n_active) carry |xj|^2 + MASK_BIG
    and a zero xj_aug row; valid ones G [x, y, z, 1]."""
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    xj2, aug = pairwise.mxu_source_terms(src, 5, 2.0, j_base=3)
    assert aug.shape == (4, 4)
    torch.testing.assert_close(aug[:, :2], 2.0 * torch.cat(
        [src[:, :2], torch.ones(1, 2)]))
    assert torch.equal(aug[:, 2:], torch.zeros(4, 2))
    assert (xj2[2:] >= pairwise.MASK_BIG).all()
    torch.testing.assert_close(xj2[:2], (src[:, :2] ** 2).sum(0))


@pytest.mark.parametrize("bits", [3, 4])
def test_hilbert_order_walks_the_grid(bits):
    """On a full 2^bits-cube grid the order is a permutation in which every
    point is a grid neighbour of the one before (a Hilbert curve)."""
    side = 1 << bits
    axis = torch.arange(side, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij")
                       ).reshape(3, -1)
    order = pairwise_cuda.hilbert_order(grid, bits=bits)
    assert sorted(order.tolist()) == list(range(side ** 3))
    steps = (grid[:, order[1:]] - grid[:, order[:-1]]).abs().sum(0)
    assert bool((steps == 1).all())


def test_inlier_box_leaves_out_far_padding():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-50, 50, (3, 1000)).astype(np.float32)
    pts[:, 900:] = 1e3
    box = pairwise_cuda.inlier_box(torch.from_numpy(pts)).numpy()
    assert (box[:3] <= -50).all() and (box[3:] >= 50).all()
    assert (box[3:] < 1e3).all()


@pytest.mark.parametrize("case", [
    "pos_shape", "src_shape", "dtype", "device_mix", "not_tensor"])
def test_rejects_bad_input(case):
    pos = torch.zeros((3, 64))
    src = torch.zeros((3, 64))
    if case == "pos_shape":
        pos = torch.zeros((64, 3))
    elif case == "src_shape":
        src = torch.zeros((4, 64))
    elif case == "dtype":
        src = src.double()
    elif case == "device_mix":
        src = src.to("meta")
    else:
        pos = np.zeros((3, 64), np.float32)
    with pytest.raises((ValueError, TypeError)):
        pairwise_cuda.pairwise_accel_mxu(pos, src, 64, 1.0, 0.5)


# -- the Hilbert keys and the receiver order -----------------------------------


def keys_as_before(pos_flat, bits):
    """The key expression of hilbert_order before it was split into
    hilbert_keys and a sort (the argument of its argsort), verbatim."""
    p = torch.nan_to_num(pos_flat)
    lo = p.amin(1, keepdim=True)
    span = (p.amax(1, keepdim=True) - lo).clamp_min(1e-30)
    top = (1 << bits) - 1
    q = ((p - lo) / span * top).clamp(0.0, top).to(torch.int32)
    x = [q[0], q[1], q[2]]
    bit = 1 << (bits - 1)
    while bit > 1:
        low = bit - 1
        for i in range(3):
            flip = (x[i] & bit) != 0
            if i == 0:
                x[0] = torch.where(flip, x[0] ^ low, x[0])
                continue
            t = torch.where(flip, 0, (x[0] ^ x[i]) & low)
            x[0] = x[0] ^ torch.where(flip, low, t)
            x[i] = x[i] ^ t
        bit >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    bit = 1 << (bits - 1)
    while bit > 1:
        t = torch.where((x[2] & bit) != 0, t ^ (bit - 1), t)
        bit >>= 1
    sp = pairwise_cuda._spread_bits
    return (sp(x[0] ^ t) << 2) | (sp(x[1] ^ t) << 1) | sp(x[2] ^ t)


@pytest.mark.parametrize("bits", range(2, 11))
def test_hilbert_keys_bit_exact(sphere, bits):
    _, tflat = sphere
    got = pairwise_cuda.hilbert_keys(tflat, bits)
    assert got.dtype == torch.int32 and got.shape == (tflat.shape[1],)
    assert torch.equal(got, keys_as_before(tflat, bits))
    assert int(got.max()) < 1 << (3 * bits)
    # the kernel's wrapper takes the plain version on a CPU tensor
    launches = pairwise_cuda.HILBERT_LAUNCHES
    assert torch.equal(pairwise_cuda.hilbert_keys_kernel(tflat, bits), got)
    assert pairwise_cuda.HILBERT_LAUNCHES == launches


def test_hilbert_keys_far_outliers():
    """Padding at 1e30, a point at -1e30, NaN and inf coordinates: the
    keys still match the earlier expression, and the cloud collapses into
    a few cells."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-50, 50, (3, 1000)).astype(np.float32)
    pts[:, 900:] = 1e30
    pts[:, 10] = -1e30
    pts[0, 20] = np.nan
    pts[1, 21] = np.inf
    x = torch.from_numpy(pts)
    for bits in (8, 10):
        got = pairwise_cuda.hilbert_keys(x, bits)
        assert torch.equal(got, keys_as_before(x, bits))
    assert torch.equal(pairwise_cuda.hilbert_box(x), torch.cat(
        [torch.nan_to_num(x).amin(1), torch.nan_to_num(x).amax(1)]))


def test_hilbert_order_is_a_stable_sort_of_the_keys(sphere):
    """hilbert_order == a stable argsort of the keys, and the radix sort
    of (key, index) (psort.sort, radix_sort_ref on the CPU) gives the same
    permutation, also with many equal keys (bits = 2)."""
    _, tflat = sphere
    for bits in (2, 8):
        key = pairwise_cuda.hilbert_keys(tflat, bits)
        order = pairwise_cuda.hilbert_order(tflat, bits)
        assert order.dtype == torch.int64
        assert torch.equal(order, torch.argsort(key, stable=True))
        iota = torch.arange(key.shape[0], dtype=torch.int32)
        assert torch.equal(psort.sort((key, iota))[1].long(), order)
        assert torch.equal(
            pairwise_cuda.receiver_order(tflat, bits).long(), order)


@pytest.mark.parametrize("bits", [0, 11])
def test_hilbert_keys_kernel_rejects_bits(bits):
    with pytest.raises(ValueError):
        pairwise_cuda.hilbert_keys_kernel(torch.zeros((3, 8)), bits)


def radix_select(values, k):
    """The inlier-box kernel's selection (csrc/hilbert.cu select3) in
    numpy: the k-th smallest f32 by four 8-bit digits of the
    order-preserving uint32 image, most significant first."""
    u = np.asarray(values, np.float32).view(np.uint32).astype(np.int64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    prefix, mask = 0, 0
    for shift in (24, 16, 8, 0):
        cand = key[(key & mask) == prefix]
        hist = np.bincount((cand >> shift) & 255, minlength=256)
        cum = np.cumsum(hist)
        digit = int(np.searchsorted(cum, k, side="right"))
        k -= int(cum[digit - 1]) if digit else 0
        prefix |= digit << shift
        mask |= 255 << shift
    u = prefix & 0x7FFFFFFF if prefix & 0x80000000 else ~prefix & 0xFFFFFFFF
    return np.array([u], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("n", [1, 2, 777, 4096, 8191])
def test_inlier_box_radix_select(n):
    """The box kernel's median by radix select equals torch.median (the
    lower middle value) on values with repeats, signed zeros and far
    outliers, and the box built from it equals inlier_box bit for bit."""
    rng = np.random.default_rng(n)
    pts = rng.normal(0.0, 30.0, (3, n)).astype(np.float32)
    pts[0, ::3] = np.round(pts[0, ::3])            # repeats
    pts[1, ::5] = -0.0
    pts[2, ::7] = 1e30
    x = torch.from_numpy(pts)
    k = (n - 1) // 2
    med = np.array([radix_select(pts[c], k) for c in range(3)])
    assert np.array_equal(med, x.median(dim=1).values.numpy())
    mad = np.array([radix_select(np.abs(pts[c] - med[c]), k)
                    for c in range(3)])
    box = np.concatenate([med - np.float32(8.0) * mad,
                          med + np.float32(8.0) * mad]).astype(np.float32)
    assert np.array_equal(box, pairwise_cuda.inlier_box(x).numpy())
    launches = pairwise_cuda.BOX_LAUNCHES
    assert torch.equal(pairwise_cuda.inlier_box_kernel(x),
                       pairwise_cuda.inlier_box(x))
    assert pairwise_cuda.BOX_LAUNCHES == launches     # CPU: no kernel


# -- a numpy emulation of the force kernel's numerics ----------------------------

ROWS = 256   # receivers a block (csrc/pairwise_mxu.cu MXU_ROWS)
MASK13 = np.uint32(0xFFFFE000)


def tf32_round(x):
    """f32 -> TF32 rounded to nearest, ties away (the kernel's bit
    arithmetic (u + 0x1000) & ~0x1FFF; the same value cvt.rna gives)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & MASK13).view(np.float32)


def tf32_trunc(x):
    """f32 -> TF32 truncated: the low 13 bits dropped, as mma.sync reads a
    raw f32 operand."""
    return (np.asarray(x, np.float32).view(np.uint32) & MASK13).view(
        np.float32)


def split2(x, rounded=True):
    """(hi, lo) as the tensor cores read them: hi rounded (or truncated)
    to TF32, lo = x - hi (exact in f32) passed raw and read truncated."""
    x = np.asarray(x, np.float32)
    hi = tf32_round(x) if rounded else tf32_trunc(x)
    return hi.astype(np.float64), tf32_trunc(x - hi).astype(np.float64)


def split3(v):
    """Three TF32 parts of a float64 value held as an f32 pair."""
    hi = v.astype(np.float32)
    lo = (v - hi).astype(np.float32)
    p0 = tf32_round(hi)
    r = (hi - p0) + lo
    p1 = tf32_round(r)
    return [p.astype(np.float64) for p in (p0, p1, tf32_trunc(r - p1))]


def emulate_mxu(pos, src, n_active, g, eps, j_base=0):
    """f32[3, Ni] of the kernel's arithmetic in numpy: receivers in
    Hilbert order, blocks of ROWS centred on their inliers' mean (on all
    of them where none is an inlier); product 1 over K = 12 slots with
    |xi|^2 + eps^2 as its f32 start value (3xTF32 of -2 xi.xj, three
    parts of |xj|^2), one f32 rounding of r^2 (the accumulator); w =
    rsqrt(r^2)^3 in f32, split with a truncated hi; gv [x, y, z, 1] split
    with a rounded hi; product 2 summed exactly. Not bit-exact: the
    tensor cores' own accumulation order is not emulated."""
    pos_t = torch.from_numpy(pos)
    order = pairwise_cuda.hilbert_order(pos_t).numpy()
    box = pairwise_cuda.inlier_box(pos_t).numpy()
    n_j = src.shape[1]
    valid = (np.arange(n_j) + j_base) < n_active
    gv = (np.float32(g) * valid).astype(np.float32)
    out = np.zeros(pos.shape, np.float32)
    for b0 in range(0, pos.shape[1], ROWS):
        idx = order[b0:b0 + ROWS]
        xb = pos[:, idx]
        use = ((xb >= box[:3, None]) & (xb <= box[3:, None])).all(0)
        if not use.any():           # no inlier: every finite receiver
            use = np.isfinite(xb).all(0)
        ctr = xb[:, use].astype(np.float64).mean(1).astype(np.float32)
        xr = xb - ctr[:, None]                              # f32[3, R]
        v = src - ctr[:, None]                              # f32[3, Nj]
        mh, ml = split2(-2.0 * xr)
        vh, vl = split2(v)
        xi2 = ((xr.astype(np.float64) ** 2).sum(0) + np.float64(
            np.float32(eps) * np.float32(eps))).astype(np.float32)
        xj2 = (v.astype(np.float64) ** 2).sum(0) + np.where(valid, 0.0, 1e30)
        r2 = (mh.T @ vh + mh.T @ vl + ml.T @ vh
              + xi2.astype(np.float64)[:, None] + sum(split3(xj2))[None, :])
        inv = (1.0 / np.sqrt(r2.astype(np.float32))).astype(np.float32)
        wh, wl = split2(inv * inv * inv, rounded=False)
        aug = np.concatenate([gv * v, gv[None, :]]).astype(np.float32)
        ah, al = split2(aug)
        s = (ah + al) @ (wh + wl).T                         # (4, R)
        out[:, idx] = (s[:3] - xr * s[3:4]).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["square", "poisoned padding"])
def test_kernel_numerics_within_phase14_bars(case):
    """The emulated kernel against the direct sum (pairwise.pairwise_accel)
    at N = 2,048 at chip_smoke.py phase 14's bars: within twice the plain
    version's own distance from the direct sum, and max |dA| / (|A| +
    1e-2) < 0.05 a component."""
    jflat, tflat = both_flat(2048)
    n_active = 2048
    if case == "poisoned padding":
        n_active = 1500
        tflat = tflat.clone()
        tflat[:, 1500:] = 1e3
    pos = tflat.numpy()
    got = emulate_mxu(pos, pos, n_active, GC, EPS)
    direct = pairwise.pairwise_accel(tflat.T.contiguous(), tflat, n_active,
                                     GC, EPS).T.numpy()
    plain = pairwise.pairwise_accel_mxu_ref(tflat, tflat, n_active, GC,
                                            EPS).numpy()
    keep = slice(0, n_active)
    bar = 2.0 * np.abs(plain - direct)[:, keep].max()
    assert np.isfinite(got).all()
    assert np.abs(got - plain)[:, keep].max() <= bar
    rel = np.abs(got - direct) / (np.abs(direct) + 1e-2)
    assert rel[:, keep].max() < 0.05
    # f32-grade: well inside the bar, and closer to the direct sum than
    # the plain expanded form
    assert np.abs(got - direct)[:, keep].max() < \
        np.abs(plain - direct)[:, keep].max()
