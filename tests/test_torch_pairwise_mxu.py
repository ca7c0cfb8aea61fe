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
from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda

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
