"""Port all-pairs gravity (ops/pairwise.py, ops/pairwise_cuda.py on CPU
tensors) against the JAX package's jnp oracle and its Pallas kernel in
interpret mode, and against an independent float64 direct sum."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_sim_tpu.core import generate as G
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.core.state import ParticleState as JState
from particle_sim_tpu.ops import pairwise as jpairwise
from particle_sim_tpu.ops import pairwise_pallas, physics as jphysics

from particle_sim_tpu_torch.core.params import PairwiseParams, SimParams
from particle_sim_tpu_torch.core.state import ParticleState
from particle_sim_tpu_torch.ops import pairwise, pairwise_cuda, physics

torch.set_num_threads(1)

GC, EPS = 2.5, 0.5
# the JAX package's kernel-vs-oracle bar (tests/test_pairwise.py): f32
# sums over N sources taken in another order
TOL = dict(rtol=2e-4, atol=1e-5)


def both_flat(n, capacity=None):
    """Filled-sphere positions as (JAX f32[3, cap], torch f32[3, cap],
    n_active) with the same values."""
    pos, _, col = G.generate(n, G.SphereGeneration.FILLED)
    js = JState.from_arrays(pos, np.zeros_like(pos), col, capacity=capacity)
    ts = ParticleState.from_arrays(pos, np.zeros_like(pos), col,
                                   device="cpu", capacity=capacity)
    return js.pos.reshape(3, -1), ts.pos.reshape(3, -1), n


def direct_f64(x_nx3, n_active, g, eps, masses=None):
    """Independent float64 loop over the documented formula."""
    p = x_nx3.astype(np.float64)
    m = np.ones(n_active) if masses is None else masses[:n_active]
    acc = np.zeros_like(p)
    for i in range(p.shape[0]):
        d = p[:n_active] - p[i]
        r2 = (d ** 2).sum(1) + eps * eps
        acc[i] = (g * m[:, None] * d / r2[:, None] ** 1.5).sum(0)
    return acc


def test_pairwise_params_equal():
    assert PairwiseParams() == PairwiseParams(1.0, 0.5)
    for kw in (dict(), dict(gravitational_constant=3.0, softening=0.2)):
        np.testing.assert_array_equal(PairwiseParams(**kw).pack(),
                                      JPairwise(**kw).pack())
        assert PairwiseParams(**kw).pack().dtype == np.float32


@pytest.mark.parametrize("n", [1024, 4096])
def test_plain_matches_jax_oracle(n):
    jflat, tflat, na = both_flat(n)
    expect = np.asarray(jpairwise.pairwise_accel(jflat, na, GC, EPS)).T
    got = pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS).numpy()
    np.testing.assert_allclose(got, expect, **TOL)


@pytest.mark.parametrize("n", [1024, 4096])
def test_plain_matches_pallas_interpret(n):
    jflat, tflat, na = both_flat(n)
    expect = np.asarray(pairwise_pallas.pairwise_accel(
        jflat.T, jflat, na, GC, EPS, tile_i=512, tile_j=1024,
        interpret=True))
    got = pairwise_cuda.pairwise_accel(tflat.T, tflat, na, GC, EPS).numpy()
    np.testing.assert_allclose(got, expect, **TOL)


def test_matches_direct_f64():
    _, tflat, na = both_flat(300)
    got = pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS).numpy()
    expect = direct_f64(tflat.T.numpy(), na, GC, EPS)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def test_poisoned_padding_bit_equal():
    """1500 active in a 2048 capacity: padding poisoned to 1e3 gives the
    same bits on the active range as zero padding."""
    _, tflat, na = both_flat(1500)
    assert tflat.shape[1] == 2048
    poisoned = tflat.clone()
    poisoned[:, na:] = 1e3
    a0 = pairwise_cuda.pairwise_accel(tflat.T, tflat, na, GC, EPS)
    a1 = pairwise_cuda.pairwise_accel(poisoned.T, poisoned, na, GC, EPS)
    assert torch.equal(a0[:na], a1[:na])
    jflat = jnp.asarray(tflat.numpy())
    expect = np.asarray(jpairwise.pairwise_accel(jflat, na, GC, EPS)).T
    np.testing.assert_allclose(a1[:na].numpy(), expect[:na], **TOL)


def test_j_base_halves_sum_to_full():
    """Sources split at j_base = N/2 (the ring's offset): the halves sum
    to the full result, and each half matches the Pallas kernel's."""
    jflat, tflat, na = both_flat(1500)
    half = tflat.shape[1] // 2
    full = pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS)
    parts = []
    for lo, hi in ((0, half), (half, 2 * half)):
        got = pairwise_cuda.pairwise_accel(tflat.T, tflat[:, lo:hi].contiguous(),
                                           na, GC, EPS, j_base=lo)
        expect = np.asarray(pairwise_pallas.pairwise_accel(
            jflat.T, jflat[:, lo:hi], na, GC, EPS, j_base=lo,
            tile_i=512, tile_j=512, interpret=True))
        np.testing.assert_allclose(got.numpy(), expect, **TOL)
        parts.append(got)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(),
                               rtol=2e-4, atol=1e-4)


def test_rectangular_receivers():
    """Ni = 1024 receivers x Nj = 2048 sources against the Pallas kernel."""
    jflat, tflat, na = both_flat(2048)
    got = pairwise_cuda.pairwise_accel(tflat[:, :1024].T, tflat, na, GC, EPS)
    expect = np.asarray(pairwise_pallas.pairwise_accel(
        jflat[:, :1024].T, jflat, na, GC, EPS, tile_i=512, tile_j=1024,
        interpret=True))
    assert got.shape == (1024, 3)
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


def test_unequal_masses():
    """The two-body check of tests/test_masses.py, and random masses
    against the JAX oracle with masses."""
    eps, g, dist = 1.0, 2.0, 20.0
    x = torch.tensor([[0, 0, 0], [dist, 0, 0]], dtype=torch.float32)
    m = torch.tensor([1000.0, 1.0])
    a = pairwise.pairwise_accel(x, x.T.contiguous(), 2, g, eps, masses=m)
    denom = (dist * dist + eps * eps) ** 1.5
    assert float(a[1, 0]) == pytest.approx(-g * 1000.0 * dist / denom,
                                           rel=1e-4)
    assert float(a[0, 0]) == pytest.approx(g * 1.0 * dist / denom, rel=1e-4)

    rng = np.random.default_rng(0)
    xs = (40 * rng.random((1024, 3)) - 20).astype(np.float32)
    ms = (0.1 + 5 * rng.random(1024)).astype(np.float32)
    expect = np.asarray(jpairwise.pairwise_accel(
        jnp.asarray(xs.T), 1024, 1.0, 0.5, masses=jnp.asarray(ms))).T
    tx = torch.from_numpy(xs)
    got = pairwise_cuda.pairwise_accel(tx, tx.T.contiguous(), 1024, 1.0, 0.5,
                                       masses=torch.from_numpy(ms))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    np.testing.assert_allclose(got.numpy(), direct_f64(xs, 1024, 1.0, 0.5, ms),
                               rtol=1e-3, atol=1e-4)


def test_momentum_conserved():
    """Equal masses: the internal forces sum to zero."""
    _, tflat, na = both_flat(500)
    acc = pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS)[:na]
    total = acc.sum(0).abs()
    scale = acc.abs().sum()
    assert (total / scale < 1e-5).all()


def test_chunked_sum_equals_one_chunk(monkeypatch):
    """The receiver chunking changes nothing: each row's sum is the same
    operation whatever chunk it lands in."""
    _, tflat, na = both_flat(1000)
    whole = pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS)
    monkeypatch.setattr(pairwise, "CHUNK_PAIRS", 100 * tflat.shape[1])
    assert torch.equal(pairwise.pairwise_accel(tflat.T, tflat, na, GC, EPS),
                       whole)


def test_kick_and_step_planes_matches_jax():
    rng = np.random.default_rng(4)
    pos, vel, acc = (rng.normal(size=(3, 8, 128)).astype(np.float32) * s
                     for s in (30.0, 3.0, 5.0))
    kw = dict(gravity=0.7, is_mouse_dragging=True,
              mouse_position=(3.0, -7.0, 20.0), mouse_force=80.0,
              mouse_radius=30.0)
    jp, jv = jphysics.kick_and_step_planes(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc),
        jnp.asarray(JSimParams(**kw).pack()))
    tp, tv = physics.kick_and_step_planes(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(acc),
        torch.from_numpy(SimParams(**kw).pack()))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("masses", [False, True])
def test_step_pairwise_matches_jax_step(masses):
    """Five direct-sum steps with the attractor on, both packages."""
    n = 1500
    pos, _, col = G.generate(n, G.SphereGeneration.FILLED)
    vel = np.random.default_rng(2).normal(size=pos.shape).astype(np.float32)
    js = JState.from_arrays(pos, vel, col)
    ts = ParticleState.from_arrays(pos, vel, col, device="cpu")
    m = np.ones(js.capacity, np.float32)
    m[0] = 50.0
    jm = jnp.asarray(m) if masses else None
    tm = torch.from_numpy(m) if masses else None
    kw = dict(gravity=0.3, is_mouse_dragging=True, mouse_position=(0, 0, 10),
              mouse_force=20.0)
    jpv, jpp = jnp.asarray(JSimParams(**kw).pack()), jnp.asarray(
        JPairwise(GC, EPS).pack())
    tpv, tpp = torch.from_numpy(SimParams(**kw).pack()), torch.from_numpy(
        PairwiseParams(GC, EPS).pack())
    jp, jv = js.pos, js.vel
    tp, tv = ts.pos, ts.vel
    for _ in range(5):
        jp, jv = jpairwise.step_pairwise(jp, jv, jpv, jpp, js.n_active,
                                         masses=jm)
        tp, tv = pairwise.step_pairwise(tp, tv, tpv, tpp, ts.n_active,
                                        masses=tm)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)


def test_step_pairwise_cuda_on_cpu_is_plain_in_place():
    _, tflat, na = both_flat(1024)
    pos = tflat.reshape(3, 8, 128).clone()
    vel = torch.zeros_like(pos)
    pv = torch.from_numpy(SimParams(gravity=0.5).pack())
    pp = torch.from_numpy(PairwiseParams(GC, EPS).pack())
    n_active = torch.tensor(na, dtype=torch.int32)
    ep, ev = pairwise.step_pairwise(pos, vel, pv, pp, n_active)
    launches = pairwise_cuda.LAUNCHES
    rp, rv = pairwise_cuda.step_pairwise(pos, vel, pv, pp, n_active)
    assert rp is pos and rv is vel
    assert torch.equal(pos, ep) and torch.equal(vel, ev)
    assert pairwise_cuda.LAUNCHES == launches   # CPU: no kernel launch


# -- pmx's difference pass and the live counts ----------------------------------
EPS_B = 2.0


@pytest.mark.parametrize("n,with_masses", [(1024, False), (2048, True)])
def test_diff_matches_pallas_interpret_twice(n, with_masses):
    """pairwise_accel_diff (plain, and the wrapper on CPU tensors) against
    JAX's Pallas kernel in interpret mode at the two softenings,
    subtracted; the plain-vs-Pallas bar (TOL)."""
    jflat, tflat, na = both_flat(n)
    m = (0.5 + np.random.default_rng(n).random(n)).astype(np.float32)
    jm = jnp.asarray(m) if with_masses else None
    tm = torch.from_numpy(m) if with_masses else None
    kw = dict(tile_i=512, tile_j=1024, interpret=True, masses=jm)
    expect = (np.asarray(pairwise_pallas.pairwise_accel(
        jflat.T, jflat, na, GC, EPS, **kw)) - np.asarray(
        pairwise_pallas.pairwise_accel(jflat.T, jflat, na, GC, EPS_B, **kw)))
    plain = pairwise.pairwise_accel_diff(tflat.T, tflat, na, GC, EPS, EPS_B,
                                         masses=tm)
    np.testing.assert_allclose(plain.numpy(), expect, **TOL)
    launches = pairwise_cuda.DIFF_LAUNCHES
    wrapped = pairwise_cuda.pairwise_accel_diff(tflat.T, tflat, na, GC, EPS,
                                                EPS_B, masses=tm)
    assert pairwise_cuda.DIFF_LAUNCHES == launches   # CPU: no kernel launch
    assert torch.equal(wrapped, plain)
    assert torch.equal(plain, pairwise.pairwise_accel(
        tflat.T, tflat, na, GC, EPS, masses=tm) - pairwise.pairwise_accel(
        tflat.T, tflat, na, GC, EPS_B, masses=tm))


def poisoned_inputs(n=1500, n_i=1100, n_j=900):
    """(receivers f32[n, 3], sources f32[3, n], masses) of the filled
    sphere and the same with NaN in the receivers past n_i and in the
    sources and masses past n_j."""
    _, tflat, _ = both_flat(n)
    x = tflat[:, :n].contiguous()
    m = torch.from_numpy((0.5 + np.random.default_rng(3).random(n)).astype(
        np.float32))
    rec, src, ms = x.T.contiguous(), x.clone(), m.clone()
    rec[n_i:] = float("nan")
    src[:, n_j:] = float("nan")
    ms[n_j:] = float("nan")
    return (x.T.contiguous(), x, m), (rec, src, ms)


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_live_counts_cut_receivers_and_sources(diff, as_tensor):
    """Receivers at or past n_i get exactly 0; sources at or past n_j
    change nothing, NaN there included (bit for bit against a finite
    tail), and the live part equals the sum over the live prefix."""
    n, n_i, n_j = 1500, 1100, 900
    (rec, src, m), (rec_p, src_p, m_p) = poisoned_inputs(n, n_i, n_j)
    cnt = ((torch.tensor(n_i, dtype=torch.int32),
            torch.tensor([n_j], dtype=torch.int32)) if as_tensor
           else (n_i, n_j))

    def run(fn, r, s, mm, **kw):
        if diff:
            return fn(r, s, n, GC, EPS, EPS_B, masses=mm, **kw)
        return fn(r, s, n, GC, EPS, masses=mm, **kw)

    fns = ((pairwise_cuda.pairwise_accel_diff, pairwise.pairwise_accel_diff)
           if diff else (pairwise_cuda.pairwise_accel, pairwise.pairwise_accel))
    for fn in fns:
        got = run(fn, rec_p, src_p, m_p, n_i=cnt[0], n_j=cnt[1])
        assert got.shape == (n, 3) and bool(torch.isfinite(got).all())
        assert bool((got[n_i:] == 0).all())
        assert torch.equal(got, run(fn, rec, src, m, n_i=cnt[0],
                                    n_j=cnt[1]))
        prefix = run(fn, rec[:n_i], src[:, :n_j].contiguous(), m[:n_j])
        np.testing.assert_allclose(got[:n_i].numpy(), prefix.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("diff", [False, True])
def test_live_count_defaults_are_bit_for_bit(diff):
    """No counts, None, and counts equal to the shapes (ints or int32
    tensors) give the same bits as the call without them; a count past
    the shape is clamped to it."""
    jflat, tflat, na = both_flat(1500)
    x = tflat
    n_i, n_j = x.shape[1], x.shape[1]
    fn = pairwise_cuda.pairwise_accel_diff if diff else (
        pairwise_cuda.pairwise_accel)
    args = (x.T, x, na, GC, EPS) + ((EPS_B,) if diff else ())
    base = fn(*args)
    for kw in (dict(n_i=None, n_j=None), dict(n_i=n_i, n_j=n_j),
               dict(n_i=torch.tensor(n_i, dtype=torch.int32),
                    n_j=torch.tensor(n_j, dtype=torch.int32))):
        assert torch.equal(fn(*args, **kw), base)
    if not diff:
        # today's result: the JAX kernel's bar, unchanged
        expect = np.asarray(pairwise_pallas.pairwise_accel(
            jflat.T, jflat, na, GC, EPS, tile_i=512, tile_j=1024,
            interpret=True))
        np.testing.assert_allclose(base.numpy(), expect, **TOL)


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("which", ["n_i", "n_j"])
@pytest.mark.parametrize("bad", ["int64", "float32", "meta", "two", "str"])
def test_live_count_checks(diff, which, bad):
    """A count of the wrong dtype, on another device than the receivers,
    of more than one element or not a count at all raises."""
    x = torch.zeros((64, 3))
    s = torch.zeros((3, 64))
    count = {"int64": torch.tensor(5), "float32": torch.tensor(5.0),
             "meta": torch.tensor(5, dtype=torch.int32, device="meta"),
             "two": torch.tensor([5, 6], dtype=torch.int32),
             "str": "5"}[bad]
    fn = pairwise_cuda.pairwise_accel_diff if diff else (
        pairwise_cuda.pairwise_accel)
    args = (x, s, 64, 1.0, 0.5) + ((2.0,) if diff else ())
    with pytest.raises((TypeError, ValueError)):
        fn(*args, **{which: count})


@pytest.mark.parametrize("n_i,n_j,want", [
    (65_536, 65_536, 17),     # 128 blocks of 512: split to ~16 an SM
    (40_001, 30_011, 27),
    (1_000, 777, 4),          # at most one slice a 256-source tile
    (1_000, 100_000, 32),     # at most MAX_SLICES
    (1 << 20, 1 << 20, 2),    # 2,048 blocks: just short of 16 an SM
    (1 << 21, 4_096, 1),      # 4,096 blocks fill 132 SMs alone
    (0, 1_000, 1)])
def test_source_slices(n_i, n_j, want):
    """The source split from the host shapes and the SM count (132, the
    H100's): whole slices, the same every call."""
    assert pairwise_cuda.source_slices(n_i, n_j, 132) == want
    assert pairwise_cuda._split(n_i, n_j, 132, 4, 512, 256) <= want


def test_block_shape_matches_kernel():
    """The wrapper's receivers a block and sources a tile are the kernel's
    defaults (csrc/pairwise.cu's PW_THREADS * PW_R and PW_TJ)."""
    src = (Path(pairwise_cuda.__file__).parents[1] / "csrc"
           / "pairwise.cu").read_text()
    knob = {k: int(v) for k, v in re.findall(
        r"^#define (PW_R|PW_THREADS|PW_TJ) (\d+)", src, re.M)}
    assert len(knob) == 3
    assert pairwise_cuda.RECEIVERS_PER_BLOCK == (knob["PW_THREADS"]
                                                 * knob["PW_R"])
    assert pairwise_cuda.SOURCE_TILE == knob["PW_TJ"]


@pytest.mark.parametrize("n_active", [5000, 4096, 100, 0])
def test_ring_hop_counts(n_active):
    """The ring's live source count a hop, clamp(n_active - j_base, 0,
    local_n), from a host int and from an int32 tensor alike."""
    from particle_sim_tpu_torch.parallel import ring

    for base in (0, 2048, 4096, 6144):
        want = min(max(n_active - base, 0), 2048)
        assert ring.live_in_shard(n_active, base, 2048) == want
        got = ring.live_in_shard(torch.tensor(n_active, dtype=torch.int32),
                                 base, 2048)
        assert got.dtype == torch.int32 and int(got) == want


@pytest.mark.parametrize("case", [
    "x_nx3_shape", "x_3xn_shape", "dtype", "masses_shape", "device_mix",
    "not_tensor"])
def test_pairwise_cuda_rejects_bad_input(case):
    x = torch.zeros((64, 3))
    s = torch.zeros((3, 64))
    kw = {}
    if case == "x_nx3_shape":
        x = torch.zeros((64, 4))
    elif case == "x_3xn_shape":
        s = torch.zeros((4, 64))
    elif case == "dtype":
        x = x.double()
    elif case == "masses_shape":
        kw["masses"] = torch.ones(63)
    elif case == "device_mix":
        s = s.to("meta")
    elif case == "not_tensor":
        x = np.zeros((64, 3), np.float32)
    with pytest.raises((ValueError, TypeError)):
        pairwise_cuda.pairwise_accel(x, s, 64, 1.0, 0.5, **kw)


# -- the kernel build (no nvcc here: a stand-in records the commands) ------------
FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
case " $* " in *" -c "*) [ -n "{fail}" ] && exit 3;; esac
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
: > "$out"
echo "ptxas info    : Used 32 registers"
"""


@pytest.mark.parametrize("fail", [False, True])
def test_cuda_build_one_nvcc_per_source(tmp_path, monkeypatch, fail):
    """One compile per csrc/*.cu, then one link into the hashed library;
    a failed compile raises and leaves no object behind."""
    from particle_sim_tpu_torch.utils import cuda_build

    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, fail="x" if fail else ""))
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    assert {s.name for s in sources} >= {"pairwise.cu", "raster_sorted.cu"}
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            cuda_build.build()
        assert list((tmp_path / "build").iterdir()) == []
        return
    path, _ = cuda_build.build()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    links = [c for c in calls if "-shared" in c.split()]
    assert len(compiles) == len(sources) and len(links) == 1
    assert path.exists() and path == cuda_build.library_path()
    assert "registers" in path.with_suffix(".log").read_text()
    assert cuda_build.build() == (path, 0.0)      # built once
