"""The port's sort (ops/psort.py) on CPU tensors, where psort.sort runs
the radix sort's plain version and the merge sort its plain versions (the
bitonic block sort and the searchsorted merge round), against the JAX
package's psort.sort (Pallas kernels in interpret mode), jax.lax.sort and
numpy.

The JAX comparison follows tests/test_psort.py: the sorted keys exactly,
and the full output exactly for unique keys or the (key, payload)
multiset otherwise (the JAX fast path is not stable). The port's sort is
stable, so against numpy's stable argsort every word must match exactly.
The interpret-mode calls share one shape (131,072 x 2 words; the padded
lengths pad to it), so the Pallas kernels compile once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_sim_tpu.ops import psort as jpsort

from particle_sim_tpu_torch.ops import psort

torch.set_num_threads(1)

U32_MAX = 0xFFFFFFFF


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def stable_numpy(ops):
    """Every word sorted by the key, equal keys in input order."""
    order = np.argsort(ops[0], kind="stable")
    return [o[order] for o in ops]


def assert_words_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.view(np.uint32),
                                      np.asarray(w).view(np.uint32))


def assert_like_jax(got, want):
    """tests/test_psort.py's comparison: keys exactly; the words exactly
    for unique keys, else the (key, payload...) row multisets."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    if len(np.unique(want[0])) == len(want[0]):
        assert_words_equal(got, want)
        return
    g_rows = np.stack([g.view(np.uint32) for g in got])
    w_rows = np.stack([w.view(np.uint32) for w in want])
    np.testing.assert_array_equal(g_rows[:, np.lexsort(g_rows[::-1])],
                                  w_rows[:, np.lexsort(w_rows[::-1])])


def make_keys(kind, n, rng):
    if kind == "unique":
        return rng.permutation(n).astype(np.uint32)
    if kind == "sentinel_tail":       # PM-style: real keys, then key max
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
    raise ValueError(kind)


# -- against the JAX package's psort.sort (interpret mode) --------------------
@pytest.mark.parametrize("kind,n", [
    ("unique", 131072), ("sentinel_tail", 131072), ("unique", 98304),
    ("unique", 80000)])
def test_matches_jax_psort_interpret(kind, n):
    rng = np.random.default_rng(4)
    key = make_keys(kind, n, rng)
    p = np.arange(n, dtype=np.int32)
    want = jpsort.sort((jnp.asarray(key), jnp.asarray(p)), interpret=True,
                       pad_to_pow2=True)
    launches = (psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES)
    got = psort.sort((t(key), t(p)), pad_to_pow2=True)
    assert (psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES) == launches
    assert got[0].dtype == torch.uint32
    assert_like_jax(got, want)
    assert_words_equal(got, stable_numpy([key, p]))


# -- against lax.sort and numpy -----------------------------------------------
@pytest.mark.parametrize("kind", [
    "duplicates", "all_equal", "sorted", "reversed", "clustered",
    "sentinel_tail"])
def test_adversarial_distributions_match_lax_sort(kind):
    rng = np.random.default_rng(2)
    n = 131072
    key = make_keys(kind, n, rng)
    p = np.arange(n, dtype=np.int32)
    got = psort.sort((t(key), t(p)))
    want = jax.lax.sort((jnp.asarray(key), jnp.asarray(p)), num_keys=1)
    assert_like_jax(got, want)
    assert_words_equal(got, stable_numpy([key, p]))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("words", [1, 2, 3, 4])
def test_words_and_key_types(dtype, words):
    """u32 and i32 keys with 0-3 payloads of int32, uint32 and float32,
    across both extremes of the key range."""
    rng = np.random.default_rng(10 + words)
    n = 5000
    info = np.iinfo(dtype)
    key = rng.integers(info.min, info.max, n, dtype=np.int64,
                       endpoint=True).astype(dtype)
    key[::97] = info.max
    key[5::101] = info.min
    pays = [np.arange(n, dtype=np.int32),
            rng.integers(0, U32_MAX, n, dtype=np.uint32),
            rng.standard_normal(n).astype(np.float32)][:words - 1]
    got = psort.sort([t(key)] + [t(p) for p in pays])
    assert_words_equal(got, stable_numpy([key] + pays))
    want = jax.lax.sort([jnp.asarray(key)] + [jnp.asarray(p) for p in pays],
                        num_keys=1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("n", [1, 5, 1000, 2047, 2048, 2049, 32768, 80000,
                               98304])
def test_any_length(n):
    """Every length takes the block sort and merge rounds (no padding to a
    power of two, no length floor), including the JAX test's fallback and
    padded lengths."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, 1 << 12, n).astype(np.uint32)   # many ties
    p = rng.standard_normal(n).astype(np.float32)
    calls = psort.LIBRARY_CALLS
    got = psort.sort((t(key), t(p)))
    assert psort.LIBRARY_CALLS == calls
    assert psort.can_fast_sort(n)
    assert_words_equal(got, stable_numpy([key, p]))


def test_u32_keys_at_and_above_2_31():
    rng = np.random.default_rng(7)
    n = 20000
    key = rng.integers(1 << 31, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32)
    key[rng.random(n) < 0.05] = U32_MAX
    key[:10] = (1 << 31) - 1            # just below the sign bit
    p = np.arange(n, dtype=np.int32)
    got = psort.sort((t(key), t(p)))
    assert_words_equal(got, stable_numpy([key, p]))
    assert int(psort.ordered_key(got[0])[-1]) == U32_MAX


def test_ordered_key_preserves_order():
    u = np.array([0, 1, (1 << 31) - 1, 1 << 31, U32_MAX - 1, U32_MAX],
                 np.uint32)
    i = np.array([-(1 << 31), -2, -1, 0, 1, (1 << 31) - 1], np.int32)
    for keys in (u, i):
        m = psort.ordered_key(t(keys)).numpy()
        assert m.dtype == np.int64
        assert (np.diff(m) > 0).all() and m.min() >= 0 and m.max() <= U32_MAX
    assert psort.ordered_key(t(u)).tolist() == u.astype(np.int64).tolist()


# -- each kernel's plain version alone, against numpy -------------------------
@pytest.mark.parametrize("n", [2048, 6000, 2 * psort.SEG + 1])
def test_block_sort_ref_sorts_each_block(n):
    rng = np.random.default_rng(n)
    key = rng.integers(-50, 50, n).astype(np.int32)
    p = np.arange(n, dtype=np.int32)
    got = psort.block_sort_ref((t(key), t(p)))
    for b in range(0, n, psort.SEG):
        want = stable_numpy([key[b:b + psort.SEG], p[b:b + psort.SEG]])
        assert_words_equal([g[b:b + psort.SEG] for g in got], want)
    launches = psort.BLOCK_LAUNCHES
    wrapped = psort.block_sort((t(key), t(p)))   # CPU: the plain version
    assert psort.BLOCK_LAUNCHES == launches
    assert_words_equal(wrapped, [g.numpy() for g in got])


@pytest.mark.parametrize("n,run", [(4096, 2048), (5000, 2048),
                                   (3000, 2048), (8192, 4096),
                                   (20000, 4096), (7, 3)])
def test_merge_round_ref_merges_run_pairs(n, run):
    """Sorted runs of length ``run`` merged pairwise, the last pair short
    or alone; ties take the earlier run first."""
    rng = np.random.default_rng(n + run)
    key = rng.integers(0, 30, n).astype(np.uint32)
    p = np.arange(n, dtype=np.int32)
    for b in range(0, n, run):            # sorted runs
        order = np.argsort(key[b:b + run], kind="stable")
        key[b:b + run] = key[b:b + run][order]
        p[b:b + run] = p[b:b + run][order]
    got = psort.merge_round_ref((t(key), t(p)), run)
    for b in range(0, n, 2 * run):
        want = stable_numpy([key[b:b + 2 * run], p[b:b + 2 * run]])
        assert_words_equal([g[b:b + 2 * run] for g in got], want)
    if run % psort.SEG == 0:
        launches = psort.MERGE_LAUNCHES
        wrapped = psort.merge_round((t(key), t(p)), run)
        assert psort.MERGE_LAUNCHES == launches
        assert_words_equal(wrapped, [g.numpy() for g in got])


def test_merge_round_needs_a_seg_multiple():
    key = t(np.arange(10, dtype=np.int32))
    with pytest.raises(ValueError, match="multiple"):
        psort.merge_round((key,), 3)


def test_sort_ref_equals_sort_on_cpu():
    """psort.sort (the radix sort's plain version on the CPU) and the
    earlier design's plain chain give the same words."""
    rng = np.random.default_rng(8)
    ops = (t(rng.integers(0, 100, 9000).astype(np.int32)),
           t(rng.standard_normal(9000).astype(np.float32)))
    assert_words_equal(psort.sort(ops), [o.numpy() for o in
                                         psort.merge_sort_ref(ops)])


# -- outside the contract: the torch.sort route, counted ----------------------
@pytest.mark.parametrize("case", ["num_keys_2", "f64_payload", "two_d",
                                  "four_payloads", "f32_key"])
def test_torch_sort_route(case):
    rng = np.random.default_rng(9)
    n = 3000
    k1 = rng.integers(0, 8, n).astype(np.uint32)
    k2 = rng.integers(0, 8, n).astype(np.uint32)
    num_keys = 1
    if case == "num_keys_2":
        ops = [k1, k2, np.arange(n, dtype=np.int32)]
        num_keys = 2
    elif case == "f64_payload":
        ops = [k1, rng.standard_normal(n)]
    elif case == "two_d":
        ops = [k1.reshape(3, -1), k2.reshape(3, -1)]
    elif case == "four_payloads":
        ops = [k1] + [np.arange(n, dtype=np.int32) + i for i in range(4)]
    else:
        ops = [rng.standard_normal(n).astype(np.float32),
               np.arange(n, dtype=np.int32)]
    calls = psort.LIBRARY_CALLS
    launches = (psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES)
    got = psort.sort([t(o) for o in ops], num_keys=num_keys)
    assert psort.LIBRARY_CALLS == calls + 1
    assert (psort.BLOCK_LAUNCHES, psort.MERGE_LAUNCHES) == launches
    # lexicographic on the first num_keys operands along the last axis,
    # equal keys in input order
    if case == "two_d":
        order = np.argsort(ops[0], axis=-1, kind="stable")
        want = [np.take_along_axis(o, order, -1) for o in ops]
    else:
        order = np.lexsort(ops[:num_keys][::-1])
        want = [o[order] for o in ops]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    keys = jax.lax.sort([jnp.asarray(o) for o in ops],
                        num_keys=num_keys)[:num_keys]
    for g, k in zip(got, keys):
        np.testing.assert_array_equal(g.numpy(), np.asarray(k))
