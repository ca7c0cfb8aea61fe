"""Merge sort of 1-D 32-bit keys with 32-bit payloads on hand-written CUDA
kernels (csrc/psort.cu), and its plain PyTorch version.

Counterpart of ``particle_sim_tpu/ops/psort.py``: :func:`sort` is a
drop-in for ``lax.sort(operands, num_keys=1)`` on 1-D uint32/int32 keys
with up to three 32-bit payloads (any 4-byte dtype, moved as raw words).
Anything else (``num_keys != 1``, keys of another dtype, ``ndim != 1``,
payloads that are not 4-byte or not the keys' length, more than three
payloads) goes to ``torch.sort``, exactly where the JAX function goes to
``lax.sort``, and counts in :data:`LIBRARY_CALLS`. As in the JAX package,
nothing on a main path calls it (the PM path is sort-free, the sorted
renderer calls ``torch.sort``).

The sort is two layers, each a kernel with its plain version here:
:func:`block_sort` (:func:`block_sort_ref`) sorts every SEG-element
block; :func:`merge_round` (:func:`merge_round_ref`) merges sorted runs
of length L pairwise into runs of 2L. :func:`sort` chains one block sort
and ceil(log2(n / SEG)) rounds; :func:`sort_ref` chains the plain ones.

Keys are compared through an order-preserving map onto unsigned 32-bit
values: int32 keys with the sign bit flipped, uint32 keys as they are
(``ordered_key``; PyTorch's CPU ``uint32`` has no ``<``, ``flip`` or
``searchsorted``, so the plain version carries the map in int64).

Intended differences from the JAX function: every length n >= 1 takes the
kernels (its SEG-multiple and power-of-two limits were the TPU tiling's),
so ``pad_to_pow2`` is accepted and does nothing; SEG is 2,048 (one block
sorts one tile in shared memory), not 32,768. The contract does not
promise stability, as in JAX; this implementation is stable (equal keys
keep their input order: the block sort breaks ties by position, the merge
takes the earlier run first), and the plain and kernel versions give the
same words bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils import cuda_build

#: Elements a block sorts, and each merge block's output tile
#: (csrc/psort.cu PS_SEG).
SEG = 2048
#: Payload words the kernels carry beside the key.
MAX_PAYLOADS = 3
#: Kernel launches made by :func:`block_sort` in this process.
BLOCK_LAUNCHES = 0
#: Kernel launches made by :func:`merge_round` in this process.
MERGE_LAUNCHES = 0
#: Calls of :func:`sort` that went to ``torch.sort`` (outside the contract).
LIBRARY_CALLS = 0

_U32 = 0xFFFFFFFF
_KEY_DTYPES = (torch.uint32, torch.int32)


def can_fast_sort(n: int) -> bool:
    """True where :func:`sort` takes the kernels for 1-D keys of length n
    (in the contract): every n >= 1 here; on the TPU only power-of-two
    multiples of its 32,768-element SEG."""
    return n >= 1


def _flip(dtype) -> int:
    return 1 << 31 if dtype == torch.int32 else 0


def ordered_key(key: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) with the order of the uint32/int32 ``key``."""
    return (key.view(torch.int32).to(torch.int64) & _U32) ^ _flip(key.dtype)


def _take(o: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``o`` gathered at ``idx`` along the last axis; 32-bit words move as
    int32 (PyTorch's CPU uint32 has no gather)."""
    if o.element_size() == 4:
        return torch.take_along_dim(o.view(torch.int32), idx, -1).view(o.dtype)
    return torch.take_along_dim(o, idx, -1)


def _bitonic_rows(v: torch.Tensor) -> torch.Tensor:
    """Ascending bitonic sort of each row of ``v`` (R, B), B a power of
    two, with the compare-exchange network of csrc/psort.cu's block sort.
    The words must be unique (they are: key << 16 | position)."""
    rows, width = v.shape
    size = 2
    while size <= width:
        stride = size // 2
        while stride >= 1:
            w = v.view(rows, width // (2 * stride), 2, stride)
            lo, hi = w[:, :, 0, :], w[:, :, 1, :]
            first = torch.arange(width // (2 * stride),
                                 device=v.device) * (2 * stride)
            up = ((first & size) == 0)[None, :, None]
            swap = (lo > hi) == up
            v = torch.stack([torch.where(swap, hi, lo),
                             torch.where(swap, lo, hi)], 2).view(rows, width)
            stride //= 2
        size *= 2
    return v


def block_sort_ref(operands: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the block-sort kernel: each SEG-element block of
    the key (and its payloads) sorted ascending; ties keep their order."""
    key = operands[0]
    n = key.shape[0]
    dev = key.device
    blocks = -(-n // SEG)
    pos = torch.arange(blocks * SEG, device=dev) % SEG
    u = torch.full((blocks * SEG,), _U32, dtype=torch.int64, device=dev)
    u[:n] = ordered_key(key)   # padding: key max, positions past the real
    v = _bitonic_rows(((u << 16) | pos).view(blocks, SEG)).reshape(-1)[:n]
    src = (v & 0xFFFF) + torch.arange(n, device=dev) // SEG * SEG
    return tuple(_take(o, src) for o in operands)


def merge_round_ref(operands: Sequence[torch.Tensor],
                    run: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of the merge-round kernel: the sorted runs
    [2pL, 2pL + L) and [2pL + L, 2pL + 2L) (L = ``run``; the last may be
    short or missing) merged into [2pL, 2pL + 2L), ties taking the
    earlier run first. Each element's output rank in its pair comes from
    ``torch.searchsorted`` on the mapped keys: an A element at i lands at
    i + #(B < it), a B element at j at j + #(A <= it)."""
    key = operands[0]
    n = key.shape[0]
    dev = key.device
    pairs = -(-n // (2 * run))
    u = torch.full((pairs * 2 * run,), 1 << 32, dtype=torch.int64,
                   device=dev)            # padding: after every real key
    u[:n] = ordered_key(key)
    ab = u.view(pairs, 2, run)
    a, b = ab[:, 0].contiguous(), ab[:, 1].contiguous()
    i = torch.arange(run, device=dev)
    rank_a = i + torch.searchsorted(b, a, right=False)
    rank_b = i + torch.searchsorted(a, b, right=True)
    base = (torch.arange(pairs, device=dev) * (2 * run))[:, None]
    dest = torch.stack([rank_a + base, rank_b + base], 1).reshape(-1)
    src = torch.empty_like(dest)
    src[dest] = torch.arange(dest.shape[0], device=dev)
    src = src[:n]                          # real elements rank first
    return tuple(_take(o, src) for o in operands)


def _launch(fn: str, operands: Sequence[torch.Tensor], *extra) -> Tuple:
    """Run one csrc/psort.cu kernel on CUDA operands -> new outputs."""
    key, *payloads = operands
    outs = [torch.empty_like(o) for o in operands]
    ptrs_in = [o.data_ptr() for o in operands[1:]]
    ptrs_out = [o.data_ptr() for o in outs[1:]]
    ptrs_in += [None] * (MAX_PAYLOADS - len(ptrs_in))
    ptrs_out += [None] * (MAX_PAYLOADS - len(ptrs_out))
    lib = cuda_build.library()
    dev = key.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    flip = -(1 << 31) if key.dtype == torch.int32 else 0
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(key.data_ptr(), *ptrs_in, outs[0].data_ptr(),
                               *ptrs_out, key.shape[0], *extra,
                               len(payloads), flip, stream)
    cuda_build.check(err, fn)
    return tuple(outs)


def _check(operands: Sequence[torch.Tensor]) -> None:
    key = operands[0]
    if not _in_contract(operands):
        raise ValueError("block_sort / merge_round take 1-D uint32/int32 "
                         f"keys and up to {MAX_PAYLOADS} 32-bit payloads "
                         "of the same length on one device")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {key.device}")


def _in_contract(operands: Sequence[torch.Tensor]) -> bool:
    key = operands[0]
    return (key.ndim == 1 and key.dtype in _KEY_DTYPES
            and len(operands) <= 1 + MAX_PAYLOADS
            and key.shape[0] <= 2 ** 31 - SEG   # int32 tile counts
            and all(o.ndim == 1 and o.element_size() == 4
                    and o.shape == key.shape and o.device == key.device
                    for o in operands))


def block_sort(operands: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Each SEG-element block sorted (see :func:`block_sort_ref`): the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    global BLOCK_LAUNCHES
    operands = tuple(o.contiguous() for o in operands)
    _check(operands)
    if operands[0].device.type == "cpu":
        return block_sort_ref(operands)
    out = _launch("psim_block_sort", operands)
    BLOCK_LAUNCHES += 1
    return out


def merge_round(operands: Sequence[torch.Tensor],
                run: int) -> Tuple[torch.Tensor, ...]:
    """Sorted runs of length ``run`` (a multiple of SEG) merged pairwise
    (see :func:`merge_round_ref`): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    global MERGE_LAUNCHES
    operands = tuple(o.contiguous() for o in operands)
    _check(operands)
    if run <= 0 or run % SEG:
        raise ValueError(f"run {run} is not a positive multiple of {SEG}")
    if operands[0].device.type == "cpu":
        return merge_round_ref(operands, run)
    out = _launch("psim_merge_round", operands, run)
    MERGE_LAUNCHES += 1
    return out


def _chain(operands, block_fn, merge_fn) -> Tuple[torch.Tensor, ...]:
    n = operands[0].shape[0]
    if n == 0:
        return tuple(o.clone() for o in operands)
    out = block_fn(operands)
    run = SEG
    while run < n:
        out = merge_fn(out, run)
        run *= 2
    return out


def sort_ref(operands: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The plain sort: :func:`block_sort_ref`, then the merge rounds."""
    return _chain(tuple(operands), block_sort_ref, merge_round_ref)


def _library_sort(operands: Sequence[torch.Tensor],
                  num_keys: int) -> Tuple[torch.Tensor, ...]:
    """``lax.sort`` on ``torch.sort``: lexicographic on the first
    ``num_keys`` operands along the last axis (stable sorts, last key
    first)."""
    perm = None
    for k in reversed(range(num_keys)):
        key = operands[k] if perm is None else _take(operands[k], perm)
        if key.dtype == torch.uint32:   # CUDA's sort has no uint32
            key = ordered_key(key)
        order = torch.sort(key, dim=-1, stable=True).indices
        perm = order if perm is None else torch.take_along_dim(perm, order,
                                                               -1)
    if perm is None:
        return tuple(o.clone() for o in operands)
    return tuple(_take(o, perm) for o in operands)


def sort(operands, num_keys: int = 1, *,
         pad_to_pow2: bool = False) -> Tuple[torch.Tensor, ...]:
    """Drop-in for ``lax.sort(operands, num_keys=num_keys)``: 1-D
    uint32/int32 keys with up to three 32-bit payloads go through the
    kernels (CUDA tensors) or their plain versions (CPU tensors), at any
    length; anything else goes to ``torch.sort`` (counted in
    LIBRARY_CALLS). ``pad_to_pow2`` is accepted for the JAX signature and
    does nothing: every length already takes the kernels."""
    global LIBRARY_CALLS
    del pad_to_pow2
    operands = tuple(operands)
    if num_keys != 1 or not _in_contract(operands):
        LIBRARY_CALLS += 1
        return _library_sort(operands, num_keys)
    return _chain(operands, block_sort, merge_round)
