"""Sort of 1-D 32-bit keys with 32-bit payloads on hand-written CUDA kernels
(a radix sort, csrc/radix_sort.cu; a merge sort, csrc/psort.cu), and their
plain PyTorch versions.

Counterpart of ``particle_sim_tpu/ops/psort.py``: :func:`sort` is a
drop-in for ``lax.sort(operands, num_keys=1)`` on 1-D uint32/int32 keys
with up to three 32-bit payloads (any 4-byte dtype, moved as raw words).
Anything else (``num_keys != 1``, keys of another dtype, ``ndim != 1``,
payloads that are not 4-byte or not the keys' length, more than three
payloads) goes to ``torch.sort``, exactly where the JAX function goes to
``lax.sort``, and counts in :data:`LIBRARY_CALLS`. The sorted renderer
sorts its tile keys and colours with it (render/raster_sorted.py).

:func:`sort` is an LSD radix sort of RADIX_BITS-bit digits, each layer a
kernel with its plain version here: :func:`radix_histogram` counts every
digit value of every digit in one read of the keys (plain:
:func:`radix_plan_ref`, the digits that are not constant); a pass
(:func:`radix_pass`; plain: :func:`radix_pass_ref`) reorders every word
stably by one digit. A digit that is the same in every key is skipped, on
the device. On CPU tensors :func:`sort` runs :func:`radix_sort_ref`.

The earlier design stays beside it, with its own kernels and plain
versions: :func:`merge_sort` chains :func:`block_sort`
(:func:`block_sort_ref`), which sorts every SEG-element block, and
ceil(log2(n / SEG)) rounds of :func:`merge_round`
(:func:`merge_round_ref`), which merge sorted runs of length L pairwise
into runs of 2L; :func:`merge_sort_ref` chains the plain ones.

Keys are compared through an order-preserving map onto unsigned 32-bit
values: int32 keys with the sign bit flipped, uint32 keys as they are
(``ordered_key``; PyTorch's CPU ``uint32`` has no ``<``, ``flip`` or
``searchsorted``, so the plain versions carry the map in int64).

Intended differences from the JAX function: every length n >= 1 takes the
kernels (its SEG-multiple and power-of-two limits were the TPU tiling's),
so ``pad_to_pow2`` is accepted and does nothing; SEG is 2,048 (one block
sorts one tile in shared memory), not 32,768. The contract does not
promise stability, as in JAX; both designs are stable (equal keys keep
their input order), so each kernel and its plain version give the same
words bit for bit, and so do the two designs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils import cuda_build

#: Elements a block sorts, and each merge block's output tile
#: (csrc/psort.cu PS_SEG).
SEG = 2048
#: Payload words the kernels carry beside the key.
MAX_PAYLOADS = 3
#: Bits of a radix digit (csrc/radix_sort.cu RS_BITS).
RADIX_BITS = 8
#: Keys a radix pass block takes at a time (csrc/radix_sort.cu RS_TILE).
RADIX_TILE = 4096
#: Kernel launches made by :func:`block_sort` in this process.
BLOCK_LAUNCHES = 0
#: Kernel launches made by :func:`merge_round` in this process.
MERGE_LAUNCHES = 0
#: Histogram launches made by :func:`radix_histogram` (one a sort).
RADIX_HIST_LAUNCHES = 0
#: Pass kernels launched by :func:`radix_pass`: one a digit, so
#: :func:`radix_digits` a sort, skipped digits included (a skipped pass
#: returns at once on the device). The passes that ran are counted on the
#: device: :func:`radix_passes_taken`.
RADIX_PASS_LAUNCHES = 0
#: Calls of :func:`sort` that went to ``torch.sort`` (outside the contract).
LIBRARY_CALLS = 0

_U32 = 0xFFFFFFFF
_KEY_DTYPES = (torch.uint32, torch.int32)
_TAKEN: Dict[torch.device, torch.Tensor] = {}


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


def _ptrs(words: Sequence[torch.Tensor]) -> list:
    """Data pointers of a key and its payloads, NULL past the last."""
    return ([o.data_ptr() for o in words]
            + [None] * (1 + MAX_PAYLOADS - len(words)))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _flip_arg(key: torch.Tensor) -> int:
    """The kernels' key flip as a C int: INT_MIN for int32 keys."""
    return -(1 << 31) if key.dtype == torch.int32 else 0


def _launch(fn: str, operands: Sequence[torch.Tensor], *extra) -> Tuple:
    """Run one csrc/psort.cu kernel on CUDA operands -> new outputs."""
    key, *payloads = operands
    outs = [torch.empty_like(o) for o in operands]
    ins, outp = _ptrs(operands), _ptrs(outs)
    lib = cuda_build.library()
    dev = key.device
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*ins, *outp, key.shape[0], *extra,
                               len(payloads), _flip_arg(key), _stream(dev))
    cuda_build.check(err, fn)
    return tuple(outs)


def _check(operands: Sequence[torch.Tensor]) -> None:
    key = operands[0]
    if not _in_contract(operands):
        raise ValueError("the sort kernels take 1-D uint32/int32 keys and up "
                         f"to {MAX_PAYLOADS} 32-bit payloads of the same "
                         "length on one device")
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


def merge_sort_ref(operands: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """The plain merge sort: :func:`block_sort_ref`, then the merge
    rounds."""
    return _chain(tuple(operands), block_sort_ref, merge_round_ref)


def merge_sort(operands: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The earlier design of the sort, for in-contract operands: one
    :func:`block_sort`, then the :func:`merge_round` chain (kernels on
    CUDA tensors, plain versions on CPU tensors)."""
    operands = tuple(o.contiguous() for o in operands)
    _check(operands)
    return _chain(operands, block_sort, merge_round)


# -- the radix sort -----------------------------------------------------------
def radix_digits(bits: int = RADIX_BITS) -> int:
    """Digits of ``bits`` bits in a 32-bit key: one pass kernel each."""
    return -(-32 // bits)


def _digit(key: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    return (ordered_key(key) >> shift) & ((1 << bits) - 1)


def radix_pass_ref(operands: Sequence[torch.Tensor], shift: int,
                   bits: int = RADIX_BITS) -> Tuple[torch.Tensor, ...]:
    """Plain version of a radix pass: every word reordered stably by the
    digit (ordered_key(key) >> shift) & (2^bits - 1)."""
    order = torch.sort(_digit(operands[0], shift, bits), stable=True).indices
    return tuple(_take(o, order) for o in operands)


def radix_plan_ref(key: torch.Tensor,
                   bits: int = RADIX_BITS) -> Tuple[int, ...]:
    """Plain version of the plan the histogram kernel gives the passes:
    the shifts of the digits that are not the same in every key (a digit
    whose histogram puts all n keys in one bin is skipped)."""
    if key.shape[0] == 0:
        return ()
    plan = []
    for shift in range(0, 32, bits):
        d = _digit(key, shift, bits)
        if bool((d != d[0]).any()):
            plan.append(shift)
    return tuple(plan)


def radix_sort_ref(operands: Sequence[torch.Tensor],
                   bits: int = RADIX_BITS) -> Tuple[torch.Tensor, ...]:
    """The plain radix sort: :func:`radix_pass_ref` for each shift of
    :func:`radix_plan_ref`, least significant first (stable, so the
    result is the stable sort by the whole key)."""
    operands = tuple(operands)
    plan = radix_plan_ref(operands[0], bits)
    if not plan:
        return tuple(o.clone() for o in operands)
    for shift in plan:
        operands = radix_pass_ref(operands, shift, bits)
    return operands


def radix_workspace_bytes(n: int, bits: int = RADIX_BITS) -> int:
    """Bytes of the radix kernels' workspace for n keys
    (csrc/radix_sort.cu workspace_bytes): a 64-bit look-back status word a
    digit value, tile and digit; the global counts; a tile counter a
    digit."""
    digits, values = radix_digits(bits), 1 << bits
    tiles = -(-n // RADIX_TILE)
    return 8 * digits * tiles * values + 4 * digits * values + 4 * digits


def _cuda_key(key: torch.Tensor) -> torch.device:
    if key.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got "
                         f"{key.device}")
    if key.ndim != 1 or key.dtype not in _KEY_DTYPES or key.shape[0] < 1 \
            or key.shape[0] > 2 ** 31 - SEG or not key.is_contiguous():
        raise ValueError("the radix kernels take contiguous 1-D uint32/int32 "
                         f"keys of 1 to 2^31 - {SEG} elements")
    return key.device


def _taken(dev: torch.device) -> torch.Tensor:
    dev = torch.device(dev)
    if dev not in _TAKEN:
        _TAKEN[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TAKEN[dev]


def radix_passes_taken(device) -> int:
    """Radix passes that ran (were not skipped) on ``device`` in this
    process (a device-side tally; reading it waits for the device)."""
    return int(_taken(device).item())


def radix_histogram(key: torch.Tensor) -> torch.Tensor:
    """The histogram kernel on a CUDA key: zeroes a new workspace
    (u8[:func:`radix_workspace_bytes`]) and counts every digit value of
    every digit into it. -> the workspace, for :func:`radix_pass`."""
    global RADIX_HIST_LAUNCHES
    dev = _cuda_key(key)
    n = key.shape[0]
    ws = torch.empty(radix_workspace_bytes(n), dtype=torch.uint8, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.psim_radix_hist(key.data_ptr(), n, _flip_arg(key),
                                  ws.data_ptr(), ws.numel(), _stream(dev))
    cuda_build.check(err, "radix histogram")
    RADIX_HIST_LAUNCHES += 1
    return ws


def radix_pass(operands: Sequence[torch.Tensor],
               out: Sequence[torch.Tensor], scratch: Sequence[torch.Tensor],
               ws: torch.Tensor, digit: int) -> None:
    """One pass kernel, by digit ``digit`` (0 the least significant), of
    the sort whose :func:`radix_histogram` is ``ws``. Call it for every
    digit in order: a pass skipped by the plan returns at once; the others
    move the words from ``operands`` (the first pass taken) or the
    previous pass's buffer into ``out`` or ``scratch``, so that the last
    pass taken writes ``out`` (with no pass taken, the last digit's launch
    copies ``operands`` into ``out``). All CUDA, contiguous, the same
    shapes and dtypes, none aliasing another."""
    global RADIX_PASS_LAUNCHES
    key = operands[0]
    dev = _cuda_key(key)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.psim_radix_pass(
            *_ptrs(operands), *_ptrs(out), *_ptrs(scratch), key.shape[0],
            digit, len(operands) - 1, _flip_arg(key), ws.data_ptr(),
            ws.numel(), _taken(dev).data_ptr(), _stream(dev))
    cuda_build.check(err, "radix pass")
    RADIX_PASS_LAUNCHES += 1


def _radix_sort(operands: Tuple[torch.Tensor, ...],
                out: Sequence[torch.Tensor]) -> None:
    """The kernels: one histogram, then one pass launch a digit."""
    ws = radix_histogram(operands[0])
    scratch = [torch.empty_like(o) for o in operands]
    for digit in range(radix_digits()):
        radix_pass(operands, out, scratch, ws, digit)


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


def _check_out(operands, out) -> Tuple[torch.Tensor, ...]:
    out = tuple(out)
    if len(out) != len(operands) or any(
            o.shape != a.shape or o.dtype != a.dtype or o.device != a.device
            or not o.is_contiguous() for o, a in zip(out, operands)):
        raise ValueError("out must hold one contiguous tensor of each "
                         "operand's shape, dtype and device")
    return out


def sort(operands, num_keys: int = 1, *, pad_to_pow2: bool = False,
         out: Optional[Sequence[torch.Tensor]] = None
         ) -> Tuple[torch.Tensor, ...]:
    """Drop-in for ``lax.sort(operands, num_keys=num_keys)``: 1-D
    uint32/int32 keys with up to three 32-bit payloads go through the
    radix kernels (CUDA tensors) or :func:`radix_sort_ref` (CPU tensors),
    at any length; anything else goes to ``torch.sort`` (counted in
    LIBRARY_CALLS). ``pad_to_pow2`` is accepted for the JAX signature and
    does nothing: every length already takes the kernels. ``out``: tensors
    to write the sorted operands into (one a operand, its shape and dtype,
    contiguous); they are returned."""
    global LIBRARY_CALLS
    del pad_to_pow2
    operands = tuple(operands)
    if out is not None:
        out = _check_out(operands, out)
    if num_keys != 1 or not _in_contract(operands):
        LIBRARY_CALLS += 1
        result = _library_sort(operands, num_keys)
    else:
        operands = tuple(o.contiguous() for o in operands)
        _check(operands)
        if operands[0].device.type == "cpu" or operands[0].shape[0] == 0:
            result = radix_sort_ref(operands)
        else:
            if out is None:
                out = tuple(torch.empty_like(o) for o in operands)
            _radix_sort(operands, out)
            return out
    if out is None:
        return result
    for o, r in zip(out, result):
        o.copy_(r)
    return out
