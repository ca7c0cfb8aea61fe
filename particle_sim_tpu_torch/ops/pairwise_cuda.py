"""All-pairs gravity on the hand-written CUDA kernel (csrc/pairwise.cu).

Counterpart of ``particle_sim_tpu/ops/pairwise_pallas.py`` (its
``pairwise_accel``, ``pairwise_accel_mxu`` and ``step_pairwise``), with
the same arguments. :func:`pairwise_accel` and :func:`pairwise_accel_mxu`
(the matrix-product form on the tensor cores, csrc/pairwise_mxu.cu; no
entry point uses it, as in the JAX package) take their plain versions
(ops/pairwise.py) for CPU tensors, and on CUDA tensors launch their
kernels or raise. :func:`pairwise_accel_mxu` prepares its receivers on
the card: their Hilbert order from the key kernel (csrc/hilbert.cu,
:func:`hilbert_keys_kernel`; plain :func:`hilbert_keys`) and the radix
sort (``psort.sort``), with no fallback to ``torch.argsort``, and the
block centres' inlier box from the box kernel (the same file,
:func:`inlier_box_kernel`; plain :func:`inlier_box`).

:func:`step_pairwise` is the direct-sum step: the kernel's accelerations,
then a plain ``vel += acc*dt``, then the attractor step kernel
(ops/step_cuda.py) — the order of ``physics.kick_and_step_planes``. Like
the step kernel it updates ``pos`` and ``vel`` IN PLACE.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.params import P_DT
from ..utils import cuda_build
from . import pairwise, psort, step_cuda

#: Kernel launches made by :func:`pairwise_accel` in this process.
LAUNCHES = 0
#: Kernel launches made by :func:`pairwise_accel_mxu` in this process.
MXU_LAUNCHES = 0
#: Kernel launches made by :func:`hilbert_keys_kernel` in this process.
HILBERT_LAUNCHES = 0
#: Kernel launches made by :func:`inlier_box_kernel` in this process.
BOX_LAUNCHES = 0


def _check(x_nx3, x_3xn, masses) -> None:
    for name, t in (("x_nx3", x_nx3), ("x_3xn", x_3xn), ("masses", masses)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x_nx3.device:
            raise ValueError(f"{name} on {t.device}, x_nx3 on "
                             f"{x_nx3.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x_nx3.ndim != 2 or x_nx3.shape[1] != 3:
        raise ValueError(f"x_nx3 must be [Ni, 3], got {tuple(x_nx3.shape)}")
    if x_3xn.ndim != 2 or x_3xn.shape[0] != 3:
        raise ValueError(f"x_3xn must be [3, Nj], got {tuple(x_3xn.shape)}")
    if masses is not None and masses.shape != (x_3xn.shape[1],):
        raise ValueError(f"masses must be [{x_3xn.shape[1]}], got "
                         f"{tuple(masses.shape)}")


def pairwise_accel(x_nx3: torch.Tensor, x_3xn: torch.Tensor, n_active,
                   g_const, softening, *, j_base: int = 0,
                   masses=None) -> torch.Tensor:
    """f32[Ni, 3] accelerations of the receivers ``x_nx3`` (f32[Ni, 3])
    from the sources ``x_3xn`` (f32[3, Nj], global index j_base + j).
    ``n_active``, ``g_const`` and ``softening`` may be Python numbers or
    tensors on the device (then nothing is read back to the host)."""
    global LAUNCHES
    _check(x_nx3, x_3xn, masses)
    dev = x_nx3.device
    if dev.type == "cpu":
        return pairwise.pairwise_accel(x_nx3, x_3xn, n_active, g_const,
                                       softening, j_base=j_base,
                                       masses=masses)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_i, n_j = x_nx3.shape[0], x_3xn.shape[1]
    if max(n_i, n_j) * 3 >= 2 ** 31:
        raise ValueError(f"{n_i} x {n_j} pairs: too many for int32 indexing")
    xi, xj = x_nx3.contiguous(), x_3xn.contiguous()
    gv = pairwise.source_weights(n_j, n_active, g_const, j_base=j_base,
                                 masses=masses, device=dev).contiguous()
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    eps_sq = (eps * eps).reshape(1)
    out = torch.empty((n_i, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.psim_pairwise(xi.data_ptr(), xj.data_ptr(), gv.data_ptr(),
                                eps_sq.data_ptr(), out.data_ptr(), n_i, n_j,
                                stream)
    LAUNCHES += 1
    cuda_build.check(err, "pairwise")
    return out


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """The 10 low bits of ``v`` (int32) moved to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def hilbert_box(pos_flat: torch.Tensor) -> torch.Tensor:
    """f32[6] (min xyz, max xyz) of ``nan_to_num(pos_flat)``: the box the
    Hilbert keys quantise, in one reduction."""
    lo, hi = torch.aminmax(torch.nan_to_num(pos_flat), dim=1)
    return torch.cat([lo, hi])


def hilbert_keys(pos_flat: torch.Tensor, bits: int = 8,
                 box: torch.Tensor = None) -> torch.Tensor:
    """int32[N] Hilbert-curve keys of the points f32[3, N] over their
    bounding box (``box``, default :func:`hilbert_box`), 2^bits (<= 1,024)
    cells an axis: consecutive cells on the curve are neighbours, so any
    run of points with consecutive keys is a compact region (a Morton
    curve jumps across the box at its octant boundaries). Skilling's
    transpose form ("Programming the Hilbert curve", AIP Conf. Proc. 707,
    2004), on all points at once. The plain version of csrc/hilbert.cu."""
    if box is None:
        box = hilbert_box(pos_flat)
    p = torch.nan_to_num(pos_flat)
    lo = box[:3, None]
    span = (box[3:, None] - lo).clamp_min(1e-30)
    top = (1 << bits) - 1
    q = ((p - lo) / span * top).clamp(0.0, top).to(torch.int32)
    x = [q[0], q[1], q[2]]
    bit = 1 << (bits - 1)
    while bit > 1:                       # undo the excess work
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
    x[1] = x[1] ^ x[0]                   # Gray encode
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    bit = 1 << (bits - 1)
    while bit > 1:
        t = torch.where((x[2] & bit) != 0, t ^ (bit - 1), t)
        bit >>= 1
    # interleave, high bits first: bit b of x[i] to bit 3b + 2 - i
    return ((_spread_bits(x[0] ^ t) << 2) | (_spread_bits(x[1] ^ t) << 1)
            | _spread_bits(x[2] ^ t))


def hilbert_order(pos_flat: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """int64[N] permutation putting the points f32[3, N] in Hilbert-curve
    order (:func:`hilbert_keys`), stable: points with equal keys keep
    their input order. Plain torch on any device."""
    return torch.argsort(hilbert_keys(pos_flat, bits), stable=True)


def hilbert_keys_kernel(pos_flat: torch.Tensor, bits: int = 8,
                        box: torch.Tensor = None) -> torch.Tensor:
    """:func:`hilbert_keys` on the key kernel (csrc/hilbert.cu) for a CUDA
    tensor, bit for bit; a CPU tensor takes the plain version. ``box``:
    f32[6] from :func:`hilbert_box` (computed when None)."""
    global HILBERT_LAUNCHES
    if not 1 <= bits <= 10:
        raise ValueError(f"bits must be in 1..10, got {bits}")
    dev = pos_flat.device
    if dev.type == "cpu":
        return hilbert_keys(pos_flat, bits, box)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    pos_flat = pos_flat.contiguous()
    if box is None:
        box = hilbert_box(pos_flat)
    box = box.contiguous()
    n = pos_flat.shape[1]
    key = torch.empty(n, dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.psim_hilbert_keys(pos_flat.data_ptr(), box.data_ptr(),
                                    key.data_ptr(), n, bits,
                                    torch.cuda.current_stream(dev).cuda_stream)
    HILBERT_LAUNCHES += 1
    cuda_build.check(err, "hilbert_keys")
    return key


def receiver_order(pos_flat: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """int32[N]: the points in Hilbert order, as :func:`hilbert_order`
    (stable), from the key kernel and ``psort.sort((key, index))`` (the
    radix kernels; on a CPU tensor the plain versions of both)."""
    n = pos_flat.shape[1]
    iota = torch.arange(n, dtype=torch.int32, device=pos_flat.device)
    return psort.sort((hilbert_keys_kernel(pos_flat, bits), iota))[1]


def _box_stride(n: int) -> int:
    return max(1, n // 4096)


def inlier_box(pos_flat: torch.Tensor) -> torch.Tensor:
    """f32[6] (lo xyz, hi xyz): the median of each coordinate -/+ 8 times
    its median absolute deviation, estimated on at most ~4,096 evenly
    strided points (fewer than 8,192). Receivers outside it (padding
    parked far from the cloud) are left out of the MXU kernel's block
    centres. The plain version of csrc/hilbert.cu's inlier box."""
    p = torch.nan_to_num(pos_flat[:, ::_box_stride(pos_flat.shape[1])])
    med = p.median(dim=1).values
    mad = (p - med[:, None]).abs().median(dim=1).values
    return torch.cat([med - 8.0 * mad, med + 8.0 * mad]).contiguous()


def inlier_box_kernel(pos_flat: torch.Tensor) -> torch.Tensor:
    """:func:`inlier_box` on one kernel (csrc/hilbert.cu: exact radix
    selects of the medians) for a CUDA tensor, bit for bit; a CPU tensor
    takes the plain version."""
    global BOX_LAUNCHES
    dev = pos_flat.device
    if dev.type == "cpu":
        return inlier_box(pos_flat)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pos_flat.shape[1]
    if n == 0:
        raise ValueError("inlier_box of no points")
    pos_flat = pos_flat.contiguous()
    stride = _box_stride(n)   # the sample: ceil(n / stride) < 8,192 points
    box = torch.empty(6, dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.psim_inlier_box(pos_flat.data_ptr(), n, stride,
                                  -(-n // stride), box.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    BOX_LAUNCHES += 1
    cuda_build.check(err, "inlier_box")
    return box


def pairwise_accel_mxu(pos_flat: torch.Tensor, src_flat: torch.Tensor,
                       n_active, g_const, softening, *, j_base: int = 0,
                       tile_i: int = 512, tile_j: int = 1024) -> torch.Tensor:
    """f32[3, Ni] accelerations of the receivers ``pos_flat`` (f32[3, Ni])
    from the sources ``src_flat`` (f32[3, Nj], global index j_base + j), in
    the matrix-product form of ``pairwise_pallas.pairwise_accel_mxu``, on
    the tensor-core kernel csrc/pairwise_mxu.cu. ``tile_i`` and ``tile_j``
    are the TPU kernel's tiling hints, accepted for the same signature; the
    kernel's tiles are fixed (32 receivers a warp, 256 sources a stage)
    and they are ignored. The receivers' Hilbert order and inlier box are
    computed on the card (:func:`receiver_order`,
    :func:`inlier_box_kernel`)."""
    global MXU_LAUNCHES
    del tile_i, tile_j
    for name, t in (("pos_flat", pos_flat), ("src_flat", src_flat)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2 or t.shape[0] != 3:
            raise ValueError(f"{name} must be [3, N], got {tuple(t.shape)}")
    dev = pos_flat.device
    if src_flat.device != dev:
        raise ValueError(f"src_flat on {src_flat.device}, pos_flat on {dev}")
    if dev.type == "cpu":
        return pairwise.pairwise_accel_mxu_ref(pos_flat, src_flat, n_active,
                                               g_const, softening,
                                               j_base=j_base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_i, n_j = pos_flat.shape[1], src_flat.shape[1]
    if max(n_i, n_j) * 4 >= 2 ** 31:
        raise ValueError(f"{n_i} x {n_j} pairs: too many for int32 indexing")
    if n_i == 0:
        return torch.zeros((3, 0), dtype=torch.float32, device=dev)
    # receivers in Hilbert order, so each block's receivers lie close
    # together and the kernel's centred coordinates are small; the kernel
    # reads them through the order and writes each to its own column
    order = receiver_order(pos_flat)
    xi = pos_flat.contiguous()
    xj = src_flat.contiguous()
    box = inlier_box_kernel(xi)
    gv = pairwise.source_weights(n_j, n_active, g_const, j_base=j_base,
                                 device=dev).contiguous()
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    eps_sq = (eps * eps).reshape(1)
    out = torch.empty((3, n_i), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.psim_pairwise_mxu(xi.data_ptr(), order.data_ptr(),
                                    xj.data_ptr(), gv.data_ptr(),
                                    eps_sq.data_ptr(), box.data_ptr(),
                                    out.data_ptr(), n_i, n_j, stream)
    MXU_LAUNCHES += 1
    cuda_build.check(err, "pairwise_mxu")
    return out


def step_pairwise(pos: torch.Tensor, vel: torch.Tensor,
                  param_vec: torch.Tensor, pair_vec: torch.Tensor,
                  n_active: torch.Tensor, masses=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direct-sum step on (3, R, LANE) planes, in place.
    -> (pos, vel), the same tensors."""
    if pos.device.type == "cpu":
        p, v = pairwise.step_pairwise(pos, vel, param_vec, pair_vec,
                                      n_active, masses=masses)
        pos.copy_(p)
        vel.copy_(v)
        return pos, vel
    flat = pos.reshape(3, -1)
    acc = pairwise_accel(flat.T, flat, n_active, pair_vec[0], pair_vec[1],
                         masses=masses)
    vel.add_(acc.T.reshape(vel.shape) * param_vec[P_DT])
    return step_cuda.step(pos, vel, param_vec)
