"""All-pairs O(N^2) softened gravity — the plain PyTorch version.

Counterpart of ``particle_sim_tpu/ops/pairwise.py`` (the jnp oracle) with
the argument layout of ``particle_sim_tpu/ops/pairwise_pallas.py``'s
``pairwise_accel``, so one function covers the square N x N sum, a
rectangular Ni x Nj block and the ring's ``j_base`` offset:

    a_i = sum_j g_valid[j] * (x_j - x_i) * rsqrt(|x_j - x_i|^2 + eps^2)^3
    g_valid[j] = G * (j_base + j < n_active) * m_j

Per pair: ``diff = x_j - x_i``, ``r2 = dx*dx + dy*dy + dz*dz + eps^2``,
one ``rsqrt``, ``w = g_valid * (inv*inv*inv)``. Masses act on the source
side only (gravity is an acceleration field). The softening makes the
self-pair contribute exactly zero, so no self mask is needed; padded
sources are masked through ``g_valid``.

This is the reference the CUDA kernel (ops/pairwise_cuda.py) is held to.
The receivers are taken in chunks, so memory stays O(chunk x Nj) where
the jnp oracle builds the whole N x N tensor (~51 GB at 65,536).

The live counts ``n_i`` and ``n_j`` (None: all of them) are the kernel's:
receivers at or past ``n_i`` get exactly 0, and sources at or past
``n_j`` add nothing, whatever they hold (NaN included).
:func:`pairwise_accel_diff` is pmx's correction in one call: the sum at
softening ``eps_a`` minus the sum at ``eps_b``, here as the two passes
subtracted (the kernel's difference instantiation forms both weights of
a pair at once).

While tracing is on (utils/trace.py), :func:`pairwise_accel` counts the
pairs it covers (``Ni * Nj`` from the shapes) under ``pairwise.pairs``,
:func:`pairwise_accel_diff` under ``pairwise.diff_pairs``, and
:func:`step_pairwise` records its force as the span ``pairwise.force``
and its kick and attractor step as ``pairwise.kick``, the names
ops/pairwise_cuda.py records on the card.

:func:`pairwise_accel_mxu_ref` is the plain version of the matrix-product
formulation (``pairwise_pallas.pairwise_accel_mxu``, the counterpart of
csrc/pairwise_mxu.cu): the same sum with r^2 expanded as
|xi|^2 + |xj|^2 - 2 xi.xj, so both O(N^2) contractions are matrix
products. The expansion cancels terms of size |x|^2 in f32: on the
filled sphere of radius 50 it sits up to 0.01 a component (1e-2 floor)
from the direct sum at 2,048 particles and up to ~0.1 at 65,536, where
the direct form stays near 1e-3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import trace
from . import physics

#: Pair elements per receiver chunk of the plain sum (~64 MB of f32 per
#: temporary).
CHUNK_PAIRS = 1 << 24


def source_weights(n_j: int, n_active, g_const, *, j_base: int = 0,
                   masses=None, device=None) -> torch.Tensor:
    """f32[Nj] ``G * (j_base + j < n_active) * m_j``: the O(N) validity
    and constant work hoisted out of the O(N^2) sum."""
    j = torch.arange(n_j, dtype=torch.int32, device=device) + int(j_base)
    gv = (j < torch.as_tensor(n_active, device=device)).to(torch.float32)
    gv = torch.as_tensor(g_const, dtype=torch.float32, device=device) * gv
    if masses is not None:
        gv = gv * masses
    return gv


def accel_from_weights(x_nx3: torch.Tensor, x_3xn: torch.Tensor,
                       g_valid: torch.Tensor, eps_sq) -> torch.Tensor:
    """f32[Ni, 3] accelerations of the receivers ``x_nx3`` from the
    sources ``x_3xn`` weighted by ``g_valid`` (see the module formula)."""
    n_i, n_j = x_nx3.shape[0], x_3xn.shape[1]
    out = torch.empty((n_i, 3), dtype=torch.float32, device=x_nx3.device)
    rows = max(1, CHUNK_PAIRS // max(n_j, 1))
    sx, sy, sz = x_3xn[0][None, :], x_3xn[1][None, :], x_3xn[2][None, :]
    gv = g_valid[None, :]
    for i0 in range(0, n_i, rows):
        xi = x_nx3[i0:i0 + rows]
        dx = sx - xi[:, 0:1]
        dy = sy - xi[:, 1:2]
        dz = sz - xi[:, 2:3]
        r2 = dx * dx + dy * dy + dz * dz + eps_sq
        inv = torch.rsqrt(r2)
        w = gv * (inv * inv * inv)
        out[i0:i0 + rows, 0] = (w * dx).sum(1)
        out[i0:i0 + rows, 1] = (w * dy).sum(1)
        out[i0:i0 + rows, 2] = (w * dz).sum(1)
    return out


def pairwise_accel(
    x_nx3: torch.Tensor,   # f32[Ni, 3] receiver positions
    x_3xn: torch.Tensor,   # f32[3, Nj] source positions
    n_active,              # active count among GLOBAL sources
    g_const,
    softening,
    *,
    j_base: int = 0,       # global index of x_3xn's first column
    masses=None,           # f32[Nj] source masses (None = unit)
    n_i=None,              # live receivers (None = Ni)
    n_j=None,              # live sources (None = Nj)
) -> torch.Tensor:
    """f32[Ni, 3] accelerations from all sources (the plain version)."""
    trace.count("pairwise.pairs", x_nx3.shape[0] * x_3xn.shape[1])
    return _pairwise_accel(x_nx3, x_3xn, n_active, g_const, softening,
                           j_base=j_base, masses=masses, n_i=n_i, n_j=n_j)


def _pairwise_accel(x_nx3, x_3xn, n_active, g_const, softening, *,
                    j_base=0, masses=None, n_i=None, n_j=None):
    dev = x_nx3.device
    gv = source_weights(x_3xn.shape[1], n_active, g_const, j_base=j_base,
                        masses=masses, device=dev)
    if n_j is not None:
        j_live = (torch.arange(x_3xn.shape[1], device=dev)
                  < torch.as_tensor(n_j, device=dev))
        gv = torch.where(j_live, gv, 0.0)
        x_3xn = torch.where(j_live[None, :], x_3xn, 0.0)
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    out = accel_from_weights(x_nx3, x_3xn, gv, eps * eps)
    if n_i is not None:
        i_live = (torch.arange(x_nx3.shape[0], device=dev)
                  < torch.as_tensor(n_i, device=dev))
        out = torch.where(i_live[:, None], out, 0.0)
    return out


def pairwise_accel_diff(x_nx3: torch.Tensor, x_3xn: torch.Tensor, n_active,
                        g_const, eps_a, eps_b, *, masses=None, n_i=None,
                        n_j=None) -> torch.Tensor:
    """f32[Ni, 3]: :func:`pairwise_accel` at softening ``eps_a`` minus the
    same at ``eps_b`` (the plain version of the kernel's difference
    pass)."""
    trace.count("pairwise.diff_pairs", x_nx3.shape[0] * x_3xn.shape[1])
    kw = dict(masses=masses, n_i=n_i, n_j=n_j)
    return (_pairwise_accel(x_nx3, x_3xn, n_active, g_const, eps_a, **kw)
            - _pairwise_accel(x_nx3, x_3xn, n_active, g_const, eps_b, **kw))


#: ``|xj|^2`` of a masked source in the matrix-product form: r^2 ~ 1e30, so
#: its weight rsqrt(r^2)^3 underflows to 0 (or a denormal that meets a
#: zeroed source row): it adds exactly 0.
MASK_BIG = 1e30


def mxu_source_terms(src_flat: torch.Tensor, n_active, g_const, *,
                     j_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xj2 f32[Nj], xj_aug f32[4, Nj]) of the matrix-product form:
    ``|xj|^2 + (1 - valid) * MASK_BIG`` and ``G * valid * [x, y, z, 1]``,
    valid = ``j_base + j < n_active`` (the JAX wrapper's O(N) terms)."""
    dev = src_flat.device
    n_j = src_flat.shape[1]
    j = torch.arange(n_j, dtype=torch.int32, device=dev) + int(j_base)
    valid = (j < torch.as_tensor(n_active, device=dev)).to(torch.float32)
    g = torch.as_tensor(g_const, dtype=torch.float32, device=dev)
    xj2 = (src_flat * src_flat).sum(0) + (1.0 - valid) * MASK_BIG
    ones = torch.ones((1, n_j), dtype=torch.float32, device=dev)
    xj_aug = torch.cat([src_flat, ones], 0) * (g * valid)[None, :]
    return xj2, xj_aug


def pairwise_accel_mxu_ref(
    pos_flat: torch.Tensor,   # f32[3, Ni] receivers (component rows)
    src_flat: torch.Tensor,   # f32[3, Nj] sources
    n_active,                 # active count among GLOBAL sources
    g_const,
    softening,
    *,
    j_base: int = 0,          # global index of src_flat's first column
) -> torch.Tensor:
    """f32[3, Ni] accelerations in the matrix-product form (the plain
    version of csrc/pairwise_mxu.cu), in the JAX kernel's order:

        r2 = -2 xi.xj + (|xi|^2 + eps^2) + xj2;  w = rsqrt(r2)^3
        S  = xj_aug @ w^T                        (4, Ni), over source chunks
        a  = S[:3] - xi * S[3]

    Both products run in full f32: TF32 is switched off for the call
    (``torch.backends.cuda.matmul.allow_tf32 = False``) and restored
    after. Sources are taken in chunks of CHUNK_PAIRS / Ni, so memory
    stays O(Ni x chunk)."""
    dev = pos_flat.device
    n_i, n_j = pos_flat.shape[1], src_flat.shape[1]
    xj2, xj_aug = mxu_source_terms(src_flat, n_active, g_const,
                                   j_base=j_base)
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    xi = pos_flat.T
    xi2e = (xi * xi).sum(1, keepdim=True) + eps * eps     # (Ni, 1)
    xi_m2 = xi * -2.0
    s = torch.zeros((4, n_i), dtype=torch.float32, device=dev)
    cols = max(1, CHUNK_PAIRS // max(n_i, 1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for j0 in range(0, n_j, cols):
            sl = slice(j0, j0 + cols)
            r2 = xi_m2 @ src_flat[:, sl] + xi2e + xj2[None, sl]
            inv = torch.rsqrt(r2)
            s += xj_aug[:, sl] @ (inv * inv * inv).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return s[:3] - pos_flat * s[3:4]


def step_pairwise(
    pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
    pair_vec: torch.Tensor,   # f32[2]: (G, softening), PairwiseParams.pack()
    n_active: torch.Tensor,
    masses=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step with all-pairs gravity + attractor + gravity on
    ``(3, R, LANE)`` planes. -> (pos, vel), new tensors."""
    flat = pos.reshape(3, -1)
    with trace.span("pairwise.force", device=pos.is_cuda):
        acc = pairwise_accel(flat.T, flat, n_active, pair_vec[0],
                             pair_vec[1], masses=masses)
    with trace.span("pairwise.kick", device=pos.is_cuda):
        return physics.kick_and_step_planes(
            pos, vel, acc.T.reshape(pos.shape), param_vec)
