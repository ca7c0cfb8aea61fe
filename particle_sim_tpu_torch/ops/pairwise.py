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
"""

from __future__ import annotations

from typing import Tuple

import torch

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
) -> torch.Tensor:
    """f32[Ni, 3] accelerations from all sources (the plain version)."""
    dev = x_nx3.device
    gv = source_weights(x_3xn.shape[1], n_active, g_const, j_base=j_base,
                        masses=masses, device=dev)
    eps = torch.as_tensor(softening, dtype=torch.float32, device=dev)
    return accel_from_weights(x_nx3, x_3xn, gv, eps * eps)


def step_pairwise(
    pos: torch.Tensor, vel: torch.Tensor, param_vec: torch.Tensor,
    pair_vec: torch.Tensor,   # f32[2]: (G, softening), PairwiseParams.pack()
    n_active: torch.Tensor,
    masses=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step with all-pairs gravity + attractor + gravity on
    ``(3, R, LANE)`` planes. -> (pos, vel), new tensors."""
    flat = pos.reshape(3, -1)
    acc = pairwise_accel(flat.T, flat, n_active, pair_vec[0], pair_vec[1],
                         masses=masses)
    return physics.kick_and_step_planes(pos, vel, acc.T.reshape(pos.shape),
                                        param_vec)
