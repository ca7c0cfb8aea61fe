"""All-pairs gravity over the mesh: a ring of position shards.

Counterpart of ``particle_sim_tpu/parallel/ring.py`` (the communication
pattern of ring attention applied to N-body). Each rank keeps its
receivers (its i-shard) fixed, and a j-buffer of source positions (and
source masses, when there are masses) goes round the ring: after k hops
a rank holds the shard first owned by rank (rank + k) mod n_dev, whose
global column offset ``j_base`` masks the global padding in the kernel
(csrc/pairwise.cu through ops/pairwise_cuda.py, or the plain
ops/pairwise.py). The kernel also takes the hop's live source count on
the device, the buffer's sources below the global ``n_active``, so it
stops at the last tile that holds one (every receiver is still summed:
dead slots feel the live field, as in the JAX package). The buffer
moves in JAX's direction, sent to rank - 1 and received from rank + 1,
and the next hop's receive is posted before the kernel runs on the
current buffer, so the transfer overlaps the O(N^2 / n_dev) work.
There are n_dev - 1 hops: the JAX loop's last ``ppermute`` is never
read. The accumulated force then integrates through the same kicked
step kernel as the single-device direct path (``step_cuda.kick_step``).

Per step each rank sends its 12-byte-a-particle shard (16 with masses)
n_dev - 1 times: O(N) bytes against O(N^2 / n_dev) work.
"""

from __future__ import annotations

import torch

from ..ops import pairwise, pairwise_cuda, physics, step_cuda
from .mesh import Collectives


def live_in_shard(n_active, base: int, size: int):
    """How many of the ``size`` slots from global index ``base`` lie below
    ``n_active``: ``clamp(n_active - base, 0, size)``, an int32 tensor on
    the device when ``n_active`` is one (nothing read back)."""
    if isinstance(n_active, torch.Tensor):
        return (n_active.to(torch.int32) - base).clamp(0, size)
    return min(max(int(n_active) - base, 0), size)


def make_ring_pairwise_step(mesh, *, use_kernels: bool = True,
                            with_masses: bool = False):
    """-> fn(pos, vel, param_vec, pair_vec, n_active[, masses]) -> (pos,
    vel). ``pos``/``vel``: this rank's (3, R/n_dev, LANE) shard;
    ``n_active``: the GLOBAL active count; ``masses``: this rank's f32
    source masses (they travel with the positions; receivers are
    mass-free: gravity is an acceleration field). ``use_kernels``: the
    pairwise kernel, then the kicked step kernel in place; else the plain
    sum and physics.kick_and_step_planes (new tensors)."""
    coll = Collectives(mesh)
    n_dev, rank = coll.size, coll.rank
    accel = pairwise_cuda.pairwise_accel if use_kernels else (
        pairwise.pairwise_accel)

    def step(pos, vel, param_vec, pair_vec, n_active, masses=None):
        if with_masses != (masses is not None):
            raise ValueError("masses given against with_masses")
        shape = pos.shape
        local_n = shape[1] * shape[2]
        flat = pos.reshape(3, -1)
        xi = flat.T.contiguous()                      # fixed i-shard
        # one message a hop: positions, and masses as a fourth row
        buf = torch.empty((3 + with_masses, local_n), dtype=torch.float32,
                          device=pos.device)
        buf[:3] = flat
        if with_masses:
            buf[3] = masses
        nxt = torch.empty_like(buf) if n_dev > 1 else None
        acc = None
        for k in range(n_dev):
            works = (coll.ring_shift(buf, nxt) if k < n_dev - 1 else [])
            j_base = ((rank + k) % n_dev) * local_n
            a = accel(xi, buf[:3], n_active, pair_vec[0], pair_vec[1],
                      j_base=j_base, masses=buf[3] if with_masses else None,
                      n_j=live_in_shard(n_active, j_base, local_n))
            acc = a if acc is None else acc + a
            for w in works:
                w.wait()
            buf, nxt = nxt, buf
        if use_kernels:
            return step_cuda.kick_step(pos, vel, acc.T.contiguous(),
                                       param_vec)
        return physics.kick_and_step_planes(pos, vel, acc.T.reshape(shape),
                                            param_vec)

    return step
