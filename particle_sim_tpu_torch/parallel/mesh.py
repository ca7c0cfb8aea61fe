"""Device-mesh helpers: SPMD on ``torch.distributed``.

Counterpart of ``particle_sim_tpu/parallel/mesh.py``. JAX drives every
device of its ``dp`` mesh from one process (``shard_map``); here one
process drives each device, every rank runs the same program on its own
contiguous shard of rows, and the shards talk through the collectives of
:class:`Collectives`. The mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ``"dp"`` over the
initialized world (parallel/distributed.py initializes it).

The ops modules never import ``torch.distributed``: each collective point
there takes an optional ``coll`` (a :class:`Collectives`), and ``None``
means one device, with the arithmetic of the single-device path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

DP_AXIS = "dp"


def backend_for(device) -> str:
    """The process-group backend of a device type: ``nccl`` for CUDA,
    ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {kind!r}")


def make_mesh(device: Optional[str] = None):
    """1-D ``dp`` DeviceMesh over every rank of the initialized world.
    ``device``: its device type ("cuda" or "cpu"); by default the one
    the group's backend serves. Raises when torch.distributed is not
    initialized."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.distributed.initialize() first")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    kind = torch.device(device).type
    if backend_for(kind) != dist.get_backend():
        raise ValueError(f"a {kind} mesh needs the {backend_for(kind)} "
                         f"backend; the group runs {dist.get_backend()}")
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(DP_AXIS,))


def shard_rows(mesh, plane: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous share of ``plane`` along ``dim`` (a copy;
    the size along ``dim`` must divide by the mesh size)."""
    n_dev, rank = int(mesh.size()), mesh.get_local_rank()
    size = plane.shape[dim]
    if size % n_dev:
        raise ValueError(f"{size} rows do not split over {n_dev} devices")
    step = size // n_dev
    return plane.narrow(dim, rank * step, step).contiguous()


def shard_state_planes(mesh, *planes: torch.Tensor) -> tuple:
    """This rank's rows R/n_dev of each (3, R, LANE) component plane."""
    return tuple(shard_rows(mesh, p, 1) for p in planes)


class Collectives:
    """The collectives of the ``dp`` axis that the ops modules call (their
    ``coll`` argument). ``sum_``, ``min_`` and ``max_`` all-reduce a tensor
    in place and return it; :meth:`all_gather` concatenates every rank's
    tensor along a dim, in rank order; :meth:`ring_shift` posts one hop of
    a ring (send to rank - 1, receive from rank + 1, the direction of
    JAX's ``ppermute`` in parallel/ring.py)."""

    def __init__(self, mesh):
        self.group = mesh.get_group(DP_AXIS)
        self.rank = mesh.get_local_rank()
        self.size = int(mesh.size())

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def min_(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def ring_shift(self, send: torch.Tensor, recv: torch.Tensor) -> list:
        """Post ``send`` to rank - 1 and a receive from rank + 1 into
        ``recv``; -> the requests (wait on each before reading recv)."""
        peer = lambda r: dist.get_global_rank(self.group, r % self.size)
        ops = [dist.P2POp(dist.isend, send, peer(self.rank - 1), self.group),
               dist.P2POp(dist.irecv, recv, peer(self.rank + 1), self.group)]
        return dist.batch_isend_irecv(ops)
