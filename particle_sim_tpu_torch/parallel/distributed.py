"""Process-group initialization: how the ranks of a mesh find each other.

Counterpart of ``particle_sim_tpu/parallel/distributed.py``. One process
drives each device; :func:`initialize` joins this process to the group,
either from its arguments or from the environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
``LOCAL_RANK`` picks the card):

    # on every rank, e.g. under torchrun --nproc_per_node 4:
    from particle_sim_tpu_torch.parallel import distributed
    distributed.initialize(device="cuda")    # nccl; gloo for "cpu"
    mesh = distributed.global_mesh("cuda")  # 1-D dp mesh over all ranks

With no arguments and no such environment there is one process:
:func:`initialize` returns False, as JAX's does, and nothing is set up.
The backend follows the device (nccl for cuda, gloo for cpu); the port
never switches backend or device on its own, and a failed init raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import backend_for, make_mesh

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: Seconds a collective may wait for the other ranks before it raises.
TIMEOUT_S = 600


def launched_by_env() -> bool:
    """Whether torchrun's environment names this process's group."""
    return all(k in os.environ for k in ENV_KEYS)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               timeout_s: float = TIMEOUT_S) -> bool:
    """Join this process to the process group; False when there is one
    process (no arguments, no torchrun environment).

    ``coordinator_address``: an init method (``tcp://host:port``,
    ``file:///path``) or ``host:port``, with ``num_processes`` and
    ``process_id``. True at once when the group is already up. On CUDA
    the rank's card is ``LOCAL_RANK`` (else the rank modulo the visible
    cards), made the current device before the nccl group starts."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if not launched_by_env():
            return False
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an nccl group needs CUDA, and "
                               "torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return True


def initialize_single(device="cpu") -> None:
    """A group of one process (an in-process store, no port, no file):
    the mesh path at world size 1."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("an nccl group needs CUDA, and "
                           "torch.cuda.is_available() is False")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=timedelta(seconds=TIMEOUT_S))


def global_mesh(device: Optional[str] = None):
    """1-D dp mesh spanning every rank of the group."""
    return make_mesh(device)


def process_info() -> dict:
    """The four keys of the JAX package's: this process's index, the
    process count, the devices it drives (one), and the mesh's devices."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
