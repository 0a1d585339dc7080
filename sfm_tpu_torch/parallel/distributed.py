"""Multi-process initialization.

Counterpart of ``sfm_tpu/parallel/distributed.py``.  One process driving
the GPUs of its host needs nothing: ``data_mesh()`` spans them (and raises
where there is none; CPU shards are named with ``devices=``).  Across
processes or hosts, every process calls :func:`initialize_multihost` once
with the same coordinator address; afterwards ``data_mesh()`` spans the
process group, as ``jax.devices()`` spans the processes after
``jax.distributed.initialize``, and the stages run unchanged with
``mesh=``: every process loads the same inputs and runs the same program
(SPMD), and holds the same result.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

# A collective that waits longer than this for another process fails
# instead of hanging.  SPMD processes run the same work, so they wait on
# each other only for process 0's file writes and a first kernel build.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> dict:
    """Join a ``torch.distributed`` process group of ``num_processes``
    processes at ``coordinator_address`` ("host:port", where process 0
    listens) as process ``process_id``.  For one process (no arguments)
    it initializes nothing, as ``sfm_tpu``'s.

    ``backend`` is NCCL by default; gloo runs only where the caller names
    it (CPU processes, or several processes sharing one GPU, which NCCL
    refuses).  A backend that fails to start raises: nothing falls back
    to the other.

    Returns the same keys as ``sfm_tpu``'s: process_index, process_count,
    local_devices (the devices this process drives: one per process in a
    group, ``data_mesh()``'s default; without a group the CUDA devices, or
    1 for the CPU) and global_devices (the sum over the processes).
    """
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=GROUP_TIMEOUT,
        )
        return {
            "process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
        }
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": 0,
        "process_count": 1,
        "local_devices": local,
        "global_devices": local,
    }

