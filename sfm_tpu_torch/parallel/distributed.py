"""Multi-process initialization.

Counterpart of ``sfm_tpu/parallel/distributed.py``.  One process driving
the GPUs of its host needs nothing: ``data_mesh()`` spans them (and raises
where there is none; CPU shards are named with ``devices=``).  A mesh
across processes or hosts, and the process group it would run on, are not
built yet (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

from typing import Optional

import torch


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """The process layout of this run: one process, which drives every
    device of its host through ``data_mesh()``.  ``num_processes > 1``
    raises NotImplementedError: no mesh spans processes yet (ROADMAP queue
    1 item 16).

    Returns the same keys as ``sfm_tpu``'s: process_index, process_count,
    local_devices (CUDA devices of this process, or 1 for the CPU) and
    global_devices (local_devices x process_count).
    """
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(
            "a mesh across processes or hosts is not ported to sfm_tpu_torch "
            "yet (ROADMAP queue 1 item 16)"
        )
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": 0,
        "process_count": 1,
        "local_devices": local,
        "global_devices": local,
    }
