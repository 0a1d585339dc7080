"""Device mesh: one controller driving a tuple of devices.

Counterpart of ``sfm_tpu/parallel/mesh.py``.  The JAX package builds a 1-D
``Mesh`` over ``jax.devices()`` with one axis, "data", and shards bulk
per-observation / per-candidate work along it with ``shard_map``, summing
replicated state with ``psum``.  Here one process drives a ``DataMesh``: a
tuple of torch devices along the same axis.  A stage splits its batch with
``split``, runs each shard on the shard's device (launches are asynchronous,
so the devices overlap), and reassembles with ``gather`` or ``psum``.
These methods are the only code that moves data between devices.  A stage
called without a mesh runs on a mesh of its one device, where these
methods move nothing: there is one code path.

A mesh may name one device more than once ("virtual shards", the
counterpart of XLA's simulated host devices): the tests run 8 shards on the
CPU, and the card tests (``tests/test_torch_*_cuda.py``) 4 on one GPU.

``GroupMesh`` is the same mesh across the processes of a
``torch.distributed`` group (``distributed.initialize_multihost``), as
JAX's mesh spans the processes after ``jax.distributed``: ``data_mesh()``
returns one whenever a group is initialized.  Each process drives its own
shards and runs the same program on the same inputs (SPMD); ``gather`` and
``psum`` all-gather the shards' results, so every process holds the same
result, bit for bit that of a single-controller mesh of as many shards.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DataMesh:
    """A 1-D mesh: ``devices`` along the "data" axis, shard i on
    ``devices[i]``; ``devices[0]`` is the lead device, where gathered
    results and sums land.  One process drives every shard: it is
    process 0, and its ``local_devices`` are all the ``devices``."""

    process_index = 0

    def __init__(self, devices: Sequence):
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = self.local_devices = devs
        self.shape = {DATA_AXIS: len(devs)}

    @property
    def size(self) -> int:
        """The shard count of the whole mesh (what batches are padded to)."""
        return self.shape[DATA_AXIS]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"

    def replicate(self, t):
        """One copy of ``t`` per distinct device, listed per shard: virtual
        shards on one device share one copy, and a shard on ``t``'s own
        device gets ``t`` itself.  A list that already holds one tensor per
        shard (an earlier ``replicate``) is returned as it is."""
        if isinstance(t, list):
            if len(t) != len(self.local_devices):
                raise ValueError(f"{len(t)} replicas for {len(self.local_devices)} "
                                 "local shards")
            return t
        copies = {}
        for d in self.local_devices:
            if d not in copies:
                copies[d] = t if t.device == d else t.to(d)
        return [copies[d] for d in self.local_devices]

    def split(self, x: torch.Tensor, fill=0):
        """Pad ``x``'s leading axis with ``fill`` to a multiple of the
        shards, cut it into equal consecutive slices and move slice i to
        shard i's device; a process of a group keeps only its own shards'
        slices (every process holds all of ``x``).  One shard takes ``x``
        itself."""
        if self.size == 1:
            return [x.to(self.lead)]
        n = x.shape[0]
        per = shard_batch(n, self.size)
        pad = per * self.size - n
        if pad:
            x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
        first = self.process_index * len(self.local_devices)
        return [x[i * per:(i + 1) * per].to(d)
                for i, d in enumerate(self.local_devices, start=first)]

    def gather(self, parts, n: int) -> torch.Tensor:
        """Concatenate per-shard results on the lead device and drop the
        pad rows beyond ``n`` (one shard's result is returned as it is)."""
        if len(parts) == 1:
            return parts[0].to(self.lead)[:n]
        return torch.cat([p.to(self.lead) for p in parts])[:n]

    def psum(self, parts) -> torch.Tensor:
        """Sum per-shard partials on the lead device, in shard order (a
        fixed order: no atomics, the same bits on every run)."""
        acc = parts[0].to(self.lead)
        for p in parts[1:]:
            acc = acc + p.to(self.lead)
        return acc

    def barrier(self) -> None:
        """Wait for the mesh's other processes (none here)."""


# Element types a GroupMesh moves: a header names one by its index here.
_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
           torch.int64, torch.float16, torch.bfloat16, torch.float32,
           torch.float64)
_MAX_DIMS = 8


def device_identity(device: torch.device):
    """(host name, device) naming one physical device: a CUDA device by
    its UUID, which two processes see alike whatever their device order."""
    if device.type == "cuda":
        return socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid)
    return socket.gethostname(), str(device)


class GroupMesh(DataMesh):
    """A ``DataMesh`` across the processes of the initialized
    ``torch.distributed`` group: ``devices`` are this process's shards,
    the same count in every process, and process r's shard j is global
    shard ``r * len(devices) + j`` (rank-major).  ``size`` counts every
    process's shards; ``lead`` is this process's first device, where every
    process runs the lead-side work on the gathered results.

    ``gather`` and ``psum`` all-gather the local results as raw bytes
    (bit-exact for every element type; through host memory on gloo) after
    an all-gather of their shapes, so parts whose shape differs between
    processes raise ValueError on every process instead of a mismatched
    collective.  ``psum`` then adds all the partials in global shard order
    on every process, as ``DataMesh.psum`` does: no ``all_reduce``, whose
    order depends on the backend and the layout.  Neither takes the
    one-shard shortcut: a group mesh communicates whatever its size.

    Construction is collective.  Processes that disagree on their shard
    count raise ValueError, and so does an NCCL group that puts two
    processes on one GPU (NCCL would refuse it at the first collective,
    deep in a stage); that check and ``barrier`` go over gloo (the group
    itself, or a gloo side group of an NCCL group).
    """

    def __init__(self, devices: Sequence):
        super().__init__(devices)
        self.process_index = dist.get_rank()
        self.process_count = dist.get_world_size()
        self.backend = str(dist.get_backend())
        nccl = "nccl" in self.backend
        self._host_group = dist.new_group(backend="gloo") if nccl else None
        self._transport = self.lead if nccl else torch.device("cpu")
        mine = (len(self.local_devices), device_identity(self.lead))
        seen = [None] * self.process_count
        dist.all_gather_object(seen, mine, group=self._host_group)
        counts = [c for c, _ in seen]
        if len(set(counts)) != 1:
            raise ValueError(
                f"processes disagree on their local shard counts {counts}: "
                "every process of a mesh drives as many shards"
            )
        idents = [i for _, i in seen]
        if nccl and len(set(idents)) != len(idents):
            raise ValueError(
                f"NCCL group places two processes on one GPU ({idents}); "
                "NCCL refuses that: give each process its own GPU, or "
                "initialize the group with backend='gloo'"
            )
        self.shape = {DATA_AXIS: counts[0] * self.process_count}

    def __repr__(self) -> str:
        return (f"GroupMesh(process {self.process_index} of "
                f"{self.process_count}, {[str(d) for d in self.devices]}, "
                f"{self.backend})")

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` concatenated along a new leading axis in
        rank order, on the lead device."""
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"a {t.dim()}-dim part; a mesh moves at most {_MAX_DIMS}")
        head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
        head[0], head[1] = t.dim(), _DTYPES.index(t.dtype)
        head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        heads = [torch.empty_like(head, device=self._transport)
                 for _ in range(self.process_count)]
        dist.all_gather(heads, head.to(self._transport))
        heads = torch.stack(heads).cpu()
        if not bool((heads == heads[0]).all()):
            raise ValueError(
                "mesh parts differ between processes (dims, dtype index, "
                f"shape per process: {heads.tolist()}); every shard's part "
                "must have one shape"
            )
        n_bytes = t.numel() * t.element_size()
        out_shape = (self.process_count, *t.shape)
        if n_bytes == 0:
            return t.new_empty(out_shape, device=self.lead)
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        raw = raw.to(self._transport)
        bufs = [torch.empty_like(raw) for _ in range(self.process_count)]
        dist.all_gather(bufs, raw)
        return torch.cat(bufs).to(self.lead).view(t.dtype).reshape(out_shape)

    def gather(self, parts, n: int) -> torch.Tensor:
        """Every shard's part, concatenated in global shard order on the
        lead device of every process, without the pad rows beyond ``n``."""
        local = torch.cat([p.to(self.lead) for p in parts])
        every = self._all_gather(local)
        return every.flatten(0, 1)[:n]

    def psum(self, parts) -> torch.Tensor:
        """Every shard's partial, summed in global shard order on the lead
        device of every process."""
        every = self._all_gather(torch.stack([p.to(self.lead) for p in parts]))
        every = every.flatten(0, 1)
        acc = every[0]
        for p in every[1:]:
            acc = acc + p
        return acc

    def barrier(self) -> None:
        """Wait for every process of the group (over gloo)."""
        dist.barrier(group=self._host_group)


def data_mesh(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> DataMesh:
    """1-D mesh over the data axis: ``devices``, by default every visible
    CUDA device; without ``devices`` and without a CUDA device it raises
    RuntimeError (a CPU mesh is asked for by name:
    ``devices=[torch.device("cpu")] * k``).  ``num_devices`` keeps the
    first ``num_devices`` of them (as ``sfm_tpu``'s
    ``devices[:num_devices]``: on one GPU, 4 asked gives a 1-device
    mesh).

    With a ``torch.distributed`` group initialized the mesh spans the
    group (a ``GroupMesh``; every process calls this): ``devices`` names
    this process's shards, by default ``cuda:(rank % device_count)``.
    ``num_devices`` below the group's shard count raises ValueError on
    every process, since processes cannot be cut out of an SPMD mesh."""
    group = dist.is_initialized()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_mesh: no CUDA device is visible; pass devices= for a "
                "mesh of other devices (devices=[torch.device('cpu')] * k "
                "for CPU shards)"
            )
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", dist.get_rank() % count)] if group
                   else [torch.device("cuda", i) for i in range(count)])
    devices = list(devices)
    if not group:
        if num_devices is not None:
            devices = devices[:num_devices]
        return DataMesh(devices)
    mesh = GroupMesh(devices)
    if num_devices is not None and num_devices < mesh.size:
        raise ValueError(
            f"num_devices={num_devices} would cut processes out of a group "
            f"mesh of {mesh.size} shards ({mesh.process_count} processes)"
        )
    return mesh


def shard_batch(n: int, num_shards: int) -> int:
    """Per-shard padded length so ``n`` items split evenly over shards."""
    return -(-n // num_shards)


def pad_to_shards(arr: np.ndarray, num_shards: int, fill=0):
    """Pad axis 0 so it divides evenly into ``num_shards`` equal shards.

    Returns (padded array, validity mask over axis 0)."""
    n = arr.shape[0]
    per = shard_batch(n, num_shards)
    pad = per * num_shards - n
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    if pad == 0:
        return arr, mask
    pad_block = np.full((pad, *arr.shape[1:]), fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0), mask
