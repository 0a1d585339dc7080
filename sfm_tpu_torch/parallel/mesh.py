"""Device mesh: one controller driving a tuple of devices.

Counterpart of ``sfm_tpu/parallel/mesh.py``.  The JAX package builds a 1-D
``Mesh`` over ``jax.devices()`` with one axis, "data", and shards bulk
per-observation / per-candidate work along it with ``shard_map``, summing
replicated state with ``psum``.  Here one process drives a ``DataMesh``: a
tuple of torch devices along the same axis.  A stage splits its batch with
``split``, runs each shard on the shard's device (launches are asynchronous,
so the devices overlap), and reassembles with ``gather`` or ``psum``.
These methods are the only code that moves data between devices, so a
process-group backend can stand in for them later without touching the
stages.  A stage called without a mesh runs on a mesh of its one device,
where these methods move nothing: there is one code path.

A mesh may name one device more than once ("virtual shards", the
counterpart of XLA's simulated host devices): the tests run 8 shards on the
CPU, and ``chip_smoke.py`` runs 4 shards on one GPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DataMesh:
    """A 1-D mesh: ``devices`` along the "data" axis, shard i on
    ``devices[i]``; ``devices[0]`` is the lead device, where gathered
    results and sums land."""

    def __init__(self, devices: Sequence):
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.shape = {DATA_AXIS: len(devs)}

    @property
    def size(self) -> int:
        return len(self.devices)

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
            if len(t) != self.size:
                raise ValueError(f"{len(t)} replicas for a mesh of {self.size}")
            return t
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = t if t.device == d else t.to(d)
        return [copies[d] for d in self.devices]

    def split(self, x: torch.Tensor, fill=0):
        """Pad ``x``'s leading axis with ``fill`` to a multiple of the
        shards, cut it into equal consecutive slices and move slice i to
        shard i's device.  One shard takes ``x`` itself."""
        if self.size == 1:
            return [x.to(self.lead)]
        n = x.shape[0]
        per = shard_batch(n, self.size)
        pad = per * self.size - n
        if pad:
            x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
        return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(self.devices)]

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
    mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_mesh: no CUDA device is visible; pass devices= for a "
                "mesh of other devices (devices=[torch.device('cpu')] * k "
                "for CPU shards)"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return DataMesh(devices)


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
