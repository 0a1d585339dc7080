"""Slab-gather descriptor sampler: gather + bilinear-sample + normalize.

Counterpart of ``sfm_tpu/ops/gather.py``.  ``sample_normalized_patches`` is
the wrapper of kernel K2 (``csrc/gather.cu``, replacing the Pallas slab
kernel); its plain version is ``normalize_descriptors(
bilinear_sample_patches_stack(gray.float(), ...))`` cast to bf16, with
``_inbounds`` for the mask.  On CUDA tensors a call is one device kernel:
K2 writes the descriptors and the in-bounds mask.  The
TPU kernel's row/lane slab packing and sample chunking are Mosaic
artifacts and have no counterpart: the CUDA kernel computes each window's
origin from (image, cx, cy) itself.

``sample_normalized_patches_sharded`` (K2s) is the multi-device wrapper:
the stack replicated, the samples split over a ``parallel.DataMesh``, one
K2 launch per shard on the shard's device.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops._launch import check_launch, launch_on, on_cpu
from sfm_tpu_torch.ops.ncc import _inbounds, bilinear_sample_patches_stack
from sfm_tpu_torch.ops.patches import normalize_descriptors
from sfm_tpu_torch.utils.build import kernel_library

MAX_WID = 8  # the kernel is instantiated for wid 0..8 (csrc/gather_common.cuh)


def _sample_plain(gray, img, ctr, wid):
    """Plain version of K2 on flat (M,) img / (M, 2) ctr: (M, side^2) bf16."""
    patches, _ = bilinear_sample_patches_stack(gray.float(), img, ctr, wid)
    return normalize_descriptors(patches).to(torch.bfloat16)


def sample_normalized_patches(gray, img_idx, centers, wid: int = 5):
    """Normalized bilinear patches for a batch of samples.

    Args:
      gray: (N, H, W) bfloat16 grayscale stack.
      img_idx: (...,) int32 image index per sample.
      centers: (..., 2) float32 (x, y) patch centers.
      wid: half-width (<= 8); patch side = 2*wid+1.

    Returns (desc (..., side^2) bf16 zero-mean unit-norm, inbounds (...,)
    bool: the whole patch plus its interpolation support lies inside).
    CUDA tensors go through kernel K2, which writes both outputs in one
    launch (counted in ``sample_normalized_patches.launches``); CPU tensors
    through the plain version.
    """
    if gray.dim() != 3 or gray.dtype != torch.bfloat16:
        raise TypeError(
            f"gray must be (N, H, W) bfloat16, got {tuple(gray.shape)} "
            f"{gray.dtype}"
        )
    if img_idx.dtype != torch.int32 or centers.dtype != torch.float32:
        raise TypeError(
            f"img_idx must be int32 and centers float32, got "
            f"{img_idx.dtype} / {centers.dtype}"
        )
    if centers.shape != (*img_idx.shape, 2):
        raise ValueError(
            f"centers {tuple(centers.shape)} must be img_idx "
            f"{tuple(img_idx.shape)} + (2,)"
        )
    n, h, w = gray.shape
    side = 2 * wid + 1
    if not 0 <= wid <= MAX_WID or h < side + 1 or w < side + 1:
        raise ValueError(f"wid={wid} unsupported for {h}x{w} images")
    batch_shape = img_idx.shape
    img = img_idx.reshape(-1)
    ctr = centers.reshape(-1, 2)
    m = img.shape[0]
    if on_cpu("sample_normalized_patches", gray, img, ctr):
        desc = _sample_plain(gray, img, ctr, wid)
        inb = _inbounds(ctr[:, 0], ctr[:, 1], h, w, wid)
    else:
        desc = torch.empty((m, side * side), dtype=torch.bfloat16,
                           device=gray.device)
        inb = torch.empty((m,), dtype=torch.bool, device=gray.device)
        if m:
            with launch_on(gray) as stream:
                err = kernel_library().sample_normalized_patches_bf16(
                    gray.data_ptr(), img.data_ptr(), ctr.data_ptr(),
                    desc.data_ptr(), inb.data_ptr(), m, n, h, w, wid, stream,
                )
            check_launch("sample_normalized_patches", err)
            sample_normalized_patches.launches += 1
    return desc.reshape(*batch_shape, side * side), inb.reshape(batch_shape)


sample_normalized_patches.launches = 0


def sample_shards(grays, imgs, ctrs, wid: int):
    """K2s's launch step: one ``sample_normalized_patches`` call per shard,
    shard i's samples (``imgs[i]``, ``ctrs[i]``) against its replica of the
    stack ``grays[i]``, each on that shard's device (CPU shards take the
    plain version).  Every photo-consistency sweep comes through here (a
    run without a mesh as one shard).  Returns the per-shard (desc,
    inbounds) pairs; every K2 launch is also counted in
    ``sample_normalized_patches_sharded.launches``.  Nothing here waits for
    a device, so the shards' devices overlap."""
    before = sample_normalized_patches.launches
    out = [sample_normalized_patches(g, i, c, wid)
           for g, i, c in zip(grays, imgs, ctrs)]
    sample_normalized_patches_sharded.launches += (
        sample_normalized_patches.launches - before
    )
    return out


def sample_normalized_patches_sharded(gray, img_idx, centers, wid: int, mesh):
    """K2 over a mesh: counterpart of ``sfm_tpu``'s
    ``sample_normalized_patches_sharded`` (``shard_map`` with the stack
    replicated and the samples split over the "data" axis).

    ``gray`` is the (N, H, W) bf16 stack, or the per-shard list that
    ``mesh.replicate`` made of it (a stage replicates once); ``img_idx``
    (M, ...) and ``centers`` (M, ..., 2) lie on the lead device.  The
    leading axis is padded to a multiple of the shards -- pad rows carry
    image 0 and centre (0, 0), and are sliced off again -- and each shard
    launches K2 on its slice.  Samples are independent, so the result is
    bit-equal to one ``sample_normalized_patches`` call.
    """
    m = img_idx.shape[0]
    parts = sample_shards(mesh.replicate(gray), mesh.split(img_idx),
                          mesh.split(centers), wid)
    desc = mesh.gather([d for d, _ in parts], m)
    inb = mesh.gather([b for _, b in parts], m)
    return desc, inb


sample_normalized_patches_sharded.launches = 0
