"""Slab-gather descriptor sampler: gather + bilinear-sample + normalize.

Counterpart of ``sfm_tpu/ops/gather.py``.  ``sample_normalized_patches`` is
the wrapper of kernel K2 (``csrc/gather.cu``, replacing the Pallas slab
kernel); its plain version is ``normalize_descriptors(
bilinear_sample_patches_stack(gray.float(), ...))`` cast to bf16.  The
TPU kernel's row/lane slab packing and sample chunking are Mosaic
artifacts and have no counterpart: the CUDA kernel computes each window's
origin from (image, cx, cy) itself.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops._launch import check_launch, on_cpu, stream_of
from sfm_tpu_torch.ops.ncc import _inbounds, bilinear_sample_patches_stack
from sfm_tpu_torch.ops.patches import normalize_descriptors
from sfm_tpu_torch.utils.build import kernel_library

MAX_WID = 8  # the kernel keeps <= 10 values of a (2*8+1)^2 patch per lane


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
    CUDA tensors go through kernel K2 (counted in
    ``sample_normalized_patches.launches``); CPU tensors through the plain
    version.
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
    else:
        desc = torch.empty((m, side * side), dtype=torch.bfloat16,
                           device=gray.device)
        if m:
            err = kernel_library().sample_normalized_patches_bf16(
                gray.data_ptr(), img.data_ptr(), ctr.data_ptr(),
                desc.data_ptr(), m, n, h, w, wid, stream_of(gray),
            )
            check_launch("sample_normalized_patches", err)
            sample_normalized_patches.launches += 1
    inb = _inbounds(ctr[:, 0], ctr[:, 1], h, w, wid)
    return desc.reshape(*batch_shape, side * side), inb.reshape(batch_shape)


sample_normalized_patches.launches = 0
