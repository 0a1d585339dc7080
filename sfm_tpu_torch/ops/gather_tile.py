"""Tile-resident descriptor sampler: K2's function from staged windows.

Counterpart of ``tools/prof_tile.py:make_gather_kernel``, the Pallas kernel
of the tile-resident gather experiments that sized K2 on the TPU.
``sample_normalized_patches_tiled`` is the wrapper of kernel K3
(``csrc/gather_tile.cu``): a block brings ``samples_per_block`` samples'
windows into shared memory with asynchronous copies, waits, and extracts and
normalises from there; with ``double_buffer`` the next step's copies are in
flight while a step is processed; with ``extract=False`` it only copies the
staged window's first side x side values out (the cost of the copies alone).

The TPU tool's ``gather_params`` (8-row ``row8``/``dy``, 128-lane
``x_al``/``x_rem``, operands packed to SMEM 1024-blocks) has no counterpart:
the kernel derives each window's origin and fractions from (image, cx, cy).
Its extraction variants ``extract`` = 2, 3, 4 computed the same values as
``extract=True`` and differed only in how Mosaic was made to shift rows and
lanes (row select first, a sublane roll, one batched cast); shared memory is
indexed directly, so they collapse to the one extraction here.

The plain versions are in this module too: ``_sample_plain`` of
``ops/gather.py`` for the full modes (K3 shares K2's arithmetic, so also
K2's plain version) and ``_copy_plain`` for the copy-only mode.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops._launch import check_launch, launch_on, on_cpu
from sfm_tpu_torch.ops.gather import MAX_WID, _sample_plain
from sfm_tpu_torch.utils.build import kernel_library

MAX_SAMPLES_PER_BLOCK = 256  # the kernel's block size: one thread derives one window


def _copy_plain(gray, img, ctr, wid):
    """Plain version of the copy-only mode on flat (M,) img / (M, 2) ctr:
    the first side x side values of each sample's window, (M, side^2) bf16.
    The window origin is clamped in float (NaN reads at 0), as the kernels
    take it."""
    n, h, w = gray.shape
    side = 2 * wid + 1
    img = img.long().clamp(0, n - 1)

    def origin(c, dim):
        o = torch.nan_to_num(torch.floor(c) - wid, nan=0.0)
        return o.clamp(0, dim - side - 1).long()

    bx = origin(ctr[:, 0], w)
    by = origin(ctr[:, 1], h) + img * h
    off = torch.arange(side, device=gray.device)
    window = gray.reshape(n * h, w)[
        (by[:, None] + off)[:, :, None], (bx[:, None] + off)[:, None, :]
    ]
    return window.reshape(-1, side * side)


def sample_normalized_patches_tiled(
    gray, img_idx, centers, wid: int = 5, *, samples_per_block: int = 32,
    double_buffer: bool = True, extract: bool = True,
):
    """K2's descriptors through shared-memory tiles (kernel K3).

    Args:
      gray: (N, H, W) bfloat16 grayscale stack.
      img_idx: (M,) int32 image index per sample.
      centers: (M, 2) float32 (x, y) patch centers.
      wid: half-width (<= 8); patch side = 2*wid+1.
      samples_per_block: S, the windows a block stages per step (1..256).
      double_buffer: start step i+1's copies before processing step i.
      extract: True interpolates and normalises (``sample_normalized_patches``'s
        descriptors); False copies each window's first side x side values
        out unchanged.

    Returns (M, side^2) bf16.  CUDA tensors go through kernel K3 (counted in
    ``sample_normalized_patches_tiled.launches``); CPU tensors through the
    plain version.
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
    if img_idx.dim() != 1 or centers.shape != (img_idx.shape[0], 2):
        raise ValueError(
            f"img_idx must be (M,) and centers (M, 2), got "
            f"{tuple(img_idx.shape)} / {tuple(centers.shape)}"
        )
    n, h, w = gray.shape
    side = 2 * wid + 1
    if not 0 <= wid <= MAX_WID or h < side + 1 or w < side + 1:
        raise ValueError(f"wid={wid} unsupported for {h}x{w} images")
    if not 1 <= samples_per_block <= MAX_SAMPLES_PER_BLOCK:
        raise ValueError(
            f"samples_per_block={samples_per_block} outside "
            f"1..{MAX_SAMPLES_PER_BLOCK}"
        )
    m = img_idx.shape[0]
    if on_cpu("sample_normalized_patches_tiled", gray, img_idx, centers):
        plain = _sample_plain if extract else _copy_plain
        return plain(gray, img_idx, centers, wid)
    out = torch.empty((m, side * side), dtype=torch.bfloat16,
                      device=gray.device)
    if m:
        with launch_on(gray) as stream:
            err = kernel_library().sample_normalized_patches_tiled_bf16(
                gray.data_ptr(), img_idx.data_ptr(), centers.data_ptr(),
                out.data_ptr(), m, n, h, w, wid, samples_per_block,
                int(bool(double_buffer)), int(bool(extract)), stream,
            )
        check_launch("sample_normalized_patches_tiled", err)
        sample_normalized_patches_tiled.launches += 1
    return out


sample_normalized_patches_tiled.launches = 0
