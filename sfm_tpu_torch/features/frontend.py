"""Feature frontend: Harris corners + NCC patch descriptors for all images.

Counterpart of ``sfm_tpu/features/frontend.py``.  With kernels on: K1 (the
Harris response) then K2 (the slab-gather sampler) at integer centers,
whose bf16 descriptors are cast to f32.  With kernels off: the plain
response, then integer patch extraction + normalization in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sfm_tpu_torch.config import FeatureConfig
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.ops.gather import sample_normalized_patches
from sfm_tpu_torch.ops.harris import detect_corners
from sfm_tpu_torch.ops.patches import extract_patches, normalize_descriptors


@dataclass
class FeatureSet:
    """Corners + descriptors for N images (tensors on one device).

    corners: (N, K, 2) int32 (x, y); valid: (N, K) bool;
    descriptors: (N, K, D) float32 zero-mean unit-norm (zero where invalid).
    """

    corners: torch.Tensor
    valid: torch.Tensor
    descriptors: torch.Tensor

    @property
    def num_images(self) -> int:
        return self.corners.shape[0]

    @property
    def capacity(self) -> int:
        return self.corners.shape[1]


def detect_and_describe(
    gray: torch.Tensor, config: FeatureConfig = FeatureConfig(), kernels=None
) -> FeatureSet:
    """(N, H, W) float32 grayscale -> FeatureSet with top-K corners per image.

    ``kernels``: None follows the device (kernels on CUDA); False runs the
    plain versions on any device.
    """
    kern = use_kernel(gray, kernels)
    # border = wid + 1: every surviving corner's window (with the bilinear
    # sampler's extra pixel) is strictly interior, so both descriptor paths
    # cut the same patches.
    corners, valid, _ = detect_corners(
        gray,
        max_corners=config.max_corners,
        nms_radius=config.nms_radius,
        rel_threshold=config.harris_rel_threshold,
        border=config.desc_wid + 1,
        k=config.harris_k,
        kernels=kern,
    )
    if kern:
        n, k = corners.shape[0], corners.shape[1]
        img_idx = (
            torch.arange(n, dtype=torch.int32, device=gray.device)[:, None]
            .expand(n, k).contiguous()
        )
        desc, inb = sample_normalized_patches(
            gray.to(torch.bfloat16), img_idx, corners.float(), config.desc_wid
        )
        desc = desc.float()
    else:
        patches, inb = extract_patches(gray, corners, wid=config.desc_wid)
        desc = normalize_descriptors(patches)
    valid = valid & inb
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    return FeatureSet(corners=corners, valid=valid, descriptors=desc)
