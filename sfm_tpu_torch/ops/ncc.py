"""NCC scoring and bilinear patch sampling.

Counterpart of ``sfm_tpu/ops/ncc.py``.  ``ncc_scores`` is the matcher's
all-pairs correlation: one f32 matrix product (``torch.matmul``; the JAX
package leaves it to XLA too, outside any Pallas kernel).
``bilinear_sample_patches_stack`` is the plain version of the slab-gather
sampler (kernel K2, ops/gather.py) before normalization.
"""

from __future__ import annotations

import torch


def ncc_scores(desc1, desc2):
    """(..., K1, D) x (..., K2, D) -> (..., K1, K2) correlation, f32."""
    return torch.matmul(desc1, desc2.transpose(-1, -2))


def _inbounds(x, y, h, w, wid):
    return (x >= wid + 1) & (x <= w - wid - 2) & (y >= wid + 1) & (y <= h - wid - 2)


def bilinear_sample_patches_stack(stack, img_idx, centers, wid: int = 5):
    """Sample (2*wid+1)^2 patches at fractional (x, y) centers with bilinear
    interpolation, each from its own image of an (N, H, W) stack.
    img_idx (...,) int; centers (..., 2) float.  The (side+1)^2 window is
    clipped inside the image (in-bounds mask: whole patch plus support).

    Returns (patches (..., side^2) float32, inbounds (...,) bool).
    """
    batch_shape = img_idx.shape
    n, h, w = stack.shape
    side = 2 * wid + 1
    ctr = centers.reshape(-1, 2)
    img = img_idx.reshape(-1).long().clamp(0, n - 1)
    x = ctr[:, 0]
    y = ctr[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).float()[:, None, None]
    fy = (y - y0).float()[:, None, None]
    # Fold (image, row) into one axis; windows never cross an image since
    # the row origin is clipped inside it.
    base_x = (x0.long() - wid).clamp(0, w - side - 1)
    base_y = (y0.long() - wid).clamp(0, h - side - 1) + img * h
    off = torch.arange(side + 1, device=stack.device)
    window = stack.reshape(n * h, w)[
        (base_y[:, None] + off)[:, :, None], (base_x[:, None] + off)[:, None, :]
    ]
    p00 = window[:, :side, :side]
    p01 = window[:, :side, 1:]
    p10 = window[:, 1:, :side]
    p11 = window[:, 1:, 1:]
    val = (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )
    return (
        val.reshape(*batch_shape, side * side).float(),
        _inbounds(x, y, h, w, wid).reshape(batch_shape),
    )
