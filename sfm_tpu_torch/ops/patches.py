"""Patch extraction + descriptor normalization.

Counterpart of ``sfm_tpu/ops/patches.py``: square grayscale patches of side
2*wid+1 around integer corners, normalized to zero-mean unit-norm so that
NCC between two descriptors is a plain dot product.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def extract_patches(gray, corners, wid: int = 5):
    """Gather square patches around integer corner coordinates.

    Args:
      gray: (N, H, W) grayscale stack.
      corners: (N, K, 2) int (x, y) positions.
      wid: half-width; patch side = 2*wid+1.

    Returns:
      patches (N, K, (2*wid+1)**2) float32, row-major; inbounds (N, K) bool.
    """
    n, h, w = gray.shape
    k = corners.shape[1]
    side = 2 * wid + 1
    x = corners[..., 0].long()
    y = corners[..., 1].long()
    inb = (x >= wid) & (x < w - wid) & (y >= wid) & (y < h - wid)
    # The (image, row) axes fold into one.  Out-of-border corners (inb
    # False, masked by the caller) read defined values: starts wrap when
    # negative and then clamp, as jax.lax.dynamic_slice's do, so even their
    # patches equal the JAX package's.
    flat = gray.reshape(n * h, w)
    img = torch.arange(n, device=gray.device).repeat_interleave(k)

    def start(s, size):
        return torch.where(s < 0, s + size, s).clamp(0, size - side)

    row = start(img * h + y.reshape(-1) - wid, n * h)
    col = start(x.reshape(-1) - wid, w)
    off = torch.arange(side, device=gray.device)
    patches = flat[(row[:, None] + off)[:, :, None], (col[:, None] + off)[:, None, :]]
    return patches.reshape(n, k, side * side).float(), inb


def normalize_descriptors(patches):
    """Zero-mean, unit-L2 normalize flattened patches (last axis).

    The mean is the sum times the f32 reciprocal of the length, as XLA
    computes ``jnp.mean`` (a constant patch then normalizes to the JAX
    package's values too).
    """
    mean = patches.sum(dim=-1, keepdim=True) * (1.0 / patches.shape[-1])
    c = patches - mean
    norm = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True))
    return c / torch.clamp_min(norm, _EPS)
