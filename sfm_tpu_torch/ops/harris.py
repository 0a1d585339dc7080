"""Harris corner response + detection, batched over images.

Counterpart of ``sfm_tpu/ops/harris.py``.  ``harris_response`` is the
wrapper of kernel K1 (``csrc/harris.cu``, replacing the Pallas
``_harris_kernel``); its plain PyTorch version is ``_harris_math``.

One border convention: the kernel computes exactly what ``_harris_math``
computes — zero-filled neighbours everywhere, no forced-zero columns.  (The
TPU kernel also zeroes columns 0, 1, W-2, W-1; ``detect_corners`` takes the
per-image max over the whole image, so a second convention would move the
threshold.)
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops._launch import check_launch, on_cpu, stream_of, use_kernel
from sfm_tpu_torch.utils.build import kernel_library

_INT32_MIN = -(2 ** 31)


def _shift(img, dy, dx):
    """Shift a (..., H, W) image by (dy, dx), zero-filled."""
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad(img, (1, 1, 1, 1))
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel(gray):
    tl = _shift(gray, -1, -1)
    tc = _shift(gray, -1, 0)
    tr = _shift(gray, -1, 1)
    ml = _shift(gray, 0, -1)
    mr = _shift(gray, 0, 1)
    bl = _shift(gray, 1, -1)
    bc = _shift(gray, 1, 0)
    br = _shift(gray, 1, 1)
    ix = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    iy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return ix, iy


def _box3(img):
    return (
        _shift(img, -1, -1) + _shift(img, -1, 0) + _shift(img, -1, 1)
        + _shift(img, 0, -1) + img + _shift(img, 0, 1)
        + _shift(img, 1, -1) + _shift(img, 1, 0) + _shift(img, 1, 1)
    )


def _harris_math(gray, k):
    """Plain version of K1: Sobel, 3x3 box sums, R = det - k trace^2.

    Rounds as the JAX package's ``_harris_math`` does once XLA:CPU contracts
    it into fused multiply-adds: det = fma(sxx, syy, -round(sxy^2)) and
    R = fma(-round(k trace), trace, det).  Each fma is evaluated in float64
    and rounded once to float32; for integer gray values (0..255) the
    float64 intermediates are exact, so this is the fma bit for bit (and
    what kernel K1 computes with ``__fmaf_rn``).
    """
    ix, iy = _sobel(gray)
    sxx = _box3(ix * ix)
    syy = _box3(iy * iy)
    sxy = _box3(ix * iy)
    det = (sxx.double() * syy.double() - (sxy * sxy).double()).float()
    trace = sxx + syy
    kt = k * trace
    return (det.double() - kt.double() * trace.double()).float()


def harris_response(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response (N, H, W) float32 of a float32 (N, H, W) stack.

    CUDA tensors go through kernel K1 (counted in ``harris_response.launches``);
    CPU tensors through the plain version.
    """
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise TypeError(
            f"harris_response needs (N, H, W) float32, got "
            f"{tuple(gray.shape)} {gray.dtype}"
        )
    if on_cpu("harris_response", gray):
        return _harris_math(gray, k)
    n, h, w = gray.shape
    out = torch.empty_like(gray)
    if gray.numel():
        err = kernel_library().harris_response_f32(
            gray.data_ptr(), out.data_ptr(), n, h, w, ctypes.c_float(k),
            stream_of(gray),
        )
        check_launch("harris_response", err)
        harris_response.launches += 1
    return out


harris_response.launches = 0


def _running_max(x, r, dim):
    """Max over a centred window of 2r+1 along ``dim``, INT32_MIN padding."""
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [r, r]
    p = F.pad(x, pad, value=_INT32_MIN)
    n = x.shape[dim]
    out = p.narrow(dim, 0, n)
    for d in range(1, 2 * r + 1):
        out = torch.maximum(out, p.narrow(dim, d, n))
    return out


def detect_corners(
    gray,
    max_corners: int = 4096,
    nms_radius: int = 4,
    rel_threshold: float = 0.01,
    border: int = 0,
    k: float = 0.04,
    kernels=None,
):
    """Detect top-K Harris corners per image.

    Args:
      gray: (N, H, W) float32 grayscale stack.
      max_corners: corner capacity K per image.
      nms_radius: non-max-suppression radius (pixels).
      rel_threshold: keep responses > rel_threshold * per-image max.
      border: reject corners within this many pixels of the edge.
      kernels: None follows the device (K1 on CUDA); False forces the plain
        response on any device.

    Returns:
      corners (N, K, 2) int32 (x, y) sorted by response; valid (N, K) bool;
      response (N, H, W) float32.
    """
    if use_kernel(gray, kernels):
        resp = harris_response(gray, k)
    else:
        resp = _harris_math(gray, k)
    n, h, w = resp.shape
    win = 2 * nms_radius + 1
    # NMS on per-pixel-unique keys: the f32 response bitcast to int32 (order
    # preserving for non-negative floats) with its low bits replaced by a
    # pixel id, so equal responses break ties by id and each window has one
    # peak.  Same key as the JAX package, bit for bit.
    id_bits = max(((win - 1) * (w + 1) + 1).bit_length(), 1)
    if id_bits > 18:
        raise ValueError(
            f"NMS tie-break id field needs {id_bits} bits for width {w} "
            f"(nms_radius={nms_radius}); more than 18 would corrupt the "
            "response ordering"
        )
    id_mask = (1 << id_bits) - 1
    pos = torch.clamp_min(resp, 0.0) + 1e-30
    bits = pos.view(torch.int32)
    dev = resp.device
    pix_id = (
        torch.arange(h, dtype=torch.int32, device=dev)[:, None] * w
        + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    )
    key = (bits & ~id_mask) | (pix_id & id_mask)
    pooled = _running_max(_running_max(key, nms_radius, 1), nms_radius, 2)
    peak = key == pooled
    maxval = torch.amax(resp, dim=(1, 2), keepdim=True)
    mask = peak & (resp > rel_threshold * maxval)
    if border > 0:
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        mask = mask & inb[None]
    scored = torch.where(mask, resp, torch.full_like(resp, float("-inf")))
    # Stable descending sort = jax.lax.top_k's order: among equal values
    # (the many -inf slots) the lower index comes first.
    vals, idx = torch.sort(scored.reshape(n, h * w), dim=1, descending=True,
                           stable=True)
    vals = vals[:, :max_corners]
    idx = idx[:, :max_corners]
    corners = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    return corners, torch.isfinite(vals), resp
