"""BT.601 grayscale of a uint8 RGB stack, rounded to whole numbers.

``rgb_to_gray`` is the wrapper of kernel K4 (``csrc/gray.cu``), which does
on the card what ``io/images.py:gray_tensor`` does on the host:
``np.rint(to_gray(images)).astype(np.uint8)`` as float32.  Its plain
version, ``_gray_plain``, is the same arithmetic in separate elementwise
ops; both are bit-equal to the host conversion on every RGB triple.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops._launch import check_launch, launch_on, on_cpu
from sfm_tpu_torch.utils.build import kernel_library

# to_gray's weights as the float32 values NumPy multiplies by.
_WEIGHTS = (0.299, 0.587, 0.114)


def _gray_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: each product and sum rounded to float32 on its
    own, in ``to_gray``'s order, then rounded half to even (``np.rint``)."""
    x = rgb.float()
    wr, wg, wb = (torch.tensor(c, dtype=torch.float32) for c in _WEIGHTS)
    return torch.round(x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Gray (N, H, W) float32, whole numbers in 0..255, of a uint8
    (N, H, W, 3) RGB stack.

    CUDA tensors go through kernel K4 (counted in ``rgb_to_gray.launches``);
    CPU tensors through the plain version.
    """
    if rgb.dim() != 4 or rgb.shape[-1] != 3 or rgb.dtype != torch.uint8:
        raise TypeError(
            f"rgb_to_gray needs (N, H, W, 3) uint8, got "
            f"{tuple(rgb.shape)} {rgb.dtype}"
        )
    if on_cpu("rgb_to_gray", rgb):
        return _gray_plain(rgb)
    n, h, w, _ = rgb.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=rgb.device)
    if rgb.numel():
        with launch_on(rgb) as stream:
            err = kernel_library().rgb_to_gray_f32(
                rgb.data_ptr(), out.data_ptr(), n, h, w, stream,
            )
        check_launch("rgb_to_gray", err)
        rgb_to_gray.launches += 1
    return out


rgb_to_gray.launches = 0
