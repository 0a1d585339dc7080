"""Image loading and the grayscale device stack.

``load_images`` globs ``{dir}/*.{type}``, sorts, and stacks RGB uint8 (PIL
is imported there only: the rest of the package runs without it).
``gray_tensor`` is the counterpart of ``sfm_tpu``'s ``device_gray``:
grayscale is computed and rounded to uint8 on the host, then converted to
float32 on the device.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch


def load_images(
    image_dir: str,
    image_type: str = "png",
    max_images: Optional[int] = None,
) -> Tuple[np.ndarray, List[str]]:
    """Load ``image_dir/*.{image_type}`` sorted by name.

    Returns (images uint8 (N, H, W, 3), list of file paths).
    """
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(image_dir, f"*.{image_type}")))
    if max_images is not None:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no *.{image_type} images in {image_dir}")
    imgs = []
    for p in paths:
        with Image.open(p) as im:
            imgs.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
    shapes = {a.shape for a in imgs}
    if len(shapes) != 1:
        raise ValueError(f"images have differing shapes: {shapes}")
    return np.stack(imgs), paths


def to_gray(images: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., H, W, 3) -> float32 grayscale (..., H, W) in [0, 255].

    ITU-R BT.601 weights, bit-for-bit the JAX package's ``to_gray``.
    """
    img = images.astype(np.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def gray_tensor(images: np.ndarray, device) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> float32 (N, H, W) on ``device``.

    Rounded to uint8 on the host (what the reference's cv2.cvtColor gives),
    shipped as uint8 (3x less traffic than RGB) and converted there.  Every
    value is an integer in 0..255, which keeps the Harris sums exact.
    """
    gray_u8 = np.rint(to_gray(images)).astype(np.uint8)
    return torch.from_numpy(gray_u8).to(device).float()
