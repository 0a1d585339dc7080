"""Image loading and the grayscale device stack.

``load_images`` globs ``{dir}/*.{type}``, sorts, and stacks RGB uint8 (PIL
is imported there only: the rest of the package runs without it).
``gray_tensor`` converts: grayscale is computed and rounded to uint8 on the
host, then converted to float32 on the device.  ``device_gray`` is the
counterpart of ``sfm_tpu``'s: the same conversion, cached per process so
the SfM and MVS stages share one conversion and one upload.
"""

from __future__ import annotations

import glob
import os
import weakref
import zlib
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


_DEVICE_CACHE: dict = {}


def _cache_key(images: np.ndarray):
    """Identity plus content: shape, dtype, data pointer and a CRC over a
    ~64k-element stride sample, as ``sfm_tpu.io.images._cache_key`` (id
    reuse after garbage collection or an in-place edit never aliases)."""
    a = np.asarray(images)
    flat = a.reshape(-1) if a.flags.c_contiguous else np.ascontiguousarray(a).reshape(-1)
    sample = flat[:: max(1, flat.size // 65536)]
    return (
        id(images), a.shape, a.dtype.str, a.ctypes.data,
        zlib.crc32(np.ascontiguousarray(sample).tobytes()),
    )


def device_gray(images: np.ndarray, device) -> torch.Tensor:
    """``gray_tensor(images, device)``, computed once per process.

    Keyed on the host array's identity and content (``_cache_key``) and the
    device; an entry is evicted when the host array is garbage-collected.
    Callers must not write into the returned tensor.
    """
    device = torch.device(device)
    key = _cache_key(images) + (str(device),)
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    gray = gray_tensor(images, device)
    _DEVICE_CACHE[key] = gray
    try:
        weakref.finalize(images, _DEVICE_CACHE.pop, key, None)
    except TypeError:
        pass  # not weak-referenceable: the content key still prevents aliasing
    return gray
