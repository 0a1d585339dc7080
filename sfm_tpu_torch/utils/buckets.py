"""The JAX package's image-count bucket, for its checkpoint format.

A copy of ``sfm_tpu.utils.buckets.bucket_images``, which the port cannot
import.  ``sfm_tpu`` pads the image axis of its MVS stage to this count when
``shape_buckets`` is on (to reuse compiled programs), so its mid-MVS state
file is that wide; the port computes on the real count and only reads and
writes the padded width (``mvs/pipeline.py``).  The rest of the bucketing
machinery exists to avoid XLA recompiles and is not ported.
"""

from __future__ import annotations


def bucket_images(n: int) -> int:
    """Image-count bucket: exact up to 8, then the next multiple of 8
    (12 -> 16, 48 -> 48, 50 -> 56)."""
    if n <= 8:
        return n
    return -(-n // 8) * 8
