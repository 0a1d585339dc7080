"""sfm_tpu_torch — the PyTorch/CUDA port of ``sfm_tpu``.

Same layout and names as the JAX package, so each module's counterpart is
easy to find:

- ``sfm_tpu_torch.config``    — the same dataclass tree (plus ``device`` and
  the ``kernels`` switch on ``RuntimeConfig``)
- ``sfm_tpu_torch.io``        — Middlebury calibration, images, PLY export
- ``sfm_tpu_torch.geometry``  — rotations, projection, triangulation, epipolar
- ``sfm_tpu_torch.ops``       — Harris response and slab-gather sampler, each
  a hand-written CUDA kernel (``csrc/``) beside its plain PyTorch version
- ``sfm_tpu_torch.features``  — corner detection, descriptors, matcher
- ``sfm_tpu_torch.sfm``       — RANSAC, track store, sparse pipeline
- ``sfm_tpu_torch.ba``        — points-only Levenberg-Marquardt bundle adjustment
- ``sfm_tpu_torch.mvs``       — seeding, photo-consistency, expansion rounds
- ``sfm_tpu_torch.utils``     — metrics, timing, synthetic scenes, builds

The main path (sfm, ba, mvs) is ported; joint BA, the outlier filter,
checkpoints and multi-device runs live in ``sfm_tpu`` only so far.  This
package never imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The geometry (projection matrices ~3e3 entries, 8-point normal equations,
# DLT) needs true f32 products or pixel accuracy collapses against the
# 0.3 px insertion gate; TF32 keeps ~3 decimal digits.  Counterpart of the
# JAX package's "highest" default matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from sfm_tpu_torch.config import PipelineConfig  # noqa: E402,F401
