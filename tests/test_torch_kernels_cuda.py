"""The CUDA kernels against their plain PyTorch versions, on the card.

Phases 2-3 and 7 of chip_smoke.py at the main path's shapes: K1 (Harris)
bit-equal response and corners on a rendered 48 x 480 x 640 stack; K2 (slab
gather) within one bf16 ulp at integer centers and 8e-3 at 163,840
fractional centers, in-bounds masks equal; K2 at the centres one ported
expansion round produces on the card, plus NaN, +-inf and 1e10 centres,
reading nothing outside the stack.  Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is False.  On the card (tests/conftest.py
imports jax, which the card's machine lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import importlib.util
import os

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stack(smoke):
    from sfm_tpu_torch.io.images import gray_tensor

    images, _ = smoke.render_ring()
    return gray_tensor(images, "cuda")


def test_k1_bit_equal(smoke, stack):
    from sfm_tpu_torch.ops.harris import harris_response

    before = harris_response.launches
    out = smoke.check_k1(stack)
    assert out["max_abs_err"] == 0.0
    assert harris_response.launches > before


def test_k2_within_bounds(smoke, stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.ops.harris import detect_corners

    corners, _, _ = detect_corners(stack, max_corners=1024, nms_radius=4,
                                   rel_threshold=1e-6, border=smoke.WID + 1)
    before = sample_normalized_patches.launches
    err = smoke.check_k2(stack.to(torch.bfloat16), smoke.k2_inputs(stack, corners))
    assert err["fractional"] <= smoke.K2_FRAC_ATOL
    assert sample_normalized_patches.launches == before + 2


def test_k2_at_expansion_round_and_nonfinite_centres(smoke, stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    images, calib = smoke.render_ring()
    recon, _ = smoke.run_sfm(images, calib, kernels=True)
    before = sample_normalized_patches.launches
    out = smoke.check_k2_mvs_round(stack, calib, recon)
    assert out["max_abs_err"] <= smoke.K2_FRAC_ATOL
    assert out["samples"] > 100_000 and out["nonfinite_centres"] >= 8
    assert out["round_accepted"] > 0
    assert sample_normalized_patches.launches > before
