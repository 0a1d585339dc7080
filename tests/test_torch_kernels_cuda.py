"""The CUDA kernels against their plain PyTorch versions, on the card.

Phases 2-3 and 7 of chip_smoke.py at the main path's shapes: K1 (Harris)
bit-equal response and corners on a rendered 48 x 480 x 640 stack; K2 (slab
gather) within one bf16 ulp at integer centers and 8e-3 at 163,840
fractional centers, in-bounds masks equal; K2 at the centres one ported
expansion round produces on the card, plus NaN, +-inf and 1e10 centres,
reading nothing outside the stack; phase 11's K2s (the sharded wrapper) on
4 virtual shards of cuda:0, bit-equal to one K2 call at 163,840 and 163,843
(the pad path) fractional centres; K1 and K2 on cuda:1 while cuda:0 is
current (skipped below two GPUs); and K3 (the tile-resident sampler) in its
three modes at S = 8, 32, 128 against its plain versions and against K2, on
the tool's case, an expansion round's centres, non-finite centres and the
edges of a guarded and of an odd-width stack, the staging route each set
took by device kernel name, a 640-wide view off a 16-byte boundary on the
per-row route, and an S / wid whose stages cannot fit a block refused
before any launch.  K4 (the grayscale conversion) bit-equal to the host
conversion over all 2^24 RGB triples, on the rendered stack and on shapes
off the main path, one device kernel a call, inputs refused before any
launch, and ``device_gray``'s two routes.  Also K1 on shapes off the
main path (odd width, tiny images, a 4-byte-aligned stack, non-integer
gray) and what K2's one-launch design adds: its mask on the in-bounds
limits, M = 1, 7 and 163,843, wid 0, 2 and 8, guarded and odd-width stacks,
and one device kernel per call.  Marked ``cuda``; each test skips where
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
def ring(smoke):
    images, _ = smoke.render_ring()
    return images


@pytest.fixture(scope="module")
def stack(ring):
    from sfm_tpu_torch.io.images import gray_tensor

    return gray_tensor(ring, "cuda")


def test_k4_bit_equal_on_every_triple_and_the_ring(smoke, ring):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    before = rgb_to_gray.launches
    rgb = smoke.check_k4(ring)
    assert rgb_to_gray.launches == before + 2
    assert rgb.dtype == torch.uint8 and rgb.shape == ring.shape


def test_k4_shapes_off_the_main_path_and_refusals(smoke):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    before = rgb_to_gray.launches
    smoke.check_k4_shapes(torch.device("cuda"))
    assert rgb_to_gray.launches == before + 9  # 8 shapes, the offset stack


def test_k4_call_is_one_device_kernel(smoke):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    x = torch.randint(0, 256, (4, 48, 64, 3), dtype=torch.uint8, device="cuda")
    where = smoke.host_and_device(lambda: rgb_to_gray(x))
    assert where["launches"] == 1.0
    assert any("gray_kernel" in k for k in where["kernels"])


def test_device_gray_routes_on_the_card(smoke):
    import numpy as np

    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.ops.gray import rgb_to_gray
    from sfm_tpu_torch.utils.metrics import Metrics

    images = np.random.default_rng(5).integers(0, 256, (3, 40, 56, 3), np.uint8)
    m = Metrics()
    before = rgb_to_gray.launches
    a = device_gray(images, "cuda", metrics=m)
    assert rgb_to_gray.launches == before + 1
    assert m.values["gray_route"] == "kernel"
    assert device_gray(images, "cuda", metrics=m) is a  # cached: no launch
    assert rgb_to_gray.launches == before + 1
    m = Metrics()
    b = device_gray(images.copy(), "cuda", kernels=False, metrics=m)
    assert rgb_to_gray.launches == before + 1
    assert m.values["gray_route"] == "host"
    assert torch.equal(a, b) and a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(a.cpu().numpy(), smoke.host_gray(images))


def test_k1_bit_equal(smoke, stack):
    from sfm_tpu_torch.ops.harris import harris_response

    before = harris_response.launches
    out = smoke.check_k1(stack)
    assert out["max_abs_err"] == 0.0
    assert harris_response.launches > before


def test_k1_shapes_off_the_main_path(smoke, stack):
    from sfm_tpu_torch.ops.harris import harris_response

    before = harris_response.launches
    out = smoke.check_k1_shapes(stack.device)
    assert out["nonint_rel_err"] <= 1e-5
    assert harris_response.launches == before + 7


def test_k2_mask_partial_blocks_and_widths(smoke, stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    _, (img_f, ctr_f) = smoke.k2_inputs(stack, torch.zeros(
        (stack.shape[0], 1, 2), dtype=torch.int32, device=stack.device))
    before = sample_normalized_patches.launches
    out = smoke.check_k2_redesign(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] <= smoke.K2_FRAC_ATOL
    # limits, M = 163,843, 1 and 7, three widths, two stacks
    assert sample_normalized_patches.launches == before + 9


def test_k2_call_is_one_device_kernel(smoke, stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    g = stack.to(torch.bfloat16)
    _, (img_f, ctr_f) = smoke.k2_inputs(stack, torch.zeros(
        (stack.shape[0], 1, 2), dtype=torch.int32, device=stack.device))
    where = smoke.host_and_device(
        lambda: sample_normalized_patches(g, img_f, ctr_f, smoke.WID))
    assert where["launches"] == 1.0
    desc, inb = sample_normalized_patches(g, img_f, ctr_f, smoke.WID)
    assert inb.dtype == torch.bool and inb.shape == img_f.shape
    assert desc.shape == (img_f.shape[0], (2 * smoke.WID + 1) ** 2)


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


def test_k2_sharded_bit_equal_to_one_call(smoke, stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches_sharded

    _, (img_f, ctr_f) = smoke.k2_inputs(stack, torch.zeros(
        (stack.shape[0], 1, 2), dtype=torch.int32, device=stack.device))
    before = sample_normalized_patches_sharded.launches
    out = smoke.check_k2_sharded(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] == 0.0
    assert out["max_abs_err_plain"] <= smoke.K2_FRAC_ATOL
    # 2 shapes x 4 virtual shards (+ every GPU where there are several),
    # plus the timing windows.
    assert sample_normalized_patches_sharded.launches >= before + 2 * smoke.SHARDS


def test_k3_modes_against_plain_versions_and_k2(smoke, stack):
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled

    _, (img_f, ctr_f) = smoke.k2_inputs(stack, torch.zeros(
        (stack.shape[0], 1, 2), dtype=torch.int32, device=stack.device))
    before = sample_normalized_patches_tiled.launches
    out = smoke.check_k3(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] <= smoke.K2_FRAC_ATOL
    assert out["bit_equal_k2"]
    assert sample_normalized_patches_tiled.launches == before + 36


def test_k3_routes_by_kernel_name(smoke, stack):
    _, (img_f, ctr_f) = smoke.k2_inputs(stack, torch.zeros(
        (stack.shape[0], 1, 2), dtype=torch.int32, device=stack.device))
    routes = smoke.check_k3_routes(stack.to(torch.bfloat16), img_f, ctr_f)
    assert routes == {"tool case": "tma", "expansion round": "tma",
                      "guarded edges": "tma", "odd width": "rows"}


def test_k3_refuses_what_cannot_fit(stack):
    from sfm_tpu_torch.ops.gather_tile import (
        MAX_SHARED_BYTES,
        sample_normalized_patches_tiled,
        shared_bytes,
    )

    g = stack.to(torch.bfloat16)
    img = torch.zeros(4, dtype=torch.int32, device=g.device)
    ctr = torch.full((4, 2), 50.0, device=g.device)
    assert shared_bytes(8, 256, True, "tma") > MAX_SHARED_BYTES
    before = sample_normalized_patches_tiled.launches
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="shared memory"):
        sample_normalized_patches_tiled(g, img, ctr, 8, samples_per_block=256,
                                        double_buffer=True)
    assert sample_normalized_patches_tiled.launches == before
    # S 192 single-buffered at wid 8 fits (224,512 bytes: above 48 KB, so
    # opted into) and launches
    assert shared_bytes(8, 192, False, "tma") == 224512
    out = sample_normalized_patches_tiled(g, img, ctr, 8, samples_per_block=192,
                                          double_buffer=False)
    torch.cuda.synchronize()
    assert sample_normalized_patches_tiled.launches == before + 1
    assert out.shape == (4, 17 * 17) and torch.isfinite(out.float()).all()


def test_k3_unaligned_base_takes_the_rows_route(smoke, stack):
    # A 640-wide view whose first element is 2 bytes past a 16-byte
    # boundary cannot be a tensor map's base: the rows kernel runs, with
    # the tensor-map kernel's results on an aligned copy of the same stack.
    from sfm_tpu_torch.ops.gather_tile import (
        sample_normalized_patches_tiled,
        tile_route,
    )
    from sfm_tpu_torch.tools.measure import kernel_named

    g = stack.to(torch.bfloat16)
    buf = torch.empty(g.numel() + 8, dtype=torch.bfloat16, device=g.device)
    view = buf[1:1 + g.numel()].view(g.shape)
    view.copy_(g)
    assert tile_route(g) == "tma" and tile_route(view) == "rows"
    n, h, w = g.shape
    gen = torch.Generator().manual_seed(5)
    ctr = (torch.rand((4096, 2), generator=gen)
           * torch.tensor([w - 1.0, h - 1.0])).to(g.device)
    img = torch.randint(0, n, (4096,), generator=gen,
                        dtype=torch.int32).to(g.device)
    for extract in (False, True):
        want = sample_normalized_patches_tiled(g, img, ctr, 5, extract=extract)
        names = smoke.device_kernel_names(lambda: sample_normalized_patches_tiled(
            view, img, ctr, 5, extract=extract))
        assert any(kernel_named(k, "gather_tile_rows_kernel") for k in names)
        got = sample_normalized_patches_tiled(view, img, ctr, 5, extract=extract)
        assert torch.equal(got, want)


def test_k3_raises_instead_of_falling_back(stack):
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled

    g = stack.to(torch.bfloat16)
    img = torch.zeros(4, dtype=torch.int32, device=g.device)
    ctr = torch.full((4, 2), 50.0, device=g.device)
    with pytest.raises(ValueError):  # a non-contiguous CUDA input
        sample_normalized_patches_tiled(g, img, ctr.t().contiguous().t())
    with pytest.raises(ValueError):  # inputs on two devices
        sample_normalized_patches_tiled(g, img.cpu(), ctr)


def test_kernels_launch_on_their_tensors_device(smoke, stack):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from sfm_tpu_torch.ops.harris import detect_corners

    corners, _, _ = detect_corners(stack, max_corners=1024, nms_radius=4,
                                   rel_threshold=1e-6, border=smoke.WID + 1)
    out = smoke.check_second_gpu(stack, smoke.k2_inputs(stack, corners))
    assert out["k2_max_abs_err"] <= smoke.K2_FRAC_ATOL
