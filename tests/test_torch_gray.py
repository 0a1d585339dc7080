"""The grayscale conversion's two routes (``sfm_tpu_torch/io/images.py``)
on the CPU: K4's plain version (``ops/gray.py``) bit-equal to the host
conversion over every RGB triple, ``device_gray``'s route by device and
``kernels`` switch, and K4's entry point in the kernel library's ctypes
table.  K4 itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu_torch.config import FeatureConfig, PipelineConfig, RuntimeConfig
from sfm_tpu_torch.io.images import device_gray, gray_tensor, to_gray
from sfm_tpu_torch.ops._launch import use_kernel_on
from sfm_tpu_torch.ops.gray import _gray_plain, rgb_to_gray
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import build, synth
from sfm_tpu_torch.utils.metrics import Metrics


def host_values(rgb: np.ndarray) -> np.ndarray:
    """What the host route uploads, as float32."""
    return np.rint(to_gray(rgb)).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("red", [range(0, 128), range(128, 256)],
                         ids=["red 0-127", "red 128-255"])
def test_plain_version_bit_equal_to_the_host_on_every_triple(red):
    gb = np.arange(1 << 16, dtype=np.uint32)
    for r in red:
        rgb = np.stack([np.full_like(gb, r), gb >> 8, gb & 255], axis=-1)
        rgb = rgb.astype(np.uint8).reshape(1, 256, 256, 3)
        got = _gray_plain(torch.from_numpy(rgb)).numpy()
        want = host_values(rgb)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), r


def test_rgb_to_gray_on_the_cpu_is_the_plain_version():
    rgb = np.random.default_rng(0).integers(0, 256, (3, 21, 17, 3), np.uint8)
    before = rgb_to_gray.launches
    got = rgb_to_gray(torch.from_numpy(rgb))
    assert rgb_to_gray.launches == before  # CPU: plain, no launch
    assert got.shape == (3, 21, 17) and got.dtype == torch.float32
    assert torch.equal(got, gray_tensor(rgb, "cpu"))


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 8, 3), torch.float32),
    ((2, 8, 8), torch.uint8),
    ((2, 8, 8, 4), torch.uint8),
    ((8, 8, 3), torch.uint8),
], ids=["float32", "no channels", "four channels", "no image axis"])
def test_rgb_to_gray_refuses_what_is_not_a_uint8_rgb_stack(shape, dtype):
    before = rgb_to_gray.launches
    with pytest.raises(TypeError, match="uint8"):
        rgb_to_gray(torch.zeros(shape, dtype=dtype))
    assert rgb_to_gray.launches == before


@pytest.mark.parametrize("kernels", [None, False])
def test_device_gray_on_the_cpu_takes_the_host_route(kernels):
    images = np.random.default_rng(1).integers(0, 256, (3, 20, 30, 3), np.uint8)
    m = Metrics()
    before = rgb_to_gray.launches
    got = device_gray(images, "cpu", kernels, m)
    assert rgb_to_gray.launches == before
    assert m.values["gray_route"] == "host"
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_device_gray(images)))
    # A hit records the route that made the cached stack.
    m = Metrics()
    assert device_gray(images, "cpu", metrics=m) is got
    assert m.values["gray_route"] == "host"


def test_the_route_follows_the_device_and_the_switch():
    # device_gray converts on the card exactly where this is True.
    assert use_kernel_on("cpu", None) is use_kernel_on("cpu", False) is False
    assert use_kernel_on("cuda", None) is use_kernel_on("cuda:1", True) is True
    assert use_kernel_on(torch.device("cuda", 0), False) is False
    with pytest.raises(ValueError, match="kernels=True"):
        use_kernel_on("cpu", True)
    with pytest.raises(ValueError, match="kernels=True"):
        device_gray(np.zeros((1, 4, 4, 3), np.uint8), "cpu", kernels=True)


@pytest.mark.parametrize("kernels", [None, False])
def test_sfm_on_the_cpu_records_the_host_route(kernels):
    images, cal = synth.render_scene(synth.ring_rig(4), w=96, h=72, seed=2,
                                     texture_freq_scale=1.0)
    cfg = PipelineConfig(
        features=FeatureConfig(max_corners=128, max_matches=64),
        runtime=RuntimeConfig(device="cpu", kernels=kernels),
    )
    before = rgb_to_gray.launches
    recon = structure_from_motion(images, cal, cfg)
    assert rgb_to_gray.launches == before
    assert recon.metrics.values["gray_route"] == "host"
    assert "features.gray" in recon.timers.times


def test_k4_entry_point_is_declared_with_its_argtypes():
    ptr, i32 = build._PTR, build._I32
    want = [ptr, ptr, i32, i32, i32, ptr]  # rgb, out, n, h, w, stream
    assert build.declared_entry_points()["rgb_to_gray_f32"] == want
    assert build.KERNEL_ARGTYPES["rgb_to_gray_f32"] == want
