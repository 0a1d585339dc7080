"""Parity of the port's feature modules with sfm_tpu's, on the CPU.

K1 (Harris) and K2 (slab gather) are held here through their plain
versions, which is what the wrappers run for CPU tensors; the CUDA kernels
against those plain versions are tests/test_torch_kernels_cuda.py.  Where
the JAX function reaches a Pallas kernel it runs in TPU interpret mode, as
tests/test_features.py runs it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.features.frontend import detect_and_describe as j_describe
from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.ops import gather as j_gather
from sfm_tpu.ops.harris import detect_corners as j_detect
from sfm_tpu.ops.harris import harris_response as j_harris
from sfm_tpu.ops.ncc import bilinear_sample_patches_stack as j_bilinear
from sfm_tpu.ops.patches import extract_patches as j_extract
from sfm_tpu.ops.patches import normalize_descriptors as j_normalize
from sfm_tpu_torch.config import from_jax_config
from sfm_tpu_torch.features.frontend import detect_and_describe
from sfm_tpu_torch.features.matching import match_descriptors
from sfm_tpu_torch.io.images import gray_tensor
from sfm_tpu_torch.ops.gather import sample_normalized_patches
from sfm_tpu_torch.ops.harris import detect_corners, harris_response
from sfm_tpu_torch.ops.ncc import bilinear_sample_patches_stack
from sfm_tpu_torch.ops.patches import extract_patches, normalize_descriptors
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)


def checkerboard(h=64, w=64, sq=16):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // sq) + (xs // sq)) % 2 * 255.0).astype(np.float32)


@pytest.fixture(scope="module")
def sphere_gray():
    """Four frames of the 200x150 textured-sphere ring, integer gray f32."""
    images, _ = synth.render_scene(
        synth.ring_rig(12)[:4], w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    return gray_tensor(images, "cpu").numpy()


@pytest.fixture(params=["checker", "sphere"])
def gray(request, sphere_gray):
    if request.param == "checker":
        return np.stack([checkerboard(64, 96), checkerboard(64, 96, sq=8)])
    return sphere_gray


class TestHarris:
    def test_response_bit_equal_to_jax_plain(self, gray):
        want = np.asarray(j_harris(jnp.asarray(gray), use_pallas=False))
        got = harris_response(torch.from_numpy(gray)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_response_matches_pallas_interpret_interior(self):
        # The TPU kernel zeroes its 2 border columns; compare interiors
        # (atol 1e-3, as tests/test_features.py holds it against XLA).
        img = np.stack([checkerboard(32, 128), checkerboard(32, 128, sq=8)])
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(j_harris(jnp.asarray(img), use_pallas=True))
        got = harris_response(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(
            got[:, 2:-2, 2:-2], want[:, 2:-2, 2:-2], rtol=0, atol=1e-3
        )

    @pytest.mark.parametrize(
        "kw",
        [
            dict(max_corners=512, nms_radius=4, rel_threshold=1e-6, border=6),
            dict(max_corners=64, nms_radius=3, rel_threshold=0.01, border=0),
        ],
    )
    def test_detect_corners_bit_equal(self, gray, kw):
        jc, jv, _ = j_detect(jnp.asarray(gray), use_pallas=False, **kw)
        tc, tv, _ = detect_corners(torch.from_numpy(gray), **kw)
        # Full arrays, invalid slots included: the tie order matches too.
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_wrapper_rejects(self):
        with pytest.raises(TypeError):
            harris_response(torch.zeros(1, 8, 8, dtype=torch.float64))
        with pytest.raises(ValueError, match="no kernel"):
            harris_response(torch.zeros(1, 8, 8, device="meta"))
        before = harris_response.launches
        harris_response(torch.zeros(1, 8, 8))
        assert harris_response.launches == before  # CPU: plain, no launch


class TestPatches:
    def test_extract_and_normalize(self, sphere_gray):
        jc, _, _ = j_detect(jnp.asarray(sphere_gray), max_corners=256,
                            border=0, use_pallas=False)
        corners = np.array(jc)
        corners[0, :3] = [[0, 0], [199, 149], [3, 140]]  # out-of-border
        jp, ji = j_extract(jnp.asarray(sphere_gray), jnp.asarray(corners), wid=5)
        tp, ti = extract_patches(torch.from_numpy(sphere_gray),
                                 torch.from_numpy(corners), wid=5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        want = np.asarray(j_normalize(jp))
        got = normalize_descriptors(tp).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # f32 sums

    def test_bilinear_stack(self):
        rng = np.random.default_rng(3)
        stack = (rng.random((3, 40, 60)) * 255).astype(np.float32)
        img = rng.integers(0, 3, 200).astype(np.int32)
        ctr = rng.uniform(-5, 65, (200, 2)).astype(np.float32)  # incl. clipped
        jv, ji = j_bilinear(jnp.asarray(stack), jnp.asarray(img), jnp.asarray(ctr), 4)
        tv, ti = bilinear_sample_patches_stack(
            torch.from_numpy(stack), torch.from_numpy(img), torch.from_numpy(ctr), 4
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


class TestSlabGather:
    """The port's sample_normalized_patches (plain path on the CPU) against
    the JAX Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("centers", ["integer", "fractional"])
    def test_matches_jax_kernel(self, centers):
        rng = np.random.default_rng(5)
        n_img, h, w, m = 3, 64, 256, 96
        gray = np.rint(rng.random((n_img, h, w)) * 255).astype(np.float32)
        img = rng.integers(0, n_img, m).astype(np.int32)
        ctr = np.stack([rng.uniform(0, w, m), rng.uniform(0, h, m)], 1)
        if centers == "integer":
            ctr = np.floor(ctr)
        ctr = ctr.astype(np.float32)  # includes out-of-bounds samples
        with pltpu.force_tpu_interpret_mode():
            jd, ji = j_gather.sample_normalized_patches(
                jnp.asarray(gray), jnp.asarray(img), jnp.asarray(ctr), 5, S=32
            )
        td, ti = sample_normalized_patches(
            torch.from_numpy(gray).to(torch.bfloat16), torch.from_numpy(img),
            torch.from_numpy(ctr), 5,
        )
        assert td.dtype == torch.bfloat16 and td.shape == (m, 121)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        ok = ti.numpy()
        assert ok.sum() > m // 2
        err = np.abs(td.float().numpy()[ok] - np.asarray(jd, np.float32)[ok])
        assert err.max() < 2e-2  # bf16 patch + bf16 descriptor rounding

    def test_wrapper_rejects(self):
        g = torch.zeros(1, 32, 32, dtype=torch.bfloat16)
        i = torch.zeros(4, dtype=torch.int32)
        c = torch.full((4, 2), 10.0)
        with pytest.raises(TypeError):
            sample_normalized_patches(g.float(), i, c)
        with pytest.raises(TypeError):
            sample_normalized_patches(g, i.long(), c)
        with pytest.raises(ValueError):
            sample_normalized_patches(g, i, c[:3])
        with pytest.raises(ValueError):
            sample_normalized_patches(g, i, c, wid=9)
        with pytest.raises(ValueError, match="no kernel"):
            sample_normalized_patches(g.to("meta"), i.to("meta"), c.to("meta"))


class TestMatching:
    def _descriptors(self, rng, k, d=25):
        x = rng.normal(size=(k, d)).astype(np.float32)
        x -= x.mean(-1, keepdims=True)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    @pytest.mark.parametrize("max_matches", [32, 200])
    def test_indices_bit_equal(self, max_matches):
        rng = np.random.default_rng(7)
        P, k = 3, 96
        d1 = np.stack([self._descriptors(rng, k) for _ in range(P)])
        perm = rng.permutation(k)
        d2 = d1[:, perm] + rng.normal(size=d1.shape).astype(np.float32) * 0.05
        d2[:, :10] = self._descriptors(rng, 10)        # unmatched rows
        d2[:, 10] = d2[:, 11]                          # ambiguous pair
        v1 = rng.random((P, k)) < 0.9
        v2 = rng.random((P, k)) < 0.9
        got = match_descriptors(
            torch.from_numpy(d1), torch.from_numpy(v1), torch.from_numpy(d2),
            torch.from_numpy(v2), lowe_ratio=0.8, max_matches=max_matches,
        )
        for p in range(P):
            want = j_match(jnp.asarray(d1[p]), jnp.asarray(v1[p]),
                           jnp.asarray(d2[p]), jnp.asarray(v2[p]),
                           lowe_ratio=0.8, max_matches=max_matches)
            for name in ("idx1", "idx2", "valid", "count"):
                np.testing.assert_array_equal(
                    getattr(got, name)[p].numpy(), np.asarray(getattr(want, name))
                )
            assert int(want.count) > 20


def test_detect_and_describe_matches_jax(sphere_gray):
    jcfg = JFeatureConfig(max_corners=512)
    want = j_describe(jnp.asarray(sphere_gray), jcfg, use_pallas=False)
    cfg = from_jax_config(JPipelineConfig(features=jcfg), device="cpu").features
    got = detect_and_describe(torch.from_numpy(sphere_gray), cfg)
    np.testing.assert_array_equal(got.corners.numpy(), np.asarray(want.corners))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(
        got.descriptors.numpy(), np.asarray(want.descriptors), rtol=0, atol=1e-6
    )
    with pytest.raises(ValueError):
        detect_and_describe(torch.from_numpy(sphere_gray), cfg, kernels=True)
