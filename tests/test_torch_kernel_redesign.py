"""What the CUDA kernels K1 and K2 are held to on the card, checked on the CPU.

The kernels themselves run only on a GPU (tests/test_torch_kernels_cuda.py);
here are the claims their design rests on, on small seeded inputs:

- the in-bounds mask K2 writes is specified by the plain ``_inbounds``, and
  that agrees with the JAX package's at centres on the limits, one float
  step either side, NaN, +-inf and +-1e10;
- the interpolation as K2 does it (each pixel reads its own four window
  elements; the window origin is clamped in float) gives the plain
  version's values bit for bit and the JAX package's within a few float
  steps, and reads inside the stack for NaN, +-inf and +-1e10 centres;
- K1 on integer gray is exact up to the two fused multiply-adds, so the
  order of its box sums cannot change a bit there;
- every C entry point is bound with the ctypes argument types its
  declaration has.
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfm_tpu.ops import gather as j_gather
from sfm_tpu.ops.harris import harris_response as j_harris
from sfm_tpu.ops.ncc import bilinear_sample_patches_stack as j_bilinear
from sfm_tpu_torch.ops.gather import sample_normalized_patches
from sfm_tpu_torch.ops.harris import _box3, _harris_math, _shift, _sobel
from sfm_tpu_torch.ops.ncc import bilinear_sample_patches_stack
from sfm_tpu_torch.utils import build

torch.set_num_threads(2)


def limit_centres(h, w, wid):
    """(x, y) f32 centres on each of the four in-bounds limits, one float
    step inside and outside each, and non-finite / huge ones."""
    lo, hi_x, hi_y = wid + 1.0, w - wid - 2.0, h - wid - 2.0
    mid_x, mid_y = np.float32(w / 2), np.float32(h / 2)
    rows = []
    for lim, axis, mid in ((lo, 0, mid_y), (hi_x, 0, mid_y),
                           (lo, 1, mid_x), (hi_y, 1, mid_x)):
        lim = np.float32(lim)
        for v in (lim, np.nextafter(lim, np.float32(-np.inf)),
                  np.nextafter(lim, np.float32(np.inf))):
            rows.append((v, mid) if axis == 0 else (mid, v))
    inf, nan = np.inf, np.nan
    rows += [(nan, mid_y), (mid_x, nan), (nan, nan), (inf, mid_y),
             (-inf, mid_y), (mid_x, inf), (mid_x, -inf), (1e10, mid_y),
             (mid_x, -1e10), (-1e10, 1e10), (mid_x, mid_y)]
    return np.asarray(rows, np.float32)


class TestInboundsMask:
    @pytest.mark.parametrize("shape,wid", [((3, 40, 64), 5), ((3, 40, 64), 2),
                                           ((2, 150, 200), 5)])
    def test_equal_to_jax_at_the_limits(self, shape, wid):
        rng = np.random.default_rng(11)
        n, h, w = shape
        gray = np.rint(rng.random(shape) * 255).astype(np.float32)
        ctr = limit_centres(h, w, wid)
        # not the last image: the interpreter refuses the Pallas kernel's
        # 24-row slab where it passes the end of the padded stack
        img = (np.arange(len(ctr)) % (n - 1)).astype(np.int32)
        # The JAX sampler's plain reference on every centre, and its Pallas
        # kernel (interpreted, as tests/test_features.py runs it) on the
        # finite ones: the interpreter refuses the kernel's reads for a
        # non-finite centre.
        _, want = j_bilinear(jnp.asarray(gray), jnp.asarray(img),
                             jnp.asarray(ctr), wid)
        want = np.asarray(want)
        fin = np.isfinite(ctr).all(axis=1) & (np.abs(ctr) < 1e9).all(axis=1)
        with pltpu.force_tpu_interpret_mode():
            _, kern = j_gather.sample_normalized_patches(
                jnp.asarray(gray), jnp.asarray(img[fin]),
                jnp.asarray(ctr[fin]), wid, S=32)
        np.testing.assert_array_equal(np.asarray(kern), want[fin])
        _, got = sample_normalized_patches(
            torch.from_numpy(gray).to(torch.bfloat16), torch.from_numpy(img),
            torch.from_numpy(ctr), wid)
        np.testing.assert_array_equal(got.numpy(), want)
        # on a limit and one step inside: in; one step outside: out;
        # non-finite and huge: out; the centre of the image: in.
        per_limit = want[:12].reshape(4, 3)
        assert per_limit[:, 0].all()
        assert (per_limit[:2, 1:] == [[False, True], [True, False]]).all()
        assert (per_limit[2:, 1:] == [[False, True], [True, False]]).all()
        assert not want[12:-1].any() and want[-1]


def window_origin(c, wid, dim):
    """K2's window origin on one axis (gather_common.cuh, window_of): clamped
    in float before the cast, fmaxf / fminf taking the operand that is not
    NaN."""
    lo = torch.fmax(torch.floor(c) - wid, torch.zeros(()))
    return torch.fmin(lo, torch.full((), float(dim - 2 * wid - 2))).long()


def kernel_bilinear(stack, img_idx, centers, wid):
    """K2's interpolation in torch f32, pixel by pixel as the kernel does it
    (gather_common.cuh, bilinear): pixel p of a sample reads its own four
    window elements around row p / side, column p % side, and adds the four
    terms ((p gy) gx, (p gy) fx, (p fy) gx, (p fy) fx) left to right."""
    n, h, w = stack.shape
    side = 2 * wid + 1
    img = img_idx.long().clamp(0, n - 1)
    x, y = centers[:, 0], centers[:, 1]
    fx = (x - torch.floor(x))[:, None]
    fy = (y - torch.floor(y))[:, None]
    gx, gy = 1 - fx, 1 - fy
    bx, by = window_origin(x, wid, w), window_origin(y, wid, h)
    p = torch.arange(side * side)
    row = (img * h + by)[:, None] + p // side
    col = bx[:, None] + p % side
    flat = stack.reshape(n * h, w)
    val = (flat[row, col] * gy) * gx
    val = val + (flat[row, col + 1] * gy) * fx
    val = val + (flat[row + 1, col] * fy) * gx
    val = val + (flat[row + 1, col + 1] * fy) * fx
    return val, bx, by


class TestInterpolationOrder:
    @pytest.mark.parametrize("wid", [0, 2, 5, 8])
    def test_bit_equal_to_the_plain_version_and_close_to_jax(self, wid):
        rng = np.random.default_rng(13 + wid)
        n, h, w, m = 3, 40, 64, 500
        # bf16-representable gray, as K2 reads it
        stack = torch.from_numpy(
            (rng.random((n, h, w)) * 255).astype(np.float32)
        ).to(torch.bfloat16).float()
        img = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
        ctr = torch.from_numpy(np.stack(
            [rng.uniform(-3, w + 3, m), rng.uniform(-3, h + 3, m)], 1
        ).astype(np.float32))
        got, _, _ = kernel_bilinear(stack, img, ctr, wid)
        assert got.shape == (m, (2 * wid + 1) ** 2)
        want, _ = j_bilinear(jnp.asarray(stack.numpy()), jnp.asarray(img.numpy()),
                             jnp.asarray(ctr.numpy()), wid)
        # XLA on the CPU contracts multiply-adds: a few f32 steps at 255
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-4)
        plain, _ = bilinear_sample_patches_stack(stack, img, ctr, wid)
        assert torch.equal(got, plain)

    def test_window_stays_inside_for_any_centre(self):
        n, h, w, wid = 3, 40, 64, 5
        ctr = torch.from_numpy(limit_centres(h, w, wid))
        stack = torch.zeros((n, h, w))
        _, bx, by = kernel_bilinear(
            stack, torch.zeros(len(ctr), dtype=torch.int32), ctr, wid)
        assert int(bx.min()) >= 0 and int(bx.max()) <= w - 2 * wid - 2
        assert int(by.min()) >= 0 and int(by.max()) <= h - 2 * wid - 2
        # NaN reads the window at 0; +-inf and +-1e10 clamp to an edge
        assert int(bx[12]) == 0 and int(by[13]) == 0
        assert int(bx[15]) == w - 2 * wid - 2 and int(bx[16]) == 0


def box3_by_columns(img):
    """The 3x3 box sum in a second order: column sums first."""
    col = _shift(img, -1, 0) + img + _shift(img, 1, 0)
    return _shift(col, 0, -1) + col + _shift(col, 0, 1)


def integer_gray(kind):
    rng = np.random.default_rng(17)
    if kind == "random":
        return np.rint(rng.random((2, 150, 200)) * 255).astype(np.float32)
    # 1-pixel checkerboard of 0 / 255 beside a 0 | 255 step: the largest
    # gradients integer gray can have
    ys, xs = np.mgrid[0:40, 0:64]
    board = ((ys + xs) % 2 * 255.0).astype(np.float32)
    step = np.where(xs >= 32, 255.0, 0.0).astype(np.float32)
    corner = np.where((xs >= 32) & (ys >= 20), 255.0, 0.0).astype(np.float32)
    return np.stack([board, step, corner])


class TestHarrisExactOnIntegerGray:
    @pytest.mark.parametrize("kind", ["random", "extreme"])
    def test_box_sum_order_cannot_matter(self, kind):
        gray = torch.from_numpy(integer_gray(kind))
        ix, iy = _sobel(gray)
        assert float(ix.abs().max()) <= 1020 and float(iy.abs().max()) <= 1020
        largest = 0.0
        for prod in (ix * ix, iy * iy, ix * iy):
            want = _box3(prod)
            assert torch.equal(box3_by_columns(prod), want)
            # exact: equal to the sum taken in float64
            assert torch.equal(_box3(prod.double()).float(), want)
            largest = max(largest, float(want.abs().max()))
        assert largest < 2 ** 24
        if kind == "extreme":
            assert largest >= 9 * 1020 ** 2 / 2  # the step reaches |Ix| = 1020

    @pytest.mark.parametrize("kind", ["random", "extreme"])
    def test_response_bit_equal_to_jax(self, kind):
        gray = integer_gray(kind)
        want = np.asarray(j_harris(jnp.asarray(gray), use_pallas=False))
        got = _harris_math(torch.from_numpy(gray), 0.04).numpy()
        np.testing.assert_array_equal(got, want)


class TestEntryPoints:
    def test_every_declaration_has_its_argtypes(self):
        declared = build.declared_entry_points()
        assert set(declared) == set(build.KERNEL_ARGTYPES)
        assert len(declared) == 4  # K1, K2, K3, K4

    @pytest.mark.parametrize("name", sorted(build.KERNEL_ARGTYPES))
    def test_argtypes_match_the_declaration(self, name):
        declared = build.declared_entry_points()[name]
        bound = build.KERNEL_ARGTYPES[name]
        assert len(bound) == len(declared)
        assert bound == declared
        # pointers and the stream are never passed as 32-bit ints
        assert bound[0] is ctypes.c_void_p and bound[-1] is ctypes.c_void_p

    def test_parser_reads_pointers_ints_floats(self, tmp_path):
        (tmp_path / "x.cu").write_text(
            'extern "C" int f(const void* a, const int* b, float* c,\n'
            "                 int m, float k, cudaStream_t stream) {}\n")
        assert build.declared_entry_points(str(tmp_path)) == {
            "f": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p]}
