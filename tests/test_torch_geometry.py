"""Parity of the port's geometry (sfm_tpu_torch.geometry) with sfm_tpu's.

The same numpy inputs go through both packages, elementwise, in float64
and in float32.  Tolerances: float64 to 1e-9 relative (the formulas are the
same; only summation order differs), float32 to a few ulps of the
quantity's scale, stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sfm_tpu.geometry import epipolar as je
from sfm_tpu.geometry import linalg3 as jl
from sfm_tpu.geometry import nullvec as jn
from sfm_tpu.geometry import projection as jp
from sfm_tpu.geometry import rotations as jr
from sfm_tpu.geometry import triangulation as jt
from sfm_tpu_torch.geometry import epipolar as te
from sfm_tpu_torch.geometry import linalg3 as tl
from sfm_tpu_torch.geometry import nullvec as tn
from sfm_tpu_torch.geometry import projection as tp
from sfm_tpu_torch.geometry import rotations as tr
from sfm_tpu_torch.geometry import triangulation as tt

torch.set_num_threads(2)

DTYPES = [np.float64, np.float32]
# (rtol, atol) per dtype for O(1) quantities.
TOL = {np.float64: (1e-9, 1e-12), np.float32: (2e-5, 2e-6)}


def both(fn_jax, fn_torch, *arrays):
    """Run one numpy input set through both functions; numpy outputs."""
    jout = fn_jax(*[jnp.asarray(a) for a in arrays])
    tout = fn_torch(*[torch.from_numpy(np.array(a)) for a in arrays])
    if isinstance(jout, tuple):
        return [np.asarray(o) for o in jout], [o.numpy() for o in tout]
    return np.asarray(jout), tout.numpy()


def close(a, b, dtype, scale=1.0):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol * scale)


def cameras(rng, n, dtype):
    """n look-at cameras around the origin with ~700 px focal length."""
    from sfm_tpu_torch.utils.synth import look_at

    Ks, Rs, ts = [], [], []
    for i in range(n):
        ang = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        C = np.array([3 * np.cos(ang), rng.uniform(-0.3, 0.3), 3 * np.sin(ang)])
        R, t = look_at(C, np.zeros(3))
        Ks.append([[700.0, 0.5, 320], [0, 710.0, 240], [0, 0, 1]])
        Rs.append(R)
        ts.append(t)
    return (np.asarray(Ks, dtype), np.asarray(Rs, dtype), np.asarray(ts, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
class TestRotationsProjection:
    def test_rotations(self, dtype):
        rng = np.random.default_rng(10)
        rv = (rng.normal(size=(64, 3)) * 0.8).astype(dtype)
        rv[0] = 0.0            # Taylor branch
        rv[1] = [1e-9, 0, 0]   # Taylor branch, nonzero
        pts = rng.normal(size=(64, 3)).astype(dtype)
        a, b = both(jr.rotate_points, tr.rotate_points, pts, rv)
        close(a, b, dtype, 4.0)
        a, b = both(jr.rodrigues_matrix, tr.rodrigues_matrix, rv)
        close(a, b, dtype)
        R = np.asarray(jr.rodrigues_matrix(jnp.asarray(rv)))
        a, b = both(jr.rodrigues_vector, tr.rodrigues_vector, R)
        close(a, b, dtype, 8.0)

    def test_projection(self, dtype):
        rng = np.random.default_rng(11)
        K, R, t = cameras(rng, 5, dtype)
        a, b = both(jp.projection_matrix, tp.projection_matrix, K, R, t)
        close(a, b, dtype, 1e3)
        pts = (rng.normal(size=(5, 3)) * 0.5).astype(dtype)
        a, b = both(jp.project_pinhole, tp.project_pinhole, pts, K, R, t)
        close(a, b, dtype, 1e3)  # pixels: ~1e3 scale
        rv = np.asarray(jr.rodrigues_vector(jnp.asarray(R)))
        a, b = both(jp.pack_cam, tp.pack_cam, K, rv, t)
        close(a, b, dtype, 1e3)
        cams = a.copy()
        cams[:, 8] = 0.01
        cams[:, 9] = -0.002
        a, b = both(jp.project_cam, tp.project_cam, pts, cams.astype(dtype))
        close(a, b, dtype, 1e3)
        pix = a + rng.normal(size=a.shape).astype(dtype)
        a, b = both(jp.reprojection_errors, tp.reprojection_errors,
                    pts, pix, K, R, t)
        close(a, b, dtype, 1e3)


@pytest.mark.parametrize("dtype", DTYPES)
class TestLinalg:
    def test_linalg3(self, dtype):
        rng = np.random.default_rng(12)
        M = (rng.normal(size=(128, 3, 3)) + 3 * np.eye(3)).astype(dtype)
        b = rng.normal(size=(128, 3)).astype(dtype)
        for jf, tf, args in [
            (jl.adjugate3, tl.adjugate3, (M,)),
            (jl.det3, tl.det3, (M,)),
            (jl.inv3, tl.inv3, (M,)),
            (jl.solve3, tl.solve3, (M, b)),
        ]:
            a, c = both(jf, tf, *args)
            close(a, c, dtype, 10.0)

    @pytest.mark.parametrize("k", [4, 9])
    def test_smallest_eigvec(self, dtype, k):
        rng = np.random.default_rng(13 + k)
        # Well-separated spectra (the DLT / 8-point regime).
        Q, _ = np.linalg.qr(rng.normal(size=(256, k, k)))
        ev = np.concatenate(
            [rng.uniform(1e-6, 1e-4, (256, 1)), rng.uniform(0.5, 2, (256, k - 1))], 1
        )
        M = np.einsum("bij,bj,bkj->bik", Q, ev, Q).astype(dtype)
        a, b = both(jn.smallest_eigvec, tn.smallest_eigvec, M)
        close(a, b, dtype, 10.0)


@pytest.mark.parametrize("dtype", DTYPES)
class TestTriangulationEpipolar:
    def _two_view(self, dtype, n=200):
        rng = np.random.default_rng(14)
        K, R, t = cameras(rng, 2, np.float64)
        P = np.einsum("vij,vjk->vik", K, np.concatenate([R, t[:, :, None]], 2))
        X = rng.normal(size=(n, 3)) * 0.5
        Xh = np.concatenate([X, np.ones((n, 1))], 1)
        h = np.einsum("vij,nj->nvi", P, Xh)
        pix = h[..., :2] / h[..., 2:] + rng.normal(size=(n, 2, 2)) * 0.3
        Pb = np.broadcast_to(P, (n, 2, 3, 4))
        return Pb.astype(dtype), pix.astype(dtype)

    def test_dlt_and_refine(self, dtype):
        Pb, pix = self._two_view(dtype)
        (Xa, wa), (Xb, wb) = both(jt.triangulate_dlt, tt.triangulate_dlt, Pb, pix)
        # f32 DLT is ill-conditioned (normal equations square it): points to
        # 1e-3 world units; the GN refine below restores the precision.
        scale = 1.0 if dtype == np.float64 else 500.0
        close(Xa, Xb, dtype, scale)
        a, b = both(jt.refine_triangulation, tt.refine_triangulation,
                    Pb, pix, Xa.astype(dtype))
        close(a, b, dtype, 10.0)

    def test_ray_plane_backproject(self, dtype):
        rng = np.random.default_rng(15)
        K, R, t = cameras(rng, 8, dtype)
        pix = rng.uniform(0, 640, (8, 2)).astype(dtype)
        (ca, da), (cb, db) = both(jt.backproject_pixel, tt.backproject_pixel,
                                  pix, K, R, t)
        close(ca, cb, dtype)
        close(da, db, dtype)
        n = rng.normal(size=(8, 3)).astype(dtype)
        q = rng.normal(size=(8, 3)).astype(dtype)
        (pa, va), (pb, vb) = both(jt.ray_plane_intersection,
                                  tt.ray_plane_intersection, ca, da, q, n)
        np.testing.assert_array_equal(va, vb)
        close(pa, pb, dtype, 100.0)

    def test_eight_point_sampson(self, dtype):
        rng = np.random.default_rng(16)
        Pb, pix = self._two_view(np.float64, n=64)
        p1 = pix[:, 0].astype(dtype)
        p2 = pix[:, 1].astype(dtype)
        w = (rng.random((6, 64)) < 0.7).astype(dtype)  # 6 weighted fits
        a, b = both(je.eight_point, te.eight_point,
                    np.broadcast_to(p1, (6, 64, 2)), np.broadcast_to(p2, (6, 64, 2)), w)
        # F is unit-norm; entries span ~1e-7..1 (pixel coordinates), so f32
        # agrees to ~1e-4 of the norm.
        close(a, b, dtype, 1.0 if dtype == np.float64 else 50.0)
        F = a.astype(dtype)
        for jf, tf in [(je.sampson_distance, te.sampson_distance),
                       (je.epipolar_distance, te.epipolar_distance)]:
            da, db = both(jf, tf, F, p1[None], p2[None])
            np.testing.assert_allclose(db, da, rtol=TOL[dtype][0] * 50,
                                       atol=TOL[dtype][1] * 50)
