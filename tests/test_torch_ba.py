"""Parity of the port's points-only bundle adjustment with sfm_tpu's, on
the CPU, in float64.

Problems: the ring-of-cameras blobs of tests/test_ba.py, the JAX sparse
result of the 12-frame 200x150 sphere ring carried across
(``config.sparse_from_jax``), and the reference's captured dinoRing-48
problem (``quality_data/ref/dino48_ba_problem.npz``, unpacked as
quality.py does).  Tolerances: Jacobian blocks, V and b_p to 1e-10
relative (f64; the port's blocks are closed-form, JAX's come from
jax.jacfwd, so they agree to rounding); the solve to
equal iteration counts, final cost to rtol 1e-9, points to atol 1e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba.model import jacobian_blocks as j_jacobian_blocks
from sfm_tpu.ba.model import total_cost as j_total_cost
from sfm_tpu.ba.problem import BAProblem as JBAProblem
from sfm_tpu.ba.problem import build_problem as j_build_problem
from sfm_tpu.ba.run import bundle_adjust as j_bundle_adjust
from sfm_tpu.ba.solver import _assemble as j_assemble
from sfm_tpu.ba.solver import solve_lm as j_solve_lm
from sfm_tpu.config import BaConfig as JBaConfig
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.geometry.projection import project_cam as j_project_cam
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from test_ba import synthetic_problem

from sfm_tpu_torch.ba import (
    BAProblem,
    build_problem,
    bundle_adjust,
    jacobian_blocks,
    solve_lm,
    total_cost,
)
from sfm_tpu_torch.ba.solver import _assemble, _point_segments
from sfm_tpu_torch.config import BaConfig, sparse_from_jax
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("cams", "points", "cam_idx", "point_idx", "obs_2d", "mask")


def carry(jp):
    """A JAX BAProblem's arrays as the port's BAProblem (float64)."""
    return BAProblem.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS))


@pytest.fixture(scope="module")
def sphere_sparse():
    """sfm_tpu's sparse result on the 12-frame 200x150 sphere ring."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    cfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    return j_sfm(images, jcal, cfg)


@pytest.fixture(scope="module")
def problems(sphere_sparse):
    """(name -> JAX BAProblem): two noisy blobs and the carried sphere ring."""
    out = {}
    for seed, kw in ((0, {}), (1, dict(n_cams=4, n_pts=60, noise_3d=0.1))):
        jp, _ = synthetic_problem(np.random.default_rng(seed), noise_px=0.5, **kw)
        out[f"blob{seed}"] = jp
    # Radial distortion on (k1, k2 != 0), observations made with it.
    rng = np.random.default_rng(2)
    jp, pts_true = synthetic_problem(rng, n_cams=5, n_pts=80, noise_3d=0.05)
    cams = np.asarray(jp.cams).copy()
    cams[:, 8], cams[:, 9] = 0.05, -0.02
    obs = j_project_cam(jnp.asarray(pts_true)[jp.point_idx], jnp.asarray(cams)[jp.cam_idx])
    out["distorted"] = JBAProblem(
        cams=jnp.asarray(cams), points=jp.points, cam_idx=jp.cam_idx,
        point_idx=jp.point_idx, mask=jp.mask,
        obs_2d=obs + jnp.asarray(rng.normal(scale=0.5, size=obs.shape)),
    )
    r = sphere_sparse
    out["sphere"] = j_build_problem(r.calib, r.world, r.track_offsets,
                                    r.track_obs, dtype=jnp.float64)
    return out


# blob cameras sit on a ring from angle 0: camera 0 has a zero rotation
# vector, the rotation's Taylor branch.
PROBLEMS = ["blob0", "blob1", "distorted", "sphere"]


def test_build_problem_matches_jax(sphere_sparse):
    r = sphere_sparse
    want = j_build_problem(r.calib, r.world, r.track_offsets, r.track_obs,
                           dtype=jnp.float64)
    mine = sparse_from_jax(r)
    got = build_problem(mine.calib, mine.world, mine.track_offsets,
                        mine.track_obs, dtype=torch.float64)
    assert got.cams.shape == (16, 12) and got.points.shape[0] % 1024 == 0
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape, f
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.num_observations == want.num_observations


@pytest.mark.parametrize("name", PROBLEMS)
def test_jacobian_blocks_match_jax(problems, name):
    jp = problems[name]
    tp = carry(jp)
    want = jax.jit(j_jacobian_blocks)(*(getattr(jp, f) for f in FIELDS[:5]), jp.mask)
    got = jacobian_blocks(*(getattr(tp, f) for f in FIELDS[:5]), tp.mask)
    for w, g, what in zip(want, got, ("Jc", "Jp", "r")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10, err_msg=what)
    np.testing.assert_allclose(
        float(total_cost(*(getattr(tp, f) for f in FIELDS))),
        float(jax.jit(j_total_cost)(*(getattr(jp, f) for f in FIELDS))), rtol=1e-12,
    )


@pytest.mark.parametrize("name", PROBLEMS)
def test_assemble_point_blocks_match_jax(problems, name):
    jp = problems[name]
    tp = carry(jp)
    want_V, want_b = jax.jit(
        lambda p: (lambda b: (b.V, b.b_p))(j_assemble(p, p.cams, p.points))
    )(jp)
    V, b_p = _assemble(tp, tp.cams, tp.points, _point_segments(tp))
    np.testing.assert_allclose(V.numpy(), np.asarray(want_V), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(b_p.numpy(), np.asarray(want_b), rtol=1e-10,
                               atol=1e-9)


def check_solve(jp, tp, **kw):
    jc, jpts, jcost, jit = j_solve_lm(jp, optimize_cameras=False, **kw)
    c, pts, cost, it = solve_lm(tp, optimize_cameras=False, **kw)
    assert it == int(jit) and it >= 1
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-9)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))  # frozen
    return it


@pytest.mark.parametrize("name", PROBLEMS)
def test_solve_points_only_matches_jax(problems, name):
    check_solve(problems[name], carry(problems[name]))


def test_solve_joint_not_ported(problems):
    with pytest.raises(NotImplementedError, match="item 10"):
        solve_lm(carry(problems["blob1"]))  # optimize_cameras=True default


def test_bundle_adjust_matches_jax(sphere_sparse):
    r = sphere_sparse
    want_recon = sparse_from_jax(r)  # JAX's bundle_adjust refines in place
    jrec = type(r)(calib=r.calib, world=np.array(r.world),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)
    jrec, jinfo = j_bundle_adjust(jrec, JBaConfig(dtype="float64"))
    rec, info = bundle_adjust(want_recon, BaConfig(dtype="float64"), device="cpu")
    assert set(info) == set(jinfo) - {"finalize"}
    assert info["camera_solver"] == jinfo["camera_solver"] == "frozen"
    for k in ("num_observations", "num_points", "num_cameras",
              "refined_cameras", "iterations"):
        assert info[k] == jinfo[k], k
    for k in ("final_cost", "rms_reproj_refined_px"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(rec.world, jrec.world, rtol=0, atol=1e-8)
    assert set(rec.metrics.values) == set(jrec.metrics.values)
    for k, v in jrec.metrics.values.items():
        np.testing.assert_allclose(rec.metrics.values[k], v, rtol=1e-9, err_msg=k)
    assert rec.rms_reprojection_error() < 0.3 and info["iterations"] >= 1
    with pytest.raises(NotImplementedError, match="item 10"):
        bundle_adjust(rec, BaConfig(refine_cameras=True), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        bundle_adjust(rec, BaConfig(), mesh=object(), device="cpu")


@pytest.fixture(scope="module")
def captured():
    """The reference's captured dinoRing-48 BA problem, unpacked as
    quality.py:_ba_solver_parity does (11-param -> 12-param cameras)."""
    z = np.load(os.path.join(REPO, "quality_data", "ref", "dino48_ba_problem.npz"))
    n_cams, n_pts = int(z["n_cams"]), int(z["n_pts"])

    def unpack(x):
        c11 = x[: n_cams * 11].reshape(n_cams, 11)
        cams = np.concatenate(
            [c11[:, 0:6], c11[:, 6:7], c11[:, 6:7], c11[:, 7:11]], axis=1
        )
        return cams, x[n_cams * 11:].reshape(n_pts, 3)

    idx = (z["cam_idx"], z["pt_idx"], z["pts2d"], np.ones(z["cam_idx"].shape[0], bool))
    return unpack(z["x0"]), unpack(z["x_final"]), idx


def test_captured_problem_cost_at_reference_solution(captured):
    _, (camsf, ptsf), (ci, pi, obs, mask) = captured
    want = jax.jit(j_total_cost)(jnp.asarray(camsf), jnp.asarray(ptsf), jnp.asarray(ci),
                        jnp.asarray(pi), jnp.asarray(obs), jnp.asarray(mask))
    tp = BAProblem.from_numpy(camsf, ptsf, ci, pi, obs, mask)
    got = total_cost(*(getattr(tp, f) for f in FIELDS))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_captured_problem_points_only_solve(captured):
    (cams0, pts0), _, (ci, pi, obs, mask) = captured
    jp = JBAProblem(
        cams=jnp.asarray(cams0), points=jnp.asarray(pts0),
        cam_idx=jnp.asarray(ci, jnp.int32), point_idx=jnp.asarray(pi, jnp.int32),
        obs_2d=jnp.asarray(obs), mask=jnp.asarray(mask),
    )
    tp = BAProblem.from_numpy(cams0, pts0, ci, pi, obs, mask)
    assert check_solve(jp, tp) >= 1
    assert check_solve(jp, tp, max_iterations=3, ftol=1e-12) == 3
