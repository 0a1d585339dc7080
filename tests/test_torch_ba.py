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
from sfm_tpu.sfm.pipeline import SparseReconstruction as JSparseReconstruction
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
from sfm_tpu_torch.ba.solver import (
    _assemble_shard,
    _camera_segments,
    _point_segments,
    _Tables,
)
from sfm_tpu_torch.config import BaConfig, sparse_from_jax
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("cams", "points", "cam_idx", "point_idx", "obs_2d", "mask")
# The joint solve's keys the port adds: its dense gate's counts and the
# PCG solves' CG counts.
GATE_KEYS = ("ba_dense_schur_pairs", "ba_dense_schur_pair_bytes",
             "ba_dense_schur_grid_bytes", "ba_dense_schur_decided_by",
             "ba_cg_iterations", "ba_cg_capped")


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
    want = jax.jit(
        lambda p: (lambda b: (b.V, b.b_p, b.U, b.b_c, b.W))(
            j_assemble(p, p.cams, p.points))
    )(jp)
    tables = _Tables(point=_point_segments(tp), cam=_camera_segments(tp))
    V, b_p = _assemble_shard(tp, tp.cams, tp.points, tables, joint=False)
    joint = _assemble_shard(tp, tp.cams, tp.points, tables, joint=True)
    assert torch.equal(joint[0], V) and torch.equal(joint[1], b_p)
    # The camera blocks too (the joint solve's): sums of products of focal-
    # length-scaled Jacobians reach 1e9, so the bound is relative to each
    # block's largest entry.
    for got, w, what in zip(joint, want, ("V", "b_p", "U", "b_c", "W")):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * max(np.abs(w).max(), 1e3),
                                   err_msg=what)


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


def check_joint(jp, tp, span, **kw):
    """The joint solve against sfm_tpu's with the same camera solver
    (``span`` > 0: dense Schur; 0: PCG), float64: LM iterations equal, cost
    to rtol 1e-6 (the PCG solves stop at a 1e-6 residual, and the two
    packages sum the blocks in another order), parameters to 1e-5."""
    jc, jpts, jcost, jit = j_solve_lm(jp, optimize_cameras=True, pair_span=span, **kw)
    c, pts, cost, it = solve_lm(tp, optimize_cameras=True, pair_span=span, **kw)
    assert it == int(jit) and it >= 1
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-6)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-5)
    return c, pts, float(cost), it


def test_solve_joint_default_matches_jax(problems):
    """The default solve (optimize_cameras=True, PCG) of the port against
    sfm_tpu's."""
    jp = problems["blob1"]
    jc, jpts, jcost, jit = j_solve_lm(jp)
    c, pts, cost, it = solve_lm(carry(jp))
    assert it == int(jit) and it >= 1
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-6)
    assert not np.array_equal(c.numpy(), np.asarray(jp.cams))  # cameras moved


def joint_blob(seed=0):
    """tests/test_ba.py::test_dense_schur_matches_pcg's problem."""
    jp, _ = synthetic_problem(np.random.default_rng(seed), n_cams=5, n_pts=80,
                              noise_3d=0.08, noise_px=0.3)
    return jp


@pytest.mark.parametrize("span", [0, 5], ids=["pcg", "dense"])
def test_solve_joint_matches_jax(span):
    jp = joint_blob()
    check_joint(jp, carry(jp), span, max_iterations=20)


@pytest.mark.parametrize("name", ["blob0", "blob1", "distorted"])
def test_solve_joint_dense_matches_pcg(problems, name):
    """Exact Cholesky against CG(tol 1e-6) within the port: the same
    optimum to solver tolerance (the bounds of tests/test_ba.py), also with
    radial distortion.  (On the sphere ring CG stops at its 100-iteration
    cap unconverged, so the two solvers walk different LM paths; that
    problem is held to sfm_tpu per solver in
    test_bundle_adjust_refine_cameras_matches_jax.)"""
    tp = carry(problems[name])
    cp, pp, cost_p, _ = solve_lm(tp, max_iterations=20, optimize_cameras=True)
    cd, pd, cost_d, _ = solve_lm(tp, max_iterations=20, optimize_cameras=True,
                                 pair_span=1)
    np.testing.assert_allclose(float(cost_d), float(cost_p), rtol=1e-5)
    np.testing.assert_allclose(pd.numpy(), pp.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cd.numpy(), cp.numpy(), rtol=1e-5, atol=1e-4)
    assert float(cost_d) < float(total_cost(*(getattr(tp, f) for f in FIELDS)))


def test_failed_factorisation_is_a_rejected_step(monkeypatch):
    """A Cholesky that fails gives a NaN camera step: LM rejects it and
    raises the damping, as NaNs do in sfm_tpu."""
    import sfm_tpu_torch.ba.solver as solver

    tp = carry(joint_blob())
    real = torch.linalg.cholesky_ex
    calls = {"n": 0}

    def failing_first(a):
        calls["n"] += 1
        L, info = real(a)
        return L, info + (1 if calls["n"] == 1 else 0)

    monkeypatch.setattr(solver.torch.linalg, "cholesky_ex", failing_first)
    c1, _, cost1, it1 = solve_lm(tp, max_iterations=1, pair_span=1)
    start = float(total_cost(*(getattr(tp, f) for f in FIELDS)))
    assert it1 == 1 and float(cost1) == start           # step 1 rejected
    assert torch.equal(c1, tp.cams)
    _, _, cost3, it3 = solve_lm(tp, max_iterations=3, pair_span=1)
    assert it3 == 3 and float(cost3) < start            # and it recovers


def test_bundle_adjust_matches_jax(sphere_sparse):
    r = sphere_sparse
    want_recon = sparse_from_jax(r)  # JAX's bundle_adjust refines in place
    jrec = type(r)(calib=r.calib, world=np.array(r.world),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)
    jrec, jinfo = j_bundle_adjust(jrec, JBaConfig(dtype="float64"))
    rec, info = bundle_adjust(want_recon, BaConfig(dtype="float64"), device="cpu")
    assert set(info) == set(jinfo)
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


@pytest.mark.parametrize("max_cams,solver", [(256, "dense_schur"), (4, "pcg")])
def test_bundle_adjust_refine_cameras_matches_jax(sphere_sparse, max_cams, solver):
    """refine_cameras: the solver choice on dense_schur_max_cams, the info
    keys (cams11 too) and the metrics of sfm_tpu's bundle_adjust; float64.
    Dense: the tolerances of check_joint.  PCG: on this ring every CG solve
    but one stops at its 100-iteration cap unconverged, which carries the
    packages' different summation order into the step, so costs are held
    to 1 % and parameters to 1e-2."""
    tol = 1e-6 if solver == "dense_schur" else 1e-2
    atol = 1e-5 if solver == "dense_schur" else 1e-2
    r = sphere_sparse
    jrec = type(r)(calib=r.calib, world=np.array(r.world),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)
    jrec, jinfo = j_bundle_adjust(
        jrec, JBaConfig(dtype="float64", refine_cameras=True,
                        dense_schur_max_cams=max_cams))
    rec, info = bundle_adjust(
        sparse_from_jax(r), BaConfig(dtype="float64", refine_cameras=True,
                                     dense_schur_max_cams=max_cams), device="cpu")
    # The port adds the counts of its dense gate (ba.run.dense_gate) and of
    # its CG solves.
    assert set(info) - set(GATE_KEYS) == set(jinfo)
    assert info["ba_dense_schur_decided_by"] == (
        "dense" if solver == "dense_schur" else "max_cams")
    assert info["camera_solver"] == jinfo["camera_solver"] == solver
    assert info["refined_cameras"] is True
    for k in ("num_observations", "num_points", "num_cameras", "iterations"):
        assert info[k] == jinfo[k], k
    for k in ("final_cost", "rms_reproj_refined_px"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=tol, err_msg=k)
    assert info["cams11"].shape == (12, 12)
    np.testing.assert_allclose(info["cams11"], np.asarray(jinfo["cams11"]),
                               rtol=tol, atol=atol)
    np.testing.assert_allclose(rec.world, jrec.world, rtol=0, atol=atol)
    assert set(rec.metrics.values) == set(jrec.metrics.values) | set(GATE_KEYS)
    for k, v in jrec.metrics.values.items():
        np.testing.assert_allclose(rec.metrics.values[k], v, rtol=10 * tol,
                                   err_msg=k)
    # The joint optimum is below the points-only one, while the rms against
    # the calibration (the cameras that are kept) is above the optimum's own.
    assert (rec.metrics.values["ba_rms_reproj_after_px"]
            > info["rms_reproj_refined_px"])


def test_dense_schur_max_span_is_deprecated(sphere_sparse):
    with pytest.warns(DeprecationWarning, match="dense_schur_max_span"):
        bundle_adjust(sparse_from_jax(sphere_sparse),
                      BaConfig(dtype="float64", dense_schur_max_span=8),
                      device="cpu")


def jax_copy(r):
    """A copy of sfm_tpu's SparseReconstruction (its BA refines in place)."""
    return type(r)(calib=r.calib, world=np.array(r.world),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)


def test_dense_gate_sweep_matches_jax(sphere_sparse):
    """dense_schur_max_bytes swept across sfm_tpu's grid bound
    (4 * T * Nc * 144) on the sphere ring, f32: camera_solver equals
    sfm_tpu's at every value.  Here the port's pair assembly is smaller
    than the grids, so the grid bound decides."""
    r = sphere_sparse
    grid = 4 * r.num_tracks * r.calib.num_views * 144
    values = (0, grid - 1, grid, grid + 1, 2 << 30)
    solvers = []
    for bound in values:
        kw = dict(dtype="float32", refine_cameras=True, max_iterations=1,
                  dense_schur_max_bytes=bound)
        _, jinfo = j_bundle_adjust(jax_copy(r), JBaConfig(**kw))
        _, info = bundle_adjust(sparse_from_jax(r), BaConfig(**kw), device="cpu")
        assert info["camera_solver"] == jinfo["camera_solver"], bound
        assert info["ba_dense_schur_grid_bytes"] == grid
        assert info["ba_dense_schur_pair_bytes"] < grid
        solvers.append((info["camera_solver"], info["ba_dense_schur_decided_by"]))
    assert solvers == [("pcg", "grid_bytes")] * 2 + [("dense_schur", "dense")] * 3


def long_track_recon(n_cams=6, n_pts=120, seed=0):
    """Every point seen by every camera of a ring (tracks of length n_cams):
    P = T * n_cams^2 same-point pairs, far more than the T * Nc of sfm_tpu's
    grids."""
    rng = np.random.default_rng(seed)
    _, cal = synth.render_scene(synth.ring_rig(n_cams), w=64, h=48, seed=seed)
    world = rng.normal(size=(n_pts, 3))
    world /= np.linalg.norm(world, axis=1, keepdims=True) * 2.0
    cam = np.einsum("cij,pj->pci", cal.R, world) + cal.t[None]
    pix = np.einsum("cij,pcj->pci", cal.K, cam)
    pix = pix[..., :2] / pix[..., 2:]
    obs = np.concatenate([np.broadcast_to(np.arange(n_cams)[None, :, None],
                                          (n_pts, n_cams, 1)),
                          np.rint(pix)], axis=2).reshape(-1, 3).astype(np.int32)
    offsets = np.arange(n_pts + 1, dtype=np.int64) * n_cams
    jrec = JSparseReconstruction(
        calib=JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names),
        world=world, track_offsets=offsets, track_obs=obs)
    return jrec


def test_dense_gate_pair_bound_sends_long_tracks_to_pcg():
    """Long tracks: the port's pair bytes exceed the bound while sfm_tpu's
    grid bytes do not, so the port solves by PCG (decided by "pair_bytes",
    recorded in info and the metrics) where sfm_tpu solves densely: the
    deliberate difference of ba.run.dense_gate."""
    jrec = long_track_recon()
    grid = 4 * jrec.num_tracks * jrec.calib.num_views * 144
    kw = dict(dtype="float32", refine_cameras=True, max_iterations=3,
              dense_schur_max_bytes=grid)
    _, jinfo = j_bundle_adjust(jax_copy(jrec), JBaConfig(**kw))
    rec, info = bundle_adjust(sparse_from_jax(jrec), BaConfig(**kw), device="cpu")
    assert jinfo["camera_solver"] == "dense_schur"
    assert info["camera_solver"] == "pcg"
    assert info["ba_dense_schur_decided_by"] == "pair_bytes"
    assert info["ba_dense_schur_pairs"] == jrec.num_tracks * 6 ** 2
    assert info["ba_dense_schur_pair_bytes"] > grid >= info["ba_dense_schur_grid_bytes"]
    assert rec.metrics.values["ba_dense_schur_decided_by"] == "pair_bytes"
    assert info["iterations"] >= 1
    # With room for the pairs both packages solve densely.
    _, info = bundle_adjust(sparse_from_jax(jrec), BaConfig(
        **{**kw, "dense_schur_max_bytes": info["ba_dense_schur_pair_bytes"]}),
        device="cpu")
    assert info["camera_solver"] == "dense_schur"


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


@pytest.fixture(scope="module")
def captured_joint(captured):
    """The captured dinoRing-48 problem solved as quality.py:190 does
    (optimize_cameras=True, 100 iterations, ftol 1e-6), by sfm_tpu (PCG, as
    quality.py runs it) and by both of the port's camera solvers."""
    (cams0, pts0), (camsf, ptsf), (ci, pi, obs, mask) = captured
    jp = JBAProblem(
        cams=jnp.asarray(cams0), points=jnp.asarray(pts0),
        cam_idx=jnp.asarray(ci, jnp.int32), point_idx=jnp.asarray(pi, jnp.int32),
        obs_2d=jnp.asarray(obs), mask=jnp.asarray(mask),
    )
    tp = BAProblem.from_numpy(cams0, pts0, ci, pi, obs, mask)
    n_obs = int(mask.sum())

    def rms(cost):
        return float(np.sqrt(2.0 * float(cost) / n_obs))

    kw = dict(max_iterations=100, ftol=1e-6, optimize_cameras=True)
    ref = rms(total_cost(*(getattr(
        BAProblem.from_numpy(camsf, ptsf, ci, pi, obs, mask), f) for f in FIELDS)))
    out = {"reference": (ref, None), "jax": (lambda r: (rms(r[2]), int(r[3])))(
        j_solve_lm(jp, **kw))}
    for name, span in (("pcg", 0), ("dense", 1)):
        r = solve_lm(tp, pair_span=span, **kw)
        out[name] = (rms(r[2]), r[3])
    return out


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_captured_problem_joint_solve(captured_joint, solver):
    """Within 1 % of sfm_tpu's rms and <= 1.05 x the reference's (the
    criterion of quality.py:_ba_solver_parity)."""
    ref, _ = captured_joint["reference"]
    j_rms, j_it = captured_joint["jax"]
    rms, it = captured_joint[solver]
    assert it >= 2 and j_it >= 2
    assert abs(rms - j_rms) <= 0.01 * j_rms, (rms, j_rms)
    assert rms <= 1.05 * ref, (rms, ref)
