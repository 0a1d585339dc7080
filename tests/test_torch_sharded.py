"""The port's multi-device path against its single-device run and against
sfm_tpu's sharded path, on the CPU.

The port's meshes are explicit 8-shard CPU meshes (``data_mesh(devices=
[cpu] * 8)``: virtual shards, the counterpart of the 8 simulated host
devices that tests/conftest.py gives JAX, where ``sfm_tpu.parallel.
data_mesh()`` spans them).  Inputs are made from a seed with numpy.

Tolerances: the sharded port against the unsharded port is held to
equality (every per-shard computation is the single-device one on a slice;
only BA's sums are regrouped per shard, so BA is held to rtol 1e-9 on the
cost and 1e-8 on the points in float64, and SfM's world points to 1e-7 and
MVS's sorted points to 1e-5, the bounds of tests/test_sharded.py).  Against
sfm_tpu: the mesh helpers and ``shard_problem`` exactly; the sharded solve
as tests/test_torch_ba.py holds the single-device one; K2s's descriptors
within 2e-2 of the Pallas interpreter's (tests/test_torch_features.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba.sharded import shard_problem as j_shard_problem
from sfm_tpu.ba.sharded import solve_lm_sharded as j_solve_lm_sharded
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.features.frontend import detect_and_describe as j_describe
from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu.ops.gather import (
    sample_normalized_patches_sharded as j_sample_sharded,
)
from sfm_tpu.parallel import data_mesh as j_data_mesh
from sfm_tpu.parallel.distributed import initialize_multihost as j_init
from sfm_tpu.parallel.mesh import pad_to_shards as j_pad_to_shards
from sfm_tpu.parallel.mesh import shard_batch as j_shard_batch
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from test_ba import synthetic_problem

import sfm_tpu_torch.config as tconfig
from sfm_tpu_torch.ba import BAProblem, bundle_adjust, solve_lm
from sfm_tpu_torch.ba.sharded import shard_problem, solve_lm_sharded
from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.config import BaConfig, MvsConfig
from sfm_tpu_torch.io import Calibration, read_ply
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.mvs.photoconsistency import photo_consistency
from sfm_tpu_torch.ops.gather import (
    sample_normalized_patches,
    sample_normalized_patches_sharded,
)
from sfm_tpu_torch.parallel import DataMesh, data_mesh
from sfm_tpu_torch.parallel.distributed import initialize_multihost
from sfm_tpu_torch.parallel.mesh import pad_to_shards, shard_batch
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = ("cams", "points", "cam_idx", "point_idx", "obs_2d", "mask")


@pytest.fixture(scope="module")
def mesh8():
    return data_mesh(devices=[CPU] * 8)


def carry(jp):
    """A JAX BAProblem's arrays as the port's BAProblem (float64)."""
    return BAProblem.from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS))


# --- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(10, 4), (12, 4), (0, 8), (5, 8), (67, 8)])
def test_pad_to_shards_and_shard_batch_match_jax(n, shards):
    arr = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
    assert shard_batch(n, shards) == j_shard_batch(n, shards)
    for fill in (0, -1):
        got, got_mask = pad_to_shards(arr, shards, fill)
        want, want_mask = j_pad_to_shards(arr, shards, fill)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)


def test_data_mesh(mesh8, monkeypatch):
    assert mesh8.shape == dict(j_data_mesh().shape) == {"data": 8}
    assert mesh8.size == 8 and mesh8.lead == CPU
    assert data_mesh(num_devices=3, devices=[CPU] * 8).shape == {"data": 3}
    with pytest.raises(ValueError):
        DataMesh([])
    # Default: every visible CUDA device; num_devices keeps the first ones
    # (more than there are gives them all, as in JAX).  Without a CUDA
    # device the default raises: a CPU mesh only comes from devices=.
    if torch.cuda.is_available():
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        assert list(data_mesh().devices) == visible
        assert list(data_mesh(num_devices=64).devices) == visible
    else:
        for kw in ({}, {"num_devices": 2}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                data_mesh(**kw)
    # Both branches on any machine: no GPU raises, three GPUs give three.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        data_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    gpus = [torch.device("cuda", i) for i in range(3)]
    assert list(data_mesh().devices) == gpus
    assert list(data_mesh(num_devices=2).devices) == gpus[:2]
    assert list(data_mesh(num_devices=64).devices) == gpus


def test_mesh_moves(mesh8):
    x = torch.arange(10 * 3).reshape(10, 3)
    parts = mesh8.split(x, fill=-1)
    assert [p.shape[0] for p in parts] == [2] * 8
    assert all((p == -1).all() for p in parts[5:]) and (parts[4] >= 0).all()
    assert torch.equal(mesh8.gather(parts, 10), x)
    assert torch.equal(mesh8.psum(parts), sum(p for p in parts))
    # Virtual shards on one device share one replica, which is the tensor
    # itself; a per-shard list passes through.
    reps = mesh8.replicate(x)
    assert len(reps) == 8 and all(r is x for r in reps)
    assert mesh8.replicate(reps) is reps
    with pytest.raises(ValueError):
        mesh8.replicate(reps[:3])
    assert [p.shape[0] for p in mesh8.split(x[:0])] == [0] * 8


def test_initialize_multihost_single_process():
    got, want = initialize_multihost(), j_init()
    assert set(got) == set(want)
    assert got["process_count"] == 1 and got["process_index"] == 0
    assert got["global_devices"] == got["local_devices"] >= 1
    # One process initializes nothing, as sfm_tpu's (a group of several:
    # tests/test_torch_multiprocess.py).
    for kw in ({}, {"num_processes": 1, "process_id": 0}):
        initialize_multihost(**kw)
        assert not torch.distributed.is_initialized()


# --- bundle adjustment ---------------------------------------------------------

@pytest.mark.parametrize("track_aligned", [False, True])
@pytest.mark.parametrize("shards", [3, 8])
def test_shard_problem_matches_jax(track_aligned, shards):
    jp, _ = synthetic_problem(np.random.default_rng(0), n_cams=3, n_pts=20)
    want = j_shard_problem(jp, shards, track_aligned=track_aligned)
    got = shard_problem(carry(jp), shards, track_aligned=track_aligned)
    assert got.obs_2d.shape[0] % shards == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.mask.sum()) == int(jp.mask.sum())


def test_solve_lm_sharded_matches_jax_and_single(mesh8):
    jp, _ = synthetic_problem(np.random.default_rng(1), n_cams=5, n_pts=100,
                              noise_3d=0.08, noise_px=0.3)
    _, jpts, jcost, jit = j_solve_lm_sharded(
        jp, j_data_mesh(), max_iterations=15, optimize_cameras=False)
    tp = carry(jp)
    cams, pts, cost, it = solve_lm_sharded(tp, mesh8, max_iterations=15,
                                           optimize_cameras=False)
    _, pts1, cost1, it1 = solve_lm(tp, max_iterations=15, optimize_cameras=False)
    assert it == int(jit) == it1 and it >= 1
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-9)
    np.testing.assert_allclose(float(cost), float(cost1), rtol=1e-9)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-8)
    np.testing.assert_allclose(pts.numpy(), pts1.numpy(), rtol=0, atol=1e-8)
    assert torch.equal(cams, tp.cams)


@pytest.mark.parametrize("span", [0, 1], ids=["pcg", "dense"])
def test_solve_lm_sharded_joint_matches_single_and_jax(mesh8, span):
    """The joint solve over 8 virtual shards (the dense one on shards cut
    at track boundaries, its partial S's psummed) against the port's single
    device and sfm_tpu's 8 simulated devices, float64: LM iterations equal,
    cost to rtol 1e-6 (regrouped sums, CG at a 1e-6 residual), parameters to
    1e-5."""
    jp, _ = synthetic_problem(np.random.default_rng(1), n_cams=5, n_pts=100,
                              noise_3d=0.08, noise_px=0.3)
    kw = dict(max_iterations=15, pair_span=span)  # optimize_cameras=True default
    jc, jpts, jcost, jit = j_solve_lm_sharded(jp, j_data_mesh(), **kw)
    tp = carry(jp)
    cams, pts, cost, it = solve_lm_sharded(tp, mesh8, **kw)
    cams1, pts1, cost1, it1 = solve_lm(tp, **kw)
    assert it == int(jit) == it1 and it >= 1
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-6)
    np.testing.assert_allclose(float(cost), float(cost1), rtol=1e-6)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pts.numpy(), pts1.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cams.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(cams.numpy(), cams1.numpy(), rtol=1e-6, atol=1e-5)
    assert not torch.equal(cams, tp.cams)


# --- K2s and photo-consistency -------------------------------------------------

def test_sample_sharded_matches_jax_interpret(mesh8):
    """The shape of tests/test_sharded.py's K2s case (the Pallas
    interpreter deadlocks under shard_map above it)."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(11)
    n_img, h, w, m = 2, 32, 256, 67
    gray = (rng.random((n_img, h, w)) * 255).astype(np.float32)
    img = rng.integers(0, n_img, m).astype(np.int32)
    ctr = np.stack([rng.uniform(0, w, m), rng.uniform(0, h, m)], 1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = j_sample_sharded(jnp.asarray(gray), jnp.asarray(img),
                                  jnp.asarray(ctr), 5, j_data_mesh(), S=8)
    before = sample_normalized_patches_sharded.launches
    d, i = sample_normalized_patches_sharded(
        torch.from_numpy(gray).to(torch.bfloat16), torch.from_numpy(img),
        torch.from_numpy(ctr), 5, mesh8)
    assert sample_normalized_patches_sharded.launches == before  # CPU: plain
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.float().numpy(), np.asarray(jd, np.float32),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("m", [67, 0, 5])
def test_sample_sharded_bit_equal_to_single(mesh8, m):
    rng = np.random.default_rng(m)
    gray = torch.from_numpy((rng.random((3, 40, 96)) * 255).astype(np.float32))
    gray = gray.to(torch.bfloat16)
    img = torch.from_numpy(rng.integers(0, 3, (m, 2)).astype(np.int32))
    ctr = torch.from_numpy(np.stack(
        [rng.uniform(-4, 100, (m, 2)), rng.uniform(-4, 44, (m, 2))], -1
    ).astype(np.float32))
    d1, i1 = sample_normalized_patches(gray, img, ctr, 5)
    d8, i8 = sample_normalized_patches_sharded(gray, img, ctr, 5, mesh8)
    assert d8.shape == (m, 2, 121) and i8.shape == (m, 2)
    assert torch.equal(d1, d8) and torch.equal(i1, i8)


@pytest.mark.parametrize("max_views", [0, 4])
def test_photo_consistency_sharded_bit_equal(mesh8, max_views):
    """The 6 x 96 x 640 scene of tests/test_sharded.py, gated and ungated,
    with views 0-2 sharing one texture (so some views pass)."""
    rng = np.random.default_rng(5)
    n_img, h, w, m = 6, 96, 640, 120
    tex = rng.random((n_img, h, w))
    tex[:3] = 0.8 * tex[0] + 0.2 * tex[:3]
    gray = torch.from_numpy((tex * 255).astype(np.float32))
    K = torch.from_numpy(np.tile(np.array(
        [[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32), (n_img, 1, 1)))
    R = torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (n_img, 1, 1)))
    t = torch.from_numpy(np.tile(np.array([0, 0, 0.6], np.float32), (n_img, 1)))
    centers = torch.from_numpy(rng.standard_normal((m, 3)).astype(np.float32) * 0.01)
    ref = torch.from_numpy(rng.integers(0, n_img, m).astype(np.int32))
    want = photo_consistency(gray, K, R, t, centers, ref, 0.4, 5, max_views)
    got = photo_consistency(gray, K, R, t, centers, ref, 0.4, 5, max_views,
                            mesh=mesh8)
    assert 0 < int(want[0].sum()) < want[0].numel() // 2  # some views pass
    for name, a, b in zip(("vis", "proj", "score", "vis_count"), got, want):
        assert torch.equal(a, b), name


# --- the stages -------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring():
    """The 12-frame 200x150 sphere ring of tests/test_pipeline_synthetic.py."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    return images, cal, jcfg, tconfig.from_jax_config(jcfg, device="cpu")


def jax_draws(images, jcfg):
    """sfm_tpu's RANSAC hypotheses per pair (its pipeline's keys, split for
    the real pairs whatever the mesh), from its own matches."""
    fc = jcfg.features
    fs = j_describe(j_device_gray(images), fc, use_pallas=False)
    n = images.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(jcfg.runtime.seed), n - 1)
    draws = []
    for p in range(n - 1):
        m = j_match(fs.descriptors[p], fs.valid[p], fs.descriptors[p + 1],
                    fs.valid[p + 1], lowe_ratio=fc.lowe_ratio,
                    max_matches=fc.max_matches, mutual_check=fc.mutual_check)
        logits = jnp.where(m.valid & (m.count >= fc.min_matches), 0.0, -jnp.inf)
        draws.append(np.asarray(jax.random.categorical(
            keys[p], logits[None, :], shape=(jcfg.ransac.num_hypotheses, 8))))
    return torch.from_numpy(np.stack(draws))


@pytest.fixture(scope="module")
def sparse(ring, mesh8):
    images, cal, _, cfg = ring
    calib = Calibration.from_numpy(cal.K, cal.R, cal.t, cal.names)
    single = structure_from_motion(images, calib, cfg)
    sharded = structure_from_motion(images, calib, cfg, mesh=mesh8)
    return single, sharded


def test_sfm_sharded_matches_single(sparse):
    single, sharded = sparse
    assert single.num_tracks > 50
    np.testing.assert_array_equal(sharded.track_offsets, single.track_offsets)
    np.testing.assert_array_equal(sharded.track_obs, single.track_obs)
    np.testing.assert_allclose(sharded.world, single.world, rtol=0, atol=1e-7)
    mv = sharded.metrics.values
    assert mv["num_pairs"] == 11 and mv["mesh_devices"] == 8
    assert mv["features_image_axis_padded"] == 4
    for k in ("gated_points_total", "mean_pair_reprojection_error_px"):
        assert mv[k] == single.metrics.values[k], k


def test_sfm_sharded_uneven_image_count(ring, mesh8):
    """6 images on 8 shards pad the image axis by 2 (sfm_tpu's value with
    shape_buckets=False) and 5 pairs by 3; the result is unchanged."""
    images, cal, _, cfg = ring
    calib = Calibration.from_numpy(cal.K[:6], cal.R[:6], cal.t[:6], cal.names[:6])
    single = structure_from_motion(images[:6], calib, cfg)
    sharded = structure_from_motion(images[:6], calib, cfg, mesh=mesh8)
    assert sharded.metrics.values["features_image_axis_padded"] == 2
    np.testing.assert_array_equal(sharded.track_obs, single.track_obs)
    np.testing.assert_allclose(sharded.world, single.world, rtol=0, atol=1e-7)


def test_sfm_sharded_matches_jax_sharded_with_fed_draws(ring, mesh8):
    images, cal, jcfg, cfg = ring
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    want = j_sfm(images, jcal, jcfg, mesh=j_data_mesh())
    calib = Calibration.from_numpy(cal.K, cal.R, cal.t, cal.names)
    got = structure_from_motion(images, calib, cfg, mesh=mesh8,
                                ransac_samples=jax_draws(images, jcfg))
    assert want.num_tracks > 50
    np.testing.assert_array_equal(got.track_offsets, want.track_offsets)
    np.testing.assert_array_equal(got.track_obs, want.track_obs)
    np.testing.assert_allclose(got.world, want.world, rtol=0, atol=1e-5)


def test_bundle_adjust_sharded(sparse, mesh8):
    single, _ = sparse

    def copy():
        return SparseReconstruction(
            calib=single.calib, world=single.world.copy(),
            track_offsets=single.track_offsets, track_obs=single.track_obs)

    r1, i1 = bundle_adjust(copy(), BaConfig(dtype="float64"), device="cpu")
    r8, i8 = bundle_adjust(copy(), BaConfig(dtype="float64"), mesh=mesh8)
    assert set(i8) == set(i1)
    assert i8["iterations"] == i1["iterations"] >= 1
    for k in ("final_cost", "rms_reproj_refined_px"):
        np.testing.assert_allclose(i8[k], i1[k], rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(r8.world, r1.world, rtol=0, atol=1e-8)
    assert r8.metrics.values["ba_mesh_devices"] == 8
    # Joint BA over the mesh (dense Schur: 12 cameras <= dense_schur_max_cams).
    joint = BaConfig(dtype="float64", refine_cameras=True)
    j1, ji1 = bundle_adjust(copy(), joint, device="cpu")
    j8, ji8 = bundle_adjust(copy(), joint, mesh=mesh8)
    assert ji8["camera_solver"] == ji1["camera_solver"] == "dense_schur"
    assert ji8["iterations"] == ji1["iterations"] >= 1
    np.testing.assert_allclose(ji8["final_cost"], ji1["final_cost"], rtol=1e-6)
    np.testing.assert_allclose(ji8["cams11"], ji1["cams11"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(j8.world, j1.world, rtol=0, atol=1e-5)
    assert ji1["final_cost"] < i1["final_cost"]


def test_dense_sharded_matches_single(ring, sparse, mesh8):
    images, cal, _, _ = ring
    single, _ = sparse
    cfg = MvsConfig(round_capacity=2048, max_rounds=3)
    d1 = dense_reconstruction(images, single.calib, single, cfg, device="cpu")
    d8 = dense_reconstruction(images, single.calib, single, cfg, mesh=mesh8)
    assert d1.num_points > d1.num_seeds > 50
    assert (d8.num_seeds, d8.num_points) == (d1.num_seeds, d1.num_points)
    np.testing.assert_allclose(np.sort(d8.points, axis=0),
                               np.sort(d1.points, axis=0), rtol=0, atol=1e-5)
    assert d8.metrics.values["mvs_rounds"] == d1.metrics.values["mvs_rounds"]
    assert d8.metrics.values["mvs_mesh_devices"] == 8


# --- the CLI ------------------------------------------------------------------------

def test_cli_mesh_devices(tmp_path, capsys):
    """--mesh_devices 2 (on the CPU: a mesh of its one device) and 1 (no
    mesh, as sfm_tpu) write the four PLY files of a run without the flag."""
    pytest.importorskip("PIL")
    ds = str(tmp_path / "ring")
    _, par, _ = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12)[:6], w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0,
    )
    names = ("sparse_points", "sparse_points_ba", "initial_patches", "all_patches")
    counts = {}
    for flag in (None, "2", "1"):
        out = str(tmp_path / f"out{flag}")
        args = ["-img_p", ds, "-par_p", par, "-t", "png", "--max_corners", "512",
                "--max_matches", "256", "--mvs_round_capacity", "2048",
                "--mvs_rounds", "3", "--out_dir", out, "--device", "cpu"]
        assert t_main(args + (["--mesh_devices", flag] if flag else [])) == 0
        summary = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                              if ln.startswith("{")][-1])
        assert summary["mvs_points"] > summary["mvs_seeds"] > 0
        counts[flag] = [read_ply(os.path.join(out, n + ".ply"))[0].shape[0]
                        for n in names]
    assert counts["2"] == counts["1"] == counts[None]
