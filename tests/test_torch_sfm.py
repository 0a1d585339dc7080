"""Parity of the port's host layer, RANSAC, track store and sparse pipeline
with sfm_tpu's, on the CPU.

RANSAC draws cannot be reproduced across frameworks, so the slice test
feeds the JAX package's own draws (``jax.random.categorical`` per pair, as
sfm_tpu/sfm/ransac.py makes them) into the port; with them the sparse
reconstruction must agree observation for observation.  With the port's
own generator it is held at stage level.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfm_tpu.config as jconfig
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.features.frontend import detect_and_describe as j_describe
from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.calib import read_pars as j_read_pars
from sfm_tpu.io.images import device_gray
from sfm_tpu.sfm.pipeline import pair_schedule as j_pair_schedule
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from sfm_tpu.sfm.ransac import ransac_fundamental as j_ransac
from sfm_tpu.sfm.tracks import TrackStore as JTrackStore
from sfm_tpu.utils import synth as j_synth

import sfm_tpu_torch.config as tconfig
from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.io import Calibration, gray_tensor, read_pars, read_ply, write_pars
from sfm_tpu_torch.io.ply import export_ply
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.sfm.pipeline import pair_schedule, structure_from_motion
from sfm_tpu_torch.sfm.ransac import draw_samples, ransac_fundamental
from sfm_tpu_torch.sfm.tracks import TrackStore
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_draws(valid, key, num_hypotheses):
    """RANSAC hypotheses exactly as sfm_tpu/sfm/ransac.py draws them."""
    logits = jnp.where(valid, 0.0, -jnp.inf)
    return np.asarray(
        jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, 8))
    )


# --- config, io, synthetic scenes -------------------------------------------

SUBCONFIGS = ["FeatureConfig", "RansacConfig", "SfmConfig", "BaConfig",
              "MvsConfig", "RuntimeConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", SUBCONFIGS)
def test_config_defaults_match(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(jconfig, name))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tconfig, name))}
    renamed = {"use_pallas"} if name == "RuntimeConfig" else set()
    added = {"device", "kernels"} if name == "RuntimeConfig" else set()
    assert set(jf) - renamed == set(tf) - added
    j_obj, t_obj = getattr(jconfig, name)(), getattr(tconfig, name)()
    for f in set(jf) - renamed:
        jv, tv = getattr(j_obj, f), getattr(t_obj, f)
        if dataclasses.is_dataclass(jv):
            continue  # nested sub-configs are their own cases
        assert jv == tv, f"{name}.{f}: {jv!r} != {tv!r}"


def test_from_jax_config_and_kernels_switch():
    j = JPipelineConfig(
        image_type="png", max_images=7,
        features=JFeatureConfig(max_corners=333, lowe_ratio=0.7),
        ransac=jconfig.RansacConfig(num_hypotheses=64),
        sfm=jconfig.SfmConfig(pair_mode="combination"),
        runtime=jconfig.RuntimeConfig(seed=5, use_pallas=False),
    )
    t = tconfig.from_jax_config(j, device="cpu")
    assert (t.image_type, t.max_images) == ("png", 7)
    assert t.features.max_corners == 333 and t.features.lowe_ratio == 0.7
    assert t.ransac.num_hypotheses == 64 and t.sfm.pair_mode == "combination"
    assert t.runtime.seed == 5 and t.runtime.kernels is False
    assert t.runtime.device == "cpu"
    cpu = torch.zeros(1)
    cuda = torch.zeros(1, device="meta")  # stands in for a non-CPU tensor
    assert use_kernel(cpu, None) is False and use_kernel(cpu, False) is False
    with pytest.raises(ValueError):
        use_kernel(cpu, True)
    assert use_kernel(cuda, False) is False


def test_io_matches_jax(tmp_path):
    images, cal = synth.render_scene(synth.ring_rig(3), w=64, h=48, seed=2)
    jimages, jcal = j_synth.render_scene(j_synth.ring_rig(3), w=64, h=48, seed=2)
    np.testing.assert_array_equal(images, jimages)
    for a in ("K", "R", "t"):
        np.testing.assert_array_equal(getattr(cal, a), getattr(jcal, a))
    par = str(tmp_path / "x_par.txt")
    write_pars(par, cal)
    mine, theirs = read_pars(par), j_read_pars(par)
    for a in ("K", "R", "t", "P", "centers"):
        np.testing.assert_array_equal(getattr(mine, a), getattr(theirs, a))
    assert mine.names == theirs.names
    again = Calibration.from_numpy(theirs.K, theirs.R, theirs.t, theirs.names)
    np.testing.assert_array_equal(again.P, mine.P)
    np.testing.assert_array_equal(
        gray_tensor(images, "cpu").numpy(), np.asarray(device_gray(images))
    )
    with pytest.raises(ValueError, match="malformed"):
        (tmp_path / "bad_par.txt").write_text("1\nname 1 2 3\n")
        read_pars(str(tmp_path / "bad_par.txt"))
    pts = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    export_ply(str(tmp_path / "p.ply"), pts)
    back, cols = read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(back, pts)
    assert cols is None


def test_pair_schedule_matches_jax():
    for mode in ("sequence", "combination"):
        assert pair_schedule(6, mode) == j_pair_schedule(6, mode)
    with pytest.raises(ValueError):
        pair_schedule(4, "bogus")


# --- RANSAC -------------------------------------------------------------------

def two_view_scene(seed, n=200, outlier_frac=0.3):
    """Projected random points in two cameras, the first n*outlier_frac
    correspondences shifted off their epipolar lines."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.3 + np.array([0, 0, 3.0])
    K = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    a, b = 0.25, 0.08
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    P1 = K @ np.eye(3, 4)
    P2 = K @ np.concatenate([Ry @ Rx, np.array([[0.4], [0.05], [0.1]])], 1)
    Xh = np.concatenate([pts, np.ones((n, 1))], 1)
    h1, h2 = Xh @ P1.T, Xh @ P2.T
    p1 = h1[:, :2] / h1[:, 2:]
    p2 = h2[:, :2] / h2[:, 2:]
    n_out = int(n * outlier_frac)
    p2[:n_out] += rng.uniform(20, 80, size=(n_out, 2))
    return p1.astype(np.float32), p2.astype(np.float32), n_out


def test_ransac_with_jax_draws():
    """Fed the same hypotheses, the port picks the same inliers and F
    (F is unit-norm; f32 8-point solves agree to 1e-4)."""
    H = 256
    scenes = [two_view_scene(7), two_view_scene(8, outlier_frac=0.1)]
    p1 = np.stack([s[0] for s in scenes])
    p2 = np.stack([s[1] for s in scenes])
    valid = np.ones(p1.shape[:2], bool)
    valid[1, 150:] = False
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draws, want = [], []
    for p in range(2):
        draws.append(jax_draws(jnp.asarray(valid[p]), keys[p], H))
        want.append(j_ransac(jnp.asarray(p1[p]), jnp.asarray(p2[p]),
                             jnp.asarray(valid[p]), keys[p], num_hypotheses=H))
    F, inl, n_inl = ransac_fundamental(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        samples=torch.from_numpy(np.stack(draws)),
    )
    for p in range(2):
        jF, jinl, jn = (np.asarray(x) for x in want[p])
        np.testing.assert_array_equal(inl[p].numpy(), jinl)
        assert int(n_inl[p]) == int(jn)
        sign = np.sign(np.sum(jF * F[p].numpy()))  # F is defined up to sign
        np.testing.assert_allclose(sign * F[p].numpy(), jF, rtol=0, atol=1e-4)
    n_out = scenes[0][2]
    assert inl[0, :n_out].float().mean() < 0.05 and inl[0, n_out:].float().mean() > 0.98


def test_draw_samples():
    valid = torch.zeros(3, 50, dtype=torch.bool)
    valid[0, :20] = True
    valid[1, ::7] = True
    a = draw_samples(valid, 64, torch.Generator().manual_seed(1))
    b = draw_samples(valid, 64, torch.Generator().manual_seed(1))
    assert a.shape == (3, 64, 8) and torch.equal(a, b)
    assert torch.gather(valid[:2], 1, a[:2].reshape(2, -1)).all()
    assert set(a[1].unique().tolist()) == set(range(0, 50, 7))  # all reached
    assert (a[2] == 0).all()  # no valid rows


# --- track store --------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_track_store_matches_jax_python_store(native):
    rng = np.random.default_rng(4)
    mine = TrackStore(0.05, native=native)
    ref = JTrackStore(0.05, native=False)
    assert mine.backend == ("native" if native else "python")
    # A small coordinate universe forces all four merge cases and
    # invalidations.
    for _ in range(20):
        m = 50
        obs_a = np.stack([rng.integers(0, 3, m), rng.integers(0, 6, m),
                          rng.integers(0, 6, m)], 1).astype(np.int32)
        obs_b = np.stack([rng.integers(3, 6, m), rng.integers(0, 6, m),
                          rng.integers(0, 6, m)], 1).astype(np.int32)
        pts = rng.normal(size=(m, 3)) * 0.03
        mine.add_pairs(obs_a, obs_b, pts)
        ref.add_pairs(obs_a, obs_b, pts)
    assert mine.info() == ref.info()
    for x, y in zip(mine.export(), ref.export()):
        np.testing.assert_array_equal(x, y)
    w = np.arange(mine.info()[0] * 3, dtype=np.float64).reshape(-1, 3)
    mine.update_world(w)
    ref.update_world(w)
    np.testing.assert_array_equal(mine.export()[0], ref.export()[0])
    with pytest.raises(ValueError):
        mine.add_pairs(obs_a[:, :2], obs_b, pts)
    mine.close()


# --- the slice: structure_from_motion --------------------------------------------

@pytest.fixture(scope="module")
def sphere_ring():
    """The 12-frame 200x150 sphere ring of tests/test_pipeline_synthetic.py."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    return images, cal


@pytest.fixture(scope="module")
def slice_runs(sphere_ring):
    images, cal = sphere_ring
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    want = j_sfm(images, jcal, jcfg)
    # JAX's per-pair draws, from JAX's own matches (sfm_tpu pipeline :414).
    fc = jcfg.features
    fs = j_describe(device_gray(images), fc, use_pallas=False)
    pairs = j_pair_schedule(images.shape[0])
    keys = jax.random.split(jax.random.PRNGKey(jcfg.runtime.seed), len(pairs))
    draws = []
    for p, (a, b) in enumerate(pairs):
        m = j_match(fs.descriptors[a], fs.valid[a], fs.descriptors[b], fs.valid[b],
                    lowe_ratio=fc.lowe_ratio, max_matches=fc.max_matches,
                    mutual_check=fc.mutual_check)
        draws.append(jax_draws(m.valid & (m.count >= fc.min_matches), keys[p],
                               jcfg.ransac.num_hypotheses))
    cfg = tconfig.from_jax_config(jcfg, device="cpu")
    calib = Calibration.from_numpy(cal.K, cal.R, cal.t, cal.names)
    fed = structure_from_motion(images, calib, cfg,
                                ransac_samples=torch.from_numpy(np.stack(draws)))
    own = structure_from_motion(images, calib, cfg)
    return want, fed, own


def test_slice_matches_jax_with_fed_draws(slice_runs):
    want, fed, _ = slice_runs
    assert want.num_tracks > 50
    np.testing.assert_array_equal(fed.track_offsets, want.track_offsets)
    np.testing.assert_array_equal(fed.track_obs, want.track_obs)
    # f32 DLT + Gauss-Newton in two frameworks: world points to 1e-5 units
    # (the 0.3 px gate is ~2.5e-3 units at this geometry).
    np.testing.assert_allclose(fed.world, want.world, rtol=0, atol=1e-5)
    for k in ("num_pairs", "gated_points_total", "num_tracks", "num_observations"):
        assert fed.metrics.values[k] == want.metrics.values[k], k
    assert fed.metrics.values["track_store_backend"] == "native"
    assert fed.metrics.values["kernels"] is False
    np.testing.assert_allclose(
        fed.metrics.values["mean_pair_reprojection_error_px"],
        want.metrics.values["mean_pair_reprojection_error_px"], rtol=1e-4,
    )


def test_slice_stage_level_with_own_generator(slice_runs):
    want, _, own = slice_runs
    # Different RANSAC draws: track count within 10% of JAX's, and the same
    # ground-truth bounds as tests/test_pipeline_synthetic.py.
    assert abs(own.num_tracks - want.num_tracks) <= 0.1 * want.num_tracks
    assert own.metrics.values["mean_pair_reprojection_error_px"] < 0.3
    r_err = np.abs(np.linalg.norm(own.world, axis=1) - 1.0)
    assert np.median(r_err) < 0.01
    assert np.percentile(r_err, 95) < 0.05
    assert own.track_lengths().min() >= 2
    assert own.mean_reprojection_error() < 1.0


# --- CLI and packaging ----------------------------------------------------------

def test_cli_sfm_stage(tmp_path, capsys):
    pytest.importorskip("PIL")
    ds = str(tmp_path / "ring")
    _, par, spheres = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12)[:6], w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0,
    )
    out = str(tmp_path / "out")
    args = ["-img_p", ds, "-par_p", par, "-t", "png", "--max_corners", "512",
            "--max_matches", "256", "--out_dir", out, "--device", "cpu"]
    assert t_main(args + ["--stages", "sfm"]) == 0
    summary = json.loads(
        [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    )
    assert set(summary) == {"sparse_tracks", "sparse_mean_reproj_px", "timers_s"}
    pts, _ = read_ply(os.path.join(out, "sparse_points.ply"))
    assert pts.shape == (summary["sparse_tracks"], 3) and pts.shape[0] > 50
    assert np.percentile(synth.surface_distance(pts, spheres), 95) < 0.05
    for extra in (["--stages", "sfm,ba"], ["--stages", "mvs"],
                  ["--stages", "sfm", "--plot"]):
        assert t_main(args + extra) == 2
        assert "not yet ported" in capsys.readouterr().err
    assert t_main(args + ["--stages", "sfm", "--device", "cpu",
                          "-par_p", str(tmp_path / "missing.txt")]) == 1


def test_import_leaves_jax_out():
    code = (
        "import sys, sfm_tpu_torch, sfm_tpu_torch.cli, sfm_tpu_torch.sfm, "
        "sfm_tpu_torch.ops, sfm_tpu_torch.utils.synth, sfm_tpu_torch.utils.build; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m == 'sfm_tpu' or m.startswith('sfm_tpu.') for m in sys.modules)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
