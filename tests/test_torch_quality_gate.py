"""The port's quality harness (``quality_torch.py``) against ``quality.py``,
on the CPU.

``ba_solver_parity`` runs on the reference's captured BA problem, which is
in the repository; the dinoRing criteria need the dataset, which is not,
so ``main()`` records them as skipped.  ``nn_dist``, ``_stats``,
``photo_pass_stats`` and ``dino8_evaluation`` are held to ``quality.py``'s
on the 12-frame 200x150 sphere ring instead (``photo_pass_stats`` within
0.005 in pass rate: K2's plain version and the JAX package's NCC sum in
another order, so a point whose NCC lies at the threshold may flip).
"""

import json

import numpy as np
import pytest
import torch

import quality
import quality_torch
from sfm_tpu.ba.run import bundle_adjust as j_bundle_adjust
from sfm_tpu.config import BaConfig as JBaConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.mvs import dense_reconstruction as j_dense
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import BaConfig, PipelineConfig, RuntimeConfig
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """``quality_torch.main`` on the CPU without ``--data``."""
    out = tmp_path_factory.mktemp("quality") / "QUALITY.json"
    rc = quality_torch.main(["--device", "cpu", "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_main_without_the_dataset(main_run):
    rc, res = main_run
    assert rc == 0 and res["all_pass"] is True
    assert res["backend"] == "cpu" and res["criteria"]["ba_solver_parity"]["pass"]
    assert res["skipped"] == sorted(quality_torch.DINO_CRITERIA)
    for name in quality_torch.DINO_CRITERIA:
        assert res["criteria"][name] == {"skipped": "dataset absent"}
    assert set(res) >= {"generated", "git_rev", "reference", "ours", "criteria"}


def test_main_rejects_a_data_dir_without_the_dataset(tmp_path):
    with pytest.raises(SystemExit) as e:
        quality_torch.main(["--device", "cpu", "--data", str(tmp_path),
                            "--out", str(tmp_path / "QUALITY.json")])
    assert e.value.code == 2 and not (tmp_path / "QUALITY.json").exists()


def test_ba_solver_parity_matches_quality_py(main_run):
    ours = main_run[1]["criteria"]["ba_solver_parity"]
    ref = quality._load_ref()
    want = quality._ba_solver_parity(ref["dino48_sparse"]["internal_rms_px"])
    assert ours["pass"] and want["pass"]
    assert abs(ours["model_check_rms_at_ref_solution"] - ours["reference_rms"]) < 0.02
    assert ours["ours_rms"] <= 1.05 * ours["reference_rms"]
    assert abs(ours["ours_rms"] - want["ours_rms"]) <= 1e-3, (ours, want)
    assert ours["n_obs"] == want["n_obs"] and ours["reference_rms"] == want["reference_rms"]


@pytest.mark.parametrize("n_a,n_b", [(1, 1), (500, 2000), (3000, 257)])
def test_nn_dist_and_stats_match_quality_py(n_a, n_b):
    rng = np.random.default_rng(n_a + n_b)
    a, b = rng.normal(size=(n_a, 3)), rng.normal(size=(n_b, 3)) * 0.5
    d = quality_torch.nn_dist(a, b)
    assert np.array_equal(d, quality.nn_dist(a, b))
    brute = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(d, brute, rtol=1e-12, atol=1e-12)
    assert quality_torch._stats(d) == quality._stats(d)


@pytest.fixture(scope="module")
def ring():
    """The 12-frame 200x150 ring, both packages' calibrations, the port's
    BA points (the CLI defaults on the CPU) and sfm_tpu's dense cloud at
    ``dino8_evaluation``'s MVS budget."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0)
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    recon = structure_from_motion(
        images, cal, PipelineConfig(runtime=RuntimeConfig(device="cpu")))
    recon, _ = bundle_adjust(recon, BaConfig(), device="cpu")
    jrec = j_sfm(images, jcal, JPipelineConfig())
    jrec, _ = j_bundle_adjust(jrec, JBaConfig())
    jdense = j_dense(images, jcal, jrec,
                     JMvsConfig(max_rounds=512, max_patches=1_000_000), scale=10.0)
    return dict(images=images, cal=cal, jcal=jcal,
                ba_points=recon.world.astype(np.float32), jdense=jdense)


def test_photo_pass_stats_matches_quality_py(ring):
    pts = ring["ba_points"]
    assert pts.shape[0] > 100
    got = quality_torch.photo_pass_stats(pts, ring["images"], ring["cal"], "cpu")
    want = quality.photo_pass_stats(pts, ring["images"], ring["jcal"])
    assert got["evaluated"] == want["evaluated"] == pts.shape[0]
    assert abs(got["pass_rate"] - want["pass_rate"]) <= 0.005, (got, want)
    assert 0.0 < got["pass_rate"] <= 1.0
    assert abs(got["mean_visible_views"] - want["mean_visible_views"]) <= 0.05


def test_photo_pass_stats_subsamples_as_quality_py(ring):
    """Past ``max_eval`` both draw the same subset (seed 0)."""
    jd = ring["jdense"].points
    m = jd.shape[0] // 2
    assert m > 50
    got = quality_torch.photo_pass_stats(jd, ring["images"], ring["cal"], "cpu",
                                         max_eval=m)
    want = quality.photo_pass_stats(jd, ring["images"], ring["jcal"], max_eval=m)
    assert got["evaluated"] == want["evaluated"] == m
    # One flip moves the rate by 1 / m.
    assert abs(got["pass_rate"] - want["pass_rate"]) <= max(0.005, 1 / m), (got, want)


def test_dino8_evaluation_on_the_ring(ring, tmp_path):
    jd = ring["jdense"]
    details, criteria = quality_torch.dino8_evaluation(
        ring["images"], ring["cal"], jd.points, jd.num_points, "cpu",
        out_dir=str(tmp_path))
    assert set(criteria) == {"dino8_photo_consistency", "dino8_completeness"}
    assert criteria["dino8_completeness"]["pass"], criteria
    pc = criteria["dino8_photo_consistency"]
    assert 0.0 < pc["ours_pass_rate"] <= 1.0 and 0.0 < pc["reference_pass_rate"] <= 1.0
    assert details["reference_dense_points"] == jd.num_points
    assert details["dense_points"] >= details["seeds"] > 50
    saved = np.load(tmp_path / "ours" / "dino8_full_all_patches.npz")
    assert int(saved["full_count"]) == details["dense_points"]
