"""The port's benchmark harness (``bench_torch.py``) against the stages it
drives and against ``bench.py``, on the CPU.

The ring is the 12-frame 200x150 textured sphere, written to disk in
dinoRing's layout (``dinoR0001.png`` ..., ``dinoR_par.txt``) so that
``--data`` reads it as it reads dinoRing.  Against ``bench.run_pipeline``
(f64 BA, MVS at scale 10, ``defer_fetch=False``) the counts agree within
5 %: the two frameworks draw their RANSAC hypotheses from different
generators (``sfm_tpu_torch/sfm/ransac.py``), which keeps other matches.
Measured on this ring: 127 tracks against 132 (3.8 %) and 116 dense
points against 121 (4.1 %).
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import bench
import bench_torch
from sfm_tpu.config import BaConfig as JBaConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.io import load_images as j_load_images
from sfm_tpu.io import read_pars as j_read_pars

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import BaConfig, MvsConfig, PipelineConfig, RuntimeConfig
from sfm_tpu_torch.io import load_images, read_pars
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 12
KEYS = {"metric", "value", "unit", "vs_baseline", "wall_s", "wall_median_s",
        "wall_mean_s", "wall_samples_s", "cold_s", "cold_attribution",
        "sfm_ba_s", "mvs_s", "tracks", "rms_reproj_px", "rms_reproj_refined_px",
        "dense_points", "refine_cameras", "overlap", "timers", "cold_timers",
        "kernels"}
CPU_CONFIG = PipelineConfig(ba=BaConfig(dtype="float64"), mvs=MvsConfig(),
                            runtime=RuntimeConfig(device="cpu"))


@pytest.fixture(scope="module")
def ring_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bench") / "ring")
    synth.write_middlebury_dataset(
        d, centers=synth.ring_rig(FRAMES), w=200, h=150, prefix="dinoR",
        image_type="png", spheres=(((0.0, 0.0, 0.0), 1.0),), seed=0)
    return d


def _load(d):
    images, _ = load_images(d, "png", max_images=FRAMES)
    calib = read_pars(os.path.join(d, "dinoR_par.txt"))
    return images, calib.subset(range(images.shape[0]))


def bench_line(argv):
    """``bench_torch.main(argv)``'s exit code and its printed lines."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_torch.main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def port_run(ring_dir):
    images, calib = _load(ring_dir)
    return bench_torch.run_pipeline(images, calib, CPU_CONFIG, True, 10.0)


@pytest.fixture(scope="module")
def jax_run(ring_dir):
    """``bench.run_pipeline`` on the ring with the same knobs."""
    images, _ = j_load_images(ring_dir, "png", max_images=FRAMES)
    calib = j_read_pars(os.path.join(ring_dir, "dinoR_par.txt"))
    calib = calib.subset(range(images.shape[0]))
    config = JPipelineConfig(ba=JBaConfig(dtype="float64"), mvs=JMvsConfig())
    return bench.run_pipeline(images, calib, config, True, 10.0,
                              defer_fetch=False)


@pytest.fixture(scope="module")
def main_line(ring_dir):
    rc, lines = bench_line(["--data", ring_dir, "--device", "cpu", "--warm",
                            "1", "--frames", str(FRAMES)])
    return rc, lines


def test_run_pipeline_is_the_stages_called_directly(ring_dir, monkeypatch):
    """run_pipeline's sparse tracks, SfM world, BA points and dense cloud
    are bit-equal to the three stages called one after another."""
    images, calib = _load(ring_dir)
    seen = {}

    def sfm_spy(*a, **k):
        r = structure_from_motion(*a, **k)
        seen["world"] = r.world.copy()
        return r

    def mvs_spy(*a, **k):
        seen["dense"] = dense_reconstruction(*a, **k)
        return seen["dense"]

    monkeypatch.setattr(bench_torch, "structure_from_motion", sfm_spy)
    monkeypatch.setattr(bench_torch, "dense_reconstruction", mvs_spy)
    recon, t_sfm_ba, t_mvs, n_dense, timers, info = bench_torch.run_pipeline(
        images, calib, CPU_CONFIG, True, 10.0)

    want = structure_from_motion(images, calib, CPU_CONFIG)
    assert np.array_equal(seen["world"], want.world)
    want, want_info = bundle_adjust(want, CPU_CONFIG.ba, device="cpu")
    want_dense = dense_reconstruction(images, calib, want, CPU_CONFIG.mvs, 10.0,
                                      device="cpu")
    assert np.array_equal(recon.track_obs, want.track_obs)
    assert np.array_equal(recon.track_offsets, want.track_offsets)
    assert np.array_equal(recon.world, want.world)
    assert info["rms_reproj_refined_px"] == want_info["rms_reproj_refined_px"]
    assert np.array_equal(seen["dense"].points, want_dense.points)
    assert n_dense == want_dense.num_points > 0
    assert t_sfm_ba > 0 and t_mvs > 0
    assert set(timers) == {"sfm", "ba", "mvs"}
    assert set(timers["sfm"]) == {"features", "pair_geometry", "tracks"}
    assert set(timers["ba"]) == {"assemble", "solve", "fetch"}
    assert {"seed", "expand"} <= set(timers["mvs"])


def test_run_pipeline_against_bench_py(port_run, jax_run):
    recon, _, _, n_dense, _, _ = port_run
    jrecon, _, _, j_dense = jax_run
    assert abs(recon.num_tracks - jrecon.num_tracks) <= 0.05 * jrecon.num_tracks, (
        recon.num_tracks, jrecon.num_tracks)
    assert abs(n_dense - j_dense) <= 0.05 * j_dense, (n_dense, j_dense)
    assert recon.rms_reprojection_error() < 0.3
    assert jrecon.rms_reprojection_error() < 0.3
    assert n_dense > 0 and recon.num_tracks > 100


def test_main_prints_one_line_with_every_key(main_line, port_run):
    rc, lines = main_line
    assert rc == 0 and len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == KEYS
    assert r["metric"] == f"ring {FRAMES}-frame SfM+BA+MVS(100k budget) on cpu"
    assert r["unit"] == "frames/s" and r["vs_baseline"] is None
    assert r["kernels"] is None
    assert len(r["wall_samples_s"]) == 1
    assert r["wall_s"] == r["wall_median_s"] == r["wall_mean_s"] == r["wall_samples_s"][0]
    assert r["value"] == pytest.approx(FRAMES / r["wall_s"])
    assert r["refine_cameras"] is False
    assert r["overlap"] == {"ba_defer_fetch": True, "seed_fetch": True}
    attr = r["cold_attribution"]
    assert set(attr) == {"cuda_init_s", "build_s", "load_s", "residual_s"}
    assert attr["cuda_init_s"] is None and attr["load_s"] > 0
    assert attr["residual_s"] == pytest.approx(r["cold_s"] - attr["build_s"])
    assert set(r["timers"]) == set(r["cold_timers"]) == {"sfm", "ba", "mvs"}
    recon, _, _, n_dense, _, info = port_run
    assert r["tracks"] == recon.num_tracks
    assert r["rms_reproj_px"] == recon.rms_reprojection_error()
    assert r["rms_reproj_refined_px"] == info["rms_reproj_refined_px"]
    assert r["dense_points"] == n_dense
    assert r["mvs_s"] > 0 and r["sfm_ba_s"] > 0


@pytest.mark.parametrize("flag", ["--refine_cameras", "--skip-mvs",
                                  "--no-defer-fetch", "--no-seed-overlap"])
def test_main_flags(ring_dir, main_line, flag):
    rc, lines = bench_line(["--data", ring_dir, "--device", "cpu", "--warm",
                            "1", "--no-kernels", flag])
    assert rc == 0 and len(lines) == 1
    r = json.loads(lines[0])
    base = json.loads(main_line[1][0])
    assert set(r) == KEYS - {"kernels"}
    assert r["tracks"] == base["tracks"]
    if flag == "--refine_cameras":
        assert r["refine_cameras"] is True
        assert r["dense_points"] > 0
        # Joint BA lowers the rms at its own cameras below the points-only
        # optimum, which is measured at the calibration's.
        assert r["rms_reproj_refined_px"] < base["rms_reproj_refined_px"]
    elif flag == "--skip-mvs":
        assert r["refine_cameras"] is False
        assert r["dense_points"] == 0 and r["mvs_s"] == 0
        assert "mvs" not in r["timers"]
        assert "+MVS" not in r["metric"]
        assert r["rms_reproj_px"] == base["rms_reproj_px"]
    else:
        # bench.py's overlap switches move when the host reads, not what
        # it reads: the line's outputs are the default run's.
        assert r["overlap"] == {"ba_defer_fetch": flag != "--no-defer-fetch",
                                "seed_fetch": flag != "--no-seed-overlap"}
        for k in ("rms_reproj_px", "rms_reproj_refined_px", "dense_points"):
            assert r[k] == base[k], k
        assert set(r["timers"]["ba"]) == {"assemble", "solve", "fetch"}


def test_cuda_without_a_gpu_exits_1(ring_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = bench_torch.main(["--data", ring_dir, "--warm", "0"])
    cap = capsys.readouterr()
    assert rc == 1 and cap.out == ""
    assert "--device cpu" in cap.err


@pytest.mark.parametrize("what", ["directory", "calibration"])
def test_missing_data_exits_1(tmp_path, capsys, what):
    d = tmp_path / "absent"
    if what == "calibration":
        d.mkdir()  # a directory without dinoR_par.txt
    rc = bench_torch.main(["--data", str(d), "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 1 and cap.out == ""
    assert str(d) in cap.err


def test_vs_baseline_only_on_dinoring():
    """bench.py's ratio (:239-246), given only for the dataset it was
    measured on."""
    fps, n = 12.0, 48
    want = fps / (n / (bench.BASELINE_SFM_BA_S + bench.BASELINE_MVS_100K_S))
    assert bench_torch.vs_baseline(fps, n, "dinoRing", False) == pytest.approx(want)
    want = fps / (n / bench.BASELINE_SFM_BA_S)
    assert bench_torch.vs_baseline(fps, n, "dinoRing", True) == pytest.approx(want)
    assert bench_torch.vs_baseline(fps, n, "ring", False) is None


def test_import_loads_no_jax():
    code = ("import sys; import bench_torch; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'sfm_tpu.')) or m == 'sfm_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
