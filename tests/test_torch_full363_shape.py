"""The full dino set's cell (``dino_full363.seq_joint_scale10``) at a
shape the CPU holds: a 40-view ring of 160x120 through the benchmark's
pass (``structure_from_motion`` -> joint ``bundle_adjust``) with the dense
gate's camera bound below 40, so that the ring's own tracks reach PCG as
the 363 views do on the card, judged against the plain reference's stages
(``benchmark/sfmref``) with the benchmark's comparison.  MVS at 363 views
is held by the cell's ``correct`` on the card."""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import sfmref  # noqa: E402
from benchkit import judge, program, scene  # noqa: E402
from benchkit.harness import n_pairs, ransac_uniforms  # noqa: E402

from sfm_tpu_torch.features import frontend  # noqa: E402
from sfm_tpu_torch.ops import harris  # noqa: E402

torch.set_num_threads(2)

CELL = "dino_full363.seq_joint_scale10"
SEED = 2_900_000_017
FRAMES, WIDTH, HEIGHT, FOCAL = 40, 160, 120, 192.0
MAX_CAMS = 32


@pytest.fixture(scope="module")
def cell():
    with open(os.path.join(BENCH, "workloads", f"{CELL}.json")) as f:
        job = json.load(f)
    with open(os.path.join(BENCH, "configs", f"{job['config']}.json")) as f:
        config = json.load(f)
    return job, config


def shrunk(config):
    """The cell's configuration on a 40-view ring of 160x120 (focal 1.2
    x width, as the cell's), 512 corners, the dense gate's camera bound
    at 32 and 12 LM iterations, to keep the pass to seconds on the CPU."""
    config = json.loads(json.dumps(config))
    config["scene"].update(frames=FRAMES, width=WIDTH, height=HEIGHT,
                           focal_px=FOCAL)
    config["pipeline"]["features"]["max_corners"] = 512
    config["pipeline"]["ba"].update(dense_schur_max_cams=MAX_CAMS,
                                    max_iterations=12)
    return config


def test_the_cells_stages_and_limits(cell):
    job, config = cell
    assert job["stages"] == ["sfm", "ba", "mvs"]
    assert job["pair_mode"] == "sequence" and job["refine_cameras"]
    assert config["scene"]["frames"] == 363
    assert (config["scene"]["width"], config["scene"]["height"]) == (640, 480)
    assert config["scene"]["frames"] > config["pipeline"]["ba"][
        "dense_schur_max_cams"]
    with open(os.path.join(BENCH, "configs", "dino_ring48.json")) as f:
        assert config["pipeline"] == json.load(f)["pipeline"]
    assert job["limits"] == {"tracks_differ": 0.02, "ba_points_moved": 0.05,
                             "ba_rms_gap": 0.02, "dense_differ": 0.01}


def test_40_view_ring_through_pcg_matches_the_reference(cell, monkeypatch):
    # The kernel route on the CPU: each wrapper runs its plain version for
    # CPU tensors, so the SfM descriptors are bf16 as the card's K2 writes
    # them and as the reference rounds them (the plain route's float32
    # descriptors match a few tracks differently).
    monkeypatch.setattr(frontend, "use_kernel", lambda t, k: True)
    monkeypatch.setattr(harris, "use_kernel", lambda t, k: True)
    job, config = cell
    job = dict(job, stages=["sfm", "ba"])
    config = shrunk(config)
    device = torch.device("cpu")
    images, K, R, t = scene.render(config["scene"], 0, device)
    pconfig = program.pipeline_config(config, job, device, SEED)
    rec = program.run_pass(images.copy(), program.calibration(K, R, t),
                           pconfig, job, device)
    out = rec["out"]
    assert rec["timers"]["ba.solve.cg"] > 0
    assert rec["timers"]["ba.solve.cg.wait"] > 0
    uniforms = ransac_uniforms(n_pairs(FRAMES, job["pair_mode"]),
                               config["pipeline"]["ransac"]["num_hypotheses"],
                               SEED)
    params = config["pipeline"]
    ref_sfm = sfmref.sparse_stage(images, K, R, t, params, job, uniforms,
                                  device)
    ref_next = judge.reference_next(images, (K, R, t), out, params, job,
                                    device)
    numbers = judge.compare(out, ref_sfm, ref_next, (K, R, t), device)
    assert numbers["tracks"] > 300, numbers
    # Same images, cameras, draws and precisions: every number reads 0.
    assert numbers["tracks_differ"] == 0, numbers
    assert numbers["ba_points_moved"] == 0
    assert numbers["ba_rms_gap"] == 0
    assert abs(out["ba_world"] - out["world"]).max() > 1e-4  # BA moved them
