"""Fixtures of the benchmark's own tests: a throwaway checkout that holds
``BENCHMARK.json``, the benchmark's directory and links to the program,
with a tiny test-only cell added as new files."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if REPO not in sys.path:
    sys.path.insert(1, REPO)

TINY_CELL = "tiny_ring12.seq"


def add_tiny_cell(root):
    """Add the test-only configuration ``tiny_ring12`` (12 frames of
    200x150, 512 corners, MVS rounds of 2,048) and its cell as new files,
    and list them in ``BENCHMARK.json``."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "dino_ring48.json")) as f:
        conf = json.load(f)
    conf["name"] = "tiny_ring12"
    conf["scene"].update(frames=12, width=200, height=150, focal_px=240.0)
    conf["pipeline"]["features"]["max_corners"] = 512
    conf["pipeline"]["mvs"].update(round_capacity=2048, max_rounds=8,
                                   max_patches=20000)
    with open(os.path.join(bench, "configs", "tiny_ring12.json"), "x") as f:
        json.dump(conf, f)
    with open(os.path.join(bench, "workloads",
                           "dino_ring48.seq_scale10.json")) as f:
        job = json.load(f)
    # The CPU path's SfM descriptors are float32 where the card's kernel
    # writes bf16 (the reference's): a sound CPU run reads tracks_differ
    # up to ~5 % on this ring, and a broken stage far more.
    job.update(config="tiny_ring12", traffic="seq", mvs_scale=1.0,
               limits={"tracks_differ": 0.15, "ba_points_moved": 0.01,
                       "ba_rms_gap": 0.01, "dense_differ": 0.03})
    with open(os.path.join(bench, "workloads", f"{TINY_CELL}.json"), "x") as f:
        json.dump(job, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_ring12", "source": "test only",
                            "file": "benchmark/configs/tiny_ring12.json",
                            "reduced": [], "why": "test only"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny_ring12",
                              "traffic": "seq", "chips": 1,
                              "why": "test only"})
    with open(path, "w") as f:
        json.dump(spec, f)


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark beside links to the program and its native
    sources (the program builds into the copy's ``build/``)."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("sfm_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    return root


@pytest.fixture
def tiny_checkout(checkout):
    add_tiny_cell(checkout)
    return checkout


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
