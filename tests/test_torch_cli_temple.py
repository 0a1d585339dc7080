"""The port's twin of tests/test_cli.py::test_run_temple_invocation_end_to_end:
a templeSparseRing-style dataset (two occluding textured spheres, 16 frames)
rendered to disk in the Middlebury layout and driven through the port's CLI
with run_temple.sh's flag shape (``-img_p DIR -par_p DIR/templeSR_par.txt
-t ppm -scale 1``), at 320x240 to keep the CPU run short.  The dense cloud
is held to the spheres' closed-form surface.
"""

import os

import numpy as np
import pytest
import torch

from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.io import read_pars, read_ply
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)


def test_run_temple_invocation_end_to_end(tmp_path):
    pytest.importorskip("PIL")
    ds = str(tmp_path / "templeSparseRing")
    _, par_path, spheres = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(16), w=320, h=240
    )
    assert read_pars(par_path).num_views == 16
    out = str(tmp_path / "out_temple")
    rc = t_main([
        "-img_p", ds, "-par_p", par_path, "-t", "ppm", "-scale", "1",
        "--max_corners", "1024", "--max_matches", "512",
        "--mvs_round_capacity", "4096", "--mvs_rounds", "8",
        "--out_dir", out, "--device", "cpu",
    ])
    assert rc == 0
    pts_sparse, _ = read_ply(os.path.join(out, "sparse_points_ba.ply"))
    pts_dense, cols = read_ply(os.path.join(out, "all_patches.ply"))
    assert pts_sparse.shape[0] > 200
    assert pts_dense.shape[0] > 5 * pts_sparse.shape[0]
    assert cols is not None and cols.shape == pts_dense.shape
    d = synth.surface_distance(pts_dense, spheres)
    assert np.percentile(d, 95) < 0.05
