"""The port's small public functions that the debug figures and the JAX
package's API need, against sfm_tpu's on the CPU, and the three CLI flags
that write figures and traces (``--debug``, ``--plot``, ``--profile_dir``).

Tolerances: masks and indices exact; floats to 1e-6 relative (the same f32
expressions in both frameworks).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.features.matching import match_pair_gate as j_match_pair_gate
from sfm_tpu.features.matching import matched_points as j_matched_points
from sfm_tpu.geometry.epipolar import epipolar_lines as j_epipolar_lines
from sfm_tpu.geometry.epipolar import (
    essential_from_fundamental as j_essential_from_fundamental,
)
from sfm_tpu.ops.ncc import bilinear_sample_patches as j_bilinear_sample_patches

from sfm_tpu_torch.cli import TRACE_FILE
from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.features.matching import (
    MatchResult,
    match_descriptors,
    match_pair_gate,
    matched_points,
)
from sfm_tpu_torch.geometry.epipolar import (
    epipolar_lines,
    essential_from_fundamental,
)
from sfm_tpu_torch.ops.ncc import bilinear_sample_patches
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

RTOL = 1e-6


def f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("which", [1, 2])
def test_epipolar_lines_match_jax(which):
    rng = np.random.default_rng(which)
    F = f32(rng, 4, 3, 3)
    pts = (rng.uniform(0, 640, (4, 50, 2))).astype(np.float32)
    want = np.asarray(j_epipolar_lines(jnp.asarray(F), jnp.asarray(pts), which))
    got = epipolar_lines(torch.from_numpy(F), torch.from_numpy(pts), which).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(np.hypot(got[..., 0], got[..., 1]), 1.0, rtol=1e-6)


def test_essential_from_fundamental_matches_jax():
    rng = np.random.default_rng(3)
    F, K1, K2 = f32(rng, 5, 3, 3), f32(rng, 5, 3, 3), f32(rng, 5, 3, 3)
    want = np.asarray(j_essential_from_fundamental(
        jnp.asarray(F), jnp.asarray(K1), jnp.asarray(K2)))
    got = essential_from_fundamental(*map(torch.from_numpy, (F, K1, K2))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def unit_rows(rng, n, d=121):
    x = f32(rng, n, d)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_matched_points_and_gate_match_jax():
    """One pair against sfm_tpu's single-pair functions, and the port's
    batched form (a leading pair axis) row for row."""
    rng = np.random.default_rng(4)
    pairs = []
    for n_shared in (40, 3):   # a pair past the 8-match gate, one short of it
        d1 = unit_rows(rng, 200)
        d2 = unit_rows(rng, 200)
        d2[:n_shared] = d1[:n_shared] + 0.01 * f32(rng, n_shared, 121)
        c1 = rng.integers(0, 640, (200, 2)).astype(np.int32)
        c2 = rng.integers(0, 640, (200, 2)).astype(np.int32)
        pairs.append((d1, d2, c1, c2))
    valid = np.ones(200, bool)
    got_b = match_descriptors(*(torch.from_numpy(np.stack(x)) for x in (
        [p[0] for p in pairs], [valid] * 2, [p[1] for p in pairs], [valid] * 2)),
        max_matches=64)
    p1_b, p2_b = matched_points(torch.from_numpy(np.stack([p[2] for p in pairs])),
                                torch.from_numpy(np.stack([p[3] for p in pairs])),
                                got_b)
    gate_b = match_pair_gate(got_b)
    for i, (d1, d2, c1, c2) in enumerate(pairs):
        jm = j_match(jnp.asarray(d1), jnp.asarray(valid), jnp.asarray(d2),
                     jnp.asarray(valid), max_matches=64)
        tm = MatchResult(*(torch.from_numpy(np.array(x)) for x in
                           (jm.idx1, jm.idx2, jm.valid, jm.count)))
        jp1, jp2 = j_matched_points(jnp.asarray(c1), jnp.asarray(c2), jm)
        tp1, tp2 = matched_points(torch.from_numpy(c1), torch.from_numpy(c2), tm)
        assert tp1.dtype == torch.float32
        np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
        for n in (8, 3):
            assert bool(match_pair_gate(tm, n)) == bool(j_match_pair_gate(jm, n))
        np.testing.assert_array_equal(p1_b[i].numpy(), np.asarray(jp1))
        np.testing.assert_array_equal(p2_b[i].numpy(), np.asarray(jp2))
        assert bool(gate_b[i]) == bool(j_match_pair_gate(jm))
    assert gate_b.tolist() == [True, False]


@pytest.mark.parametrize("wid", [2, 5])
def test_bilinear_sample_patches_matches_jax(wid):
    """The single-image sampler at fractional centres, inside, on and past
    the in-bounds limits (the window clipped inside the image)."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    gray = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ctr = np.concatenate([
        rng.uniform(-3, [w + 3, h + 3], (300, 2)),
        [[wid + 1.0, 20.0], [w - wid - 2.0, 20.0], [30.0, wid + 1.0],
         [30.0, h - wid - 2.0], [wid + 0.999, 20.0]],
    ]).astype(np.float32)
    jp, jin = j_bilinear_sample_patches(jnp.asarray(gray), jnp.asarray(ctr), wid)
    tp, tin = bilinear_sample_patches(torch.from_numpy(gray), torch.from_numpy(ctr), wid)
    assert tp.shape == (ctr.shape[0], (2 * wid + 1) ** 2) and tp.dtype == torch.float32
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=1e-4)
    assert tin.numpy()[-5:].tolist() == [True, True, True, True, False]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pytest.importorskip("PIL")
    ds = str(tmp_path_factory.mktemp("ring") / "ring")
    _, par, _ = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12)[:6], w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0,
    )
    return ["-img_p", ds, "-par_p", par, "-t", "png", "--max_corners", "512",
            "--max_matches", "256", "--mvs_round_capacity", "2048",
            "--mvs_rounds", "2", "--device", "cpu"]


def test_cli_plot_and_debug_write_figures(dataset, tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "out")
    assert t_main(dataset + ["--out_dir", out, "--plot", "--debug"]) == 0
    files = set(os.listdir(out))
    assert {"sparse_before_ba.png", "sparse_after_ba.png", "dense.png"} <= files
    debug = sorted(f for f in files if f.startswith("debug_epipolar_"))
    assert debug == ["debug_epipolar_0_1.png", "debug_epipolar_1_2.png",
                     "debug_epipolar_2_3.png"]
    for f in debug + ["dense.png"]:
        with open(os.path.join(out, f), "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_profile_dir_writes_a_trace(dataset, tmp_path, capsys):
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    assert t_main(dataset + ["--out_dir", out, "--stages", "sfm",
                             "--profile_dir", prof]) == 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    with open(os.path.join(prof, TRACE_FILE)) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 100
    assert any(n.startswith("aten::") for n in names)
    # The CLI's and the reconstruction's spans are host ranges of the trace.
    assert {"sfm", "features", "features.gray", "pair_geometry",
            "pair_geometry.draw", "tracks"} <= names
    assert os.path.exists(os.path.join(out, "sparse_points.ply"))


def test_cli_figures_without_matplotlib_exit_1(dataset, tmp_path, capsys,
                                               monkeypatch):
    """Where matplotlib is missing, --plot and --debug exit 1 with a
    message naming it, before any stage runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    for flag in ("--plot", "--debug"):
        out = str(tmp_path / flag.strip("-"))
        assert t_main(dataset + ["--out_dir", out, flag]) == 1
        err = capsys.readouterr().err
        assert "matplotlib" in err and "Traceback" not in err
        assert not os.path.exists(os.path.join(out, "sparse_points.ply"))
