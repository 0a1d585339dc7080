"""The port's tile-resident sampler (K3) against the TPU tool, on the CPU.

``tools/prof_tile.py:make_gather_kernel`` runs unedited in the Pallas TPU
interpreter (``pltpu.force_tpu_interpret_mode``); the port's wrapper takes
its plain versions on CPU tensors.  Inputs come from the tool's own
``build_case`` (numpy, seeded), which the port's must equal.

Tolerances: the full modes within 2e-2 of the tool's kernel and of its
reference path ``normalize_descriptors(bilinear_sample_patches_stack)``
(the tool's own ``check`` bound: bf16 patch plus bf16 descriptor rounding);
the copy-only mode is held bit for bit to the raw window (the TPU kernel's
copy-only output is the slab's corner, not the window, so it is compared
after shifting by the tool's ``dy`` / ``x_al`` + ``x_rem``).
"""

import importlib.util
import json
import os

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfm_tpu.ops.ncc import bilinear_sample_patches_stack as j_bilinear
from sfm_tpu.ops.patches import normalize_descriptors as j_normalize

from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
from sfm_tpu_torch.ops.gather_tile import (
    _copy_plain,
    sample_normalized_patches_tiled,
)
from sfm_tpu_torch.tools import prof_tile as t_tool

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-2
CASE = dict(n_img=3, h=64, w=256, wid=5)
M = 96


@contextlib.contextmanager
def tpu_interpreter():
    """The Pallas TPU interpreter, in 32-bit mode: the tool was written for
    the TPU's default (its ``lax.rem(program_id, 2)`` mixes int32 with a
    Python int), while tests/conftest.py turns x64 on."""
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def j_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prof_tile", os.path.join(ROOT, "tools", "prof_tile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case(j_tool):
    gray, img_idx, ctr, flat = j_tool.build_case(M, **CASE)
    t = (torch.from_numpy(gray).to(torch.bfloat16),
         torch.from_numpy(np.array(img_idx)),
         torch.from_numpy(np.array(ctr)))
    return gray, img_idx, ctr, flat, t


def test_build_case_equals_the_tools(j_tool):
    for kw in (CASE, dict(n_img=2, h=40, w=256, wid=3, seed=7)):
        gray, img_idx, ctr, flat = j_tool.build_case(50, **kw)
        g, i, c = t_tool.build_case(50, **kw)
        np.testing.assert_array_equal(g, gray)
        np.testing.assert_array_equal(i, np.asarray(img_idx))
        np.testing.assert_array_equal(c, np.asarray(ctr))
        # The bf16 stack: the same rounding in both frameworks.
        tg, ti, tc = t_tool.case_tensors(50, torch.device("cpu"), **kw)
        rows = kw["n_img"] * kw["h"]
        np.testing.assert_array_equal(
            tg.float().numpy().reshape(rows, -1),
            np.asarray(flat, np.float32)[:rows])
        assert ti.dtype == torch.int32 and tc.dtype == torch.float32


@pytest.mark.parametrize("S,double", [(8, True), (8, False), (32, True)])
def test_full_modes_match_the_pallas_kernel(j_tool, case, S, double):
    gray, img_idx, ctr, flat, (tg, ti, tc) = case
    h, w, wid = CASE["h"], CASE["w"], CASE["wid"]
    ints, flts, n_steps = j_tool.gather_params(img_idx, ctr, h, w, wid, S)
    with tpu_interpreter():
        kern = j_tool.make_gather_kernel(n_steps, S, w, wid, True, double)
        want = np.asarray(kern(ints, ints, flts, flat), np.float32)[:M]
    got = sample_normalized_patches_tiled(
        tg, ti, tc, wid, samples_per_block=S, double_buffer=double)
    assert got.dtype == torch.bfloat16 and got.shape == (M, 121)
    np.testing.assert_allclose(got.float().numpy(), want.reshape(M, 121),
                               atol=ATOL, rtol=0)


def test_full_mode_matches_the_tools_reference_path(case):
    gray, img_idx, ctr, _, (tg, ti, tc) = case
    patches, _ = j_bilinear(jnp.asarray(gray, jnp.bfloat16), img_idx, ctr, 5)
    want = np.asarray(j_normalize(patches))
    got = sample_normalized_patches_tiled(tg, ti, tc, 5)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL, rtol=0)
    # K3 shares K2's arithmetic: on the CPU both take the same plain version.
    k2, _ = sample_normalized_patches(tg, ti, tc, 5)
    assert torch.equal(got, k2)


def test_copy_only_is_the_raw_window(j_tool, case):
    gray, img_idx, ctr, flat, (tg, ti, tc) = case
    h, w, wid, S = CASE["h"], CASE["w"], CASE["wid"], 8
    got = sample_normalized_patches_tiled(tg, ti, tc, wid,
                                          samples_per_block=S, extract=False)
    assert got.dtype == torch.bfloat16 and got.shape == (M, 121)
    # The window by the tool's own parameters: rows row8 + dy, columns
    # x_al + x_rem of the flattened stack.
    ints, _, n_steps = j_tool.gather_params(img_idx, ctr, h, w, wid, S)
    bi = -(-S * 8 // 1024) * 1024
    p = np.asarray(ints).reshape(n_steps, bi)[:, : S * 8].reshape(-1, 8)[:M]
    fl = np.asarray(flat, np.float32)
    want = np.stack([
        fl[r8 + dy: r8 + dy + 11, xa + xr: xa + xr + 11].reshape(-1)
        for r8, dy, xa, xr in p[:, :4]
    ])
    np.testing.assert_array_equal(got.float().numpy(), want)
    # The TPU kernel's copy-only experiment runs (its output is the slab's
    # corner: equal to the window exactly where dy = x_al + x_rem = 0).
    with tpu_interpreter():
        kern = j_tool.make_gather_kernel(n_steps, S, w, wid, False, True)
        slab = np.asarray(kern(ints, ints, jnp.zeros(n_steps * 1024), flat),
                          np.float32)[:M].reshape(M, 121)
    corner = (p[:, 1] == 0) & (p[:, 2] + p[:, 3] == 0)
    np.testing.assert_array_equal(slab[corner], want[corner])


def test_copy_plain_clamps_like_the_kernels():
    g = torch.arange(2 * 20 * 30, dtype=torch.float32).reshape(2, 20, 30)
    g = (g % 251).to(torch.bfloat16)
    inf, nan = float("inf"), float("nan")
    ctr = torch.tensor([[-50.0, 3.0], [1e10, 7.5], [nan, nan], [inf, -inf],
                        [29.9, 19.9], [6.0, 6.0]])
    img = torch.tensor([0, 1, 1, 0, 5, -3], dtype=torch.int32)
    got = _copy_plain(g, img, ctr, 5).float().reshape(-1, 11, 11)
    origins = [(0, 0, 0), (1, 18, 2), (1, 0, 0), (0, 18, 0), (1, 18, 8),
               (0, 1, 1)]
    for row, (i, bx, by) in zip(got, origins):
        assert torch.equal(row, g[i, by:by + 11, bx:bx + 11].float())
    # The full plain version reads the same windows (finite output).
    assert torch.isfinite(_sample_plain(g, img, ctr, 5).float()[[0, 1, 4, 5]]).all()


def test_wrapper_checks_its_inputs(case):
    *_, (tg, ti, tc) = case
    with pytest.raises(TypeError):
        sample_normalized_patches_tiled(tg.float(), ti, tc)
    with pytest.raises(TypeError):
        sample_normalized_patches_tiled(tg, ti.long(), tc)
    with pytest.raises(ValueError):
        sample_normalized_patches_tiled(tg, ti, tc[:-1])
    with pytest.raises(ValueError):
        sample_normalized_patches_tiled(tg, ti, tc, samples_per_block=0)
    with pytest.raises(ValueError):
        sample_normalized_patches_tiled(tg, ti, tc, wid=9)
    assert sample_normalized_patches_tiled(tg, ti[:0], tc[:0]).shape == (0, 121)
    before = sample_normalized_patches_tiled.launches
    sample_normalized_patches_tiled(tg, ti, tc)
    assert sample_normalized_patches_tiled.launches == before  # CPU: no launch


def test_tool_cli_on_the_cpu(capsys):
    assert t_tool.main(["--device", "cpu", "--m", "256", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "plain versions only" in out
    rows = [json.loads(line.split(": ", 1)[1]) for line in out.splitlines()
            if line.startswith("E")]
    assert [r["mode"] for r in rows] == ["plain", "plain-copy"]
    for r in rows:
        assert r["device"] == "cpu" and r["m"] == 256
        assert {"time_s", "us_per_sample", "gb_per_s", "S"} <= set(r)
    assert t_tool.main(["--device", "cpu", "--check"]) == 0
    assert "CHECK OK" in capsys.readouterr().out
    # The sweep's rows on a GPU, in the TPU tool's order.
    assert [(m, S) for _, m, S, _ in t_tool.modes()] == [
        ("copy", 8), ("copy", 32), ("copy", 128), ("single", 8), ("double", 8),
        ("single", 32), ("double", 32), ("single", 128), ("double", 128)]


def test_tool_check_reports_a_mismatch(monkeypatch, capsys):
    real = t_tool.sample_normalized_patches_tiled

    def off_by_one_column(gray, img, ctr, wid, **kw):
        return real(gray, img, ctr + torch.tensor([1.0, 0.0]), wid, **kw)

    monkeypatch.setattr(t_tool, "sample_normalized_patches_tiled",
                        off_by_one_column)
    assert t_tool.main(["--device", "cpu", "--check"]) == 1
    assert "CHECK FAILED" in capsys.readouterr().out
