"""The benchmark's own CPU tests (the card's test carries the ``cuda``
marker).  Run from the repository's root:

    python -m pytest benchmark/checks -q
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import BENCH, REPO, TINY_CELL, add_tiny_cell

CELLS = ("dino_ring48.seq_scale10", "temple_sparse16.seq_scale1",
         "dino_ring48.allpairs_joint", "dino_ring48.sparse_only")


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in base:
                continue
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(fh.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_are_found_by_name(checkout):
    """A configuration, a cell and a per-layer metric added as new files
    (and listed in BENCHMARK.json) are found by name; no file of the
    benchmark is edited."""
    from benchkit.catalog import Catalog

    bench = os.path.join(checkout, "benchmark")
    before = _digests(bench)
    add_tiny_cell(checkout)
    with open(os.path.join(bench, "metrics", "passes_seen.py"), "x") as f:
        f.write('UNIT = "passes"\nLAYER = "test layer"\n'
                'MOVES = "frames_per_s"\n\n\ndef read(run):\n'
                '    return len(run.passes)\n')
    path = os.path.join(checkout, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "passes_seen", "unit": "passes", "better": "higher",
        "source": "host_clock", "layer": "test layer",
        "moves": "frames_per_s", "workloads": [TINY_CELL]})
    with open(path, "w") as f:
        json.dump(spec, f)
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/tiny_ring12.json", f"workloads/{TINY_CELL}.json",
        "metrics/passes_seen.py"}

    cat = Catalog(checkout)
    entry, job, config = cat.cell(TINY_CELL)
    assert entry["config"] == config["name"] == "tiny_ring12"
    assert job["traffic"] == "seq"
    names = [m["name"] for m in cat.metrics_for(TINY_CELL, trace=True)]
    assert "passes_seen" in names
    assert "passes_seen" not in [m["name"] for m in cat.metrics_for(
        CELLS[0], trace=True)]
    reader = cat.reader(next(m for m in cat.metrics_for(TINY_CELL, True)
                             if m["name"] == "passes_seen"))

    class Run:
        passes = [1, 2, 3]

    assert reader.read(Run) == 3


def test_every_listed_cell_config_and_metric_has_its_file():
    from benchkit.catalog import Catalog

    cat = Catalog(REPO)
    assert tuple(cat.cells) == CELLS
    for cell in CELLS:
        entry, job, config = cat.cell(cell)
        assert entry["chips"] == 1
        for trace in (False, True):
            for m in cat.metrics_for(cell, trace):
                assert callable(cat.reader(m).read)
        assert set(job["limits"]) <= {
            "tracks_differ", "ba_points_moved", "ba_rms_gap", "dense_differ"}
        assert ("dense_differ" in job["limits"]) == ("mvs" in job["stages"])
    assert {m["name"] for m in cat.spec["end_to_end"]} == {
        "frames_per_s", "recon_p90_s", "setup_s"}


def _imported_modules(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    prog = (f"import sys; sys.path[:0] = [{BENCH!r}, {REPO!r}]\n" + code
            + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=REPO)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_benchmark_never_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``sfm_tpu_torch`` begins with
    ``sfm_tpu`` and is allowed; ``sfm_tpu`` and jax are not."""
    mods = _imported_modules(
        "import run, control\n"
        "from benchkit import catalog, harness, judge, program, roofline, "
        "scene, trace\n"
        "from sfm_tpu_torch.ba import bundle_adjust\n"
        "from sfm_tpu_torch.mvs import dense_reconstruction\n"
        "from sfm_tpu_torch.sfm import structure_from_motion\n"
        "import sfmref\n"
        "cat = catalog.Catalog(run.ROOT)\n"
        "[cat.reader(m) for s in ('end_to_end', 'per_layer') "
        "for m in cat.spec[s]]\n")
    assert "sfm_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "sfm_tpu"}


def test_reference_imports_nothing_of_the_program():
    for name in sorted(os.listdir(os.path.join(BENCH, "sfmref"))):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "sfmref", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"sfm_tpu_torch", "sfm_tpu", "jax",
                                    "benchkit"}, (name, tops)
    mods = _imported_modules(
        "import numpy as np\n"
        "from benchkit import scene\n"
        "import torch\n"
        "import sfmref\n"
        "sc = dict(frames=6, width=160, height=120, focal_px=192.0,\n"
        "          rig_radius=3.0, rig_height=0.35,\n"
        "          spheres=[[[0, 0, 0], 1.0]], texture_strength=1.0)\n"
        "import json\n"
        f"conf = json.load(open({os.path.join(BENCH, 'configs', 'dino_ring48.json')!r}))\n"
        "conf['pipeline']['features']['max_corners'] = 256\n"
        "conf['pipeline']['mvs'].update(round_capacity=256, max_rounds=2)\n"
        "img, K, R, t = scene.render(sc, 3, 'cpu')\n"
        "job = dict(pair_mode='sequence', refine_cameras=False,\n"
        "           mvs_scale=1.0, stages=['sfm', 'ba', 'mvs'])\n"
        "u = torch.rand((5, 512 * 8), dtype=torch.float64)\n"
        "tr = sfmref.sparse_stage(img, K, R, t, conf['pipeline'], job, u,\n"
        "                         'cpu')\n"
        "sfmref.ba_stage(K, R, t, tr, conf['pipeline'], job, 'cpu')\n"
        "pts, _ = sfmref.mvs_stage(img, K, R, t, tr, conf['pipeline'], job,\n"
        "                          'cpu')\n"
        "assert tr['world'].shape[0] > 0 and pts.shape[0] > 0\n")
    assert "sfmref" in mods
    assert not mods & {"jax", "jaxlib", "flax", "sfm_tpu", "sfm_tpu_torch"}


def test_frozen_byte_counts_equal_the_programs_at_each_cells_shapes():
    from benchkit import roofline
    from benchkit.catalog import Catalog
    from sfm_tpu_torch.tools import measure

    cat = Catalog(REPO)
    for cell in CELLS:
        _, job, config = cat.cell(cell)
        sc, fc = config["scene"], config["pipeline"]["features"]
        px = sc["frames"] * sc["height"] * sc["width"]
        m = sc["frames"] * fc["max_corners"]
        assert roofline.harris_bound(px) == measure.harris_bound(px)
        assert roofline.gather_bound(px, m, fc["desc_wid"]) == \
            measure.gather_bound(px, m, fc["desc_wid"])
        for nbytes, flops in ((1e6, 1e3), (1e3, 1e12)):
            assert roofline.bound(nbytes, flops) == measure.bound(nbytes, flops)
    assert (roofline.PEAK_BYTES_S, roofline.PEAK_F32_S) == \
        (measure.PEAK_BYTES_S, measure.PEAK_F32_S)


@pytest.mark.parametrize("spheres", [[[[0, 0, 0], 1.0]],
                                     [[[0, 0, 0], 1.0], [[1.0, 0.1, 0.9], 0.55]]])
def test_scene_is_the_programs_synthetic_ring(spheres):
    """The frozen renderer gives the port's own synthetic ring, bit for
    bit, on the CPU."""
    from benchkit import scene
    from sfm_tpu_torch.utils import synth

    sc = dict(frames=6, width=160, height=120, focal_px=192.0,
              rig_radius=3.0, rig_height=0.35, spheres=spheres,
              texture_strength=1.0)
    img, K, R, t = scene.render(sc, 2**31 + 7, "cpu")
    img2, cal = synth.render_scene(
        synth.ring_rig(6), w=160, h=120,
        spheres=[tuple(map(tuple, [c])) + (r,) for c, r in spheres] and
        [(tuple(c), r) for c, r in spheres], seed=2**31 + 7)
    np.testing.assert_array_equal(img, img2)
    np.testing.assert_array_equal(R, cal.R)
    np.testing.assert_array_equal(t, cal.t)
    np.testing.assert_array_equal(K, cal.K)


def _run(root, monkeypatch=None, seconds=2.0, trace=False):
    from benchkit.harness import run_cell

    return run_cell(root, TINY_CELL, 2**31 + 11, seconds, trace, "cpu",
                    time.perf_counter(), log=lambda s: None)


def test_tiny_cpu_run_prints_the_contracts_line_and_hands_each_pass_a_new_array(
        tiny_checkout, monkeypatch):
    from benchkit import program

    seen = []
    real = program.run_pass

    def spy(images, *args, **kw):
        seen.append(images)  # kept alive: no address can be reused
        return real(images, *args, **kw)

    monkeypatch.setattr(program, "run_pass", spy)
    result = _run(tiny_checkout)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.loads(json.dumps(result))
    # First reconstruction + warm-up passes + the window's passes.
    assert len(seen) == 1 + 3 + result["attempted"]
    assert len({a.ctypes.data for a in seen}) == len(seen)
    assert len({id(a) for a in seen}) == len(seen)


def _fault_ba_unchanged(monkeypatch):
    import sfm_tpu_torch.ba as ba

    real = ba.bundle_adjust

    def ba_unchanged(recon, *a, **kw):
        start = recon.world.copy()
        recon, info = real(recon, *a, **kw)
        recon.world = start
        return recon, info

    monkeypatch.setattr(ba, "bundle_adjust", ba_unchanged)


def _fault_half_the_cloud(monkeypatch):
    import sfm_tpu_torch.mvs as mvs

    real = mvs.dense_reconstruction

    def half(*a, **kw):
        dense = real(*a, **kw)
        keep = dense.points.shape[0] // 2
        dense.points, dense.normals = dense.points[:keep], dense.normals[:keep]
        return dense

    monkeypatch.setattr(mvs, "dense_reconstruction", half)


def _fault_points_altered(monkeypatch):
    import sfm_tpu_torch.sfm as sfm

    real = sfm.structure_from_motion

    def altered(*a, **kw):
        recon = real(*a, **kw)
        recon.world = recon.world + np.array([1e-3, 0.0, 0.0])
        return recon

    monkeypatch.setattr(sfm, "structure_from_motion", altered)


def _fault_half_the_pairs(monkeypatch):
    import sfm_tpu_torch.sfm as sfm

    real = sfm.structure_from_motion

    def half(images, calib, config, *a, **kw):
        n = images.shape[0] // 2 + 1
        recon = real(images[:n], calib.subset(range(n)), config, *a, **kw)
        recon.calib = calib
        return recon

    monkeypatch.setattr(sfm, "structure_from_motion", half)


@pytest.mark.parametrize("fault", [_fault_ba_unchanged, _fault_half_the_cloud,
                                   _fault_points_altered,
                                   _fault_half_the_pairs])
def test_a_broken_timed_path_reads_not_correct(tiny_checkout, monkeypatch,
                                               fault):
    fault(monkeypatch)
    result = _run(tiny_checkout, seconds=1.0)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_run_without_a_card_or_without_the_program_prints_no_result(
        checkout, tmp_path):
    """Without CUDA (this machine) the command exits non-zero and prints
    no JSON line; so it does in a directory that holds only
    BENCHMARK.json and the benchmark."""
    bare = tmp_path / "bare"
    bare.mkdir()
    import shutil

    shutil.copy(os.path.join(checkout, "BENCHMARK.json"), bare)
    shutil.copytree(os.path.join(checkout, "benchmark"), bare / "benchmark")
    for root in (checkout, str(bare)):
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
             "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True)
        assert proc.returncode != 0
        assert not any(line.startswith("{") for line in
                       proc.stdout.splitlines())


def _control_correct(root, device, seeds=(1, 2, 3)):
    """``correct`` of the control (the reference one step below each
    stated precision, in the program's place) on the tiny ring, under the
    first cell's limits, seed by seed."""
    from benchkit import judge, scene
    from benchkit.catalog import Catalog
    from benchkit.harness import judge_passes, n_pairs, ransac_uniforms
    from sfmref import sparse_stage

    cat = Catalog(root)
    limits = cat.cell(CELLS[0])[1]["limits"]
    _, job, config = cat.cell(TINY_CELL)
    pipe = config["pipeline"]
    out = []
    for seed in seeds:
        images, K, R, t = scene.render(config["scene"], seed, device)
        u = ransac_uniforms(n_pairs(12, "sequence"), 512, seed)
        ctl = sparse_stage(images, K, R, t, pipe, job, u, device,
                           control=True)
        ctl.update(judge.reference_next(images, (K, R, t), ctl, pipe, job,
                                        device, control=True))
        numbers = judge_passes([ctl], images, (K, R, t), pipe, job, u, device)
        out.append(judge.verdict(numbers, limits)[0])
    return out


def test_control_reads_not_correct(tiny_checkout):
    """The control fails the first cell's limits on a small ring (on the
    CPU TF32 changes nothing; float8 descriptors and bfloat16 BA do)."""
    assert _control_correct(tiny_checkout, "cpu") == [False] * 3


@pytest.mark.cuda
def test_control_reads_not_correct_on_the_card(tiny_checkout, cuda_device):
    assert _control_correct(tiny_checkout, cuda_device) == [False] * 3
