"""The port's mesh across processes (``GroupMesh``) on the CPU.

Each group is 2 or 4 rank processes over gloo on 127.0.0.1, started as
subprocesses of this interpreter running ``RANK_PROGRAM``, which imports
only ``sfm_tpu_torch`` (never this module, which imports jax).  Inputs and
outputs pass through ``.npz`` files.  The process group's timeout is
``parallel.distributed.GROUP_TIMEOUT`` (60 s), and ``run_ranks`` kills the
ranks and fails the test past its own timeout, so a rank that dies or
diverges fails the test instead of hanging it.

Every result across processes is held to the single-controller mesh of as
many shards, ``DataMesh([cpu] * shards)``, bit for bit: each shard's work
is the same, and ``psum`` adds in the same order.  Both sides run with 2
intra-op threads (CPU reductions' bits depend on the count).  Against
``sfm_tpu`` (its mesh of 8 simulated devices, tests/conftest.py) the
bounds are those of tests/test_torch_sharded.py.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba.sharded import solve_lm_sharded as j_solve_lm_sharded
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.features.frontend import detect_and_describe as j_describe
from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu.parallel import data_mesh as j_data_mesh
from sfm_tpu.parallel.distributed import initialize_multihost as j_init
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from test_ba import synthetic_problem

import sfm_tpu_torch.config as tconfig
from sfm_tpu_torch.ba import BAProblem, bundle_adjust
from sfm_tpu_torch.ba.sharded import solve_lm_sharded
from sfm_tpu_torch.config import BaConfig, MvsConfig
from sfm_tpu_torch.io import Calibration
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.parallel import DataMesh
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FIELDS = ("cams", "points", "cam_idx", "point_idx", "obs_2d", "mask")
BA_MODES = {"points": dict(optimize_cameras=False),
            "dense": dict(pair_span=1), "pcg": dict(pair_span=0)}
MVS_CFG = dict(round_capacity=2048, max_rounds=3)
CLOUD = ("points", "colors", "normals", "scores", "refs")

# The program of one rank: argv[1] is its spec (JSON).  It joins the gloo
# group, runs the task on ``data_mesh(devices=[cpu] * local)`` and writes
# the task's arrays, plus its initialize_multihost keys and whether jax
# was imported, to spec["out"].
RANK_PROGRAM = r'''
import json, sys
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, spec["root"])
import numpy as np
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from sfm_tpu_torch.parallel import data_mesh, distributed, mesh as mesh_mod
CPU = torch.device("cpu")


def as_numpy(t):
    t = t.detach().cpu()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def from_input(z, key):
    a = torch.from_numpy(z[key])
    return a.view(torch.bfloat16) if key.startswith("bf16") else a


def mesh_ops(z, mesh):
    out = {}
    for key in z.files:
        x = from_input(z, key)
        parts = mesh.split(x, fill=1)
        for j, p in enumerate(parts):
            out[f"{key}/split{j}"] = as_numpy(p)
        out[f"{key}/gather"] = as_numpy(mesh.gather(parts, x.shape[0]))
        out[f"{key}/psum"] = as_numpy(mesh.psum(parts))
        if x.dtype != torch.bool:
            out[f"{key}/psum0d"] = as_numpy(mesh.psum([p.sum() for p in parts]))
        reps = mesh.replicate(x)
        out[f"{key}/replicas"] = np.asarray(
            [len(reps), all(r is x for r in reps)])
    return out


def refusals(z, mesh):
    def refused(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    r = dist.get_rank()
    out = {"unequal": refused(lambda: data_mesh(devices=[CPU] * (r + 1))),
           "cut": refused(lambda: data_mesh(num_devices=1, devices=[CPU]))}
    real_backend, real_ident = dist.get_backend, mesh_mod.device_identity
    dist.get_backend = lambda *a: "nccl"
    mesh_mod.device_identity = lambda d: ("host", "GPU-the-same-uuid")
    try:
        out["nccl_one_gpu"] = refused(lambda: data_mesh(devices=[CPU]))
    finally:
        dist.get_backend, mesh_mod.device_identity = real_backend, real_ident
    out["uneven_parts"] = refused(
        lambda: mesh.gather([torch.zeros(r + 1, 3)], 4))
    # The group still answers after every refusal.
    out["after"] = mesh.gather([torch.full((1,), float(r))], 2).numpy()
    return {k: np.asarray(v) for k, v in out.items()}


def ba(z, mesh):
    from sfm_tpu_torch.ba import BAProblem
    from sfm_tpu_torch.ba.sharded import solve_lm_sharded

    fields = ("cams", "points", "cam_idx", "point_idx", "obs_2d", "mask")
    problem = BAProblem.from_numpy(*(z[f] for f in fields))
    out = {}
    for mode, kw in json.loads(str(z["modes"])).items():
        cams, pts, cost, it = solve_lm_sharded(problem, mesh, max_iterations=15, **kw)
        out.update({f"{mode}/cams": cams.numpy(), f"{mode}/points": pts.numpy(),
                    f"{mode}/cost": cost.numpy(), f"{mode}/iterations": np.asarray(it)})
    return out


def ring(z, mesh):
    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import (BaConfig, FeatureConfig, MvsConfig,
                                      PipelineConfig, RuntimeConfig)
    from sfm_tpu_torch.io import Calibration
    from sfm_tpu_torch.mvs import dense_reconstruction, pipeline
    from sfm_tpu_torch.sfm import structure_from_motion
    from sfm_tpu_torch.utils import checkpoint

    images = z["images"]
    calib = Calibration.from_numpy(z["K"], z["R"], z["t"], [str(n) for n in z["names"]])
    c = json.loads(str(z["config"]))
    cfg = PipelineConfig(features=FeatureConfig(**c["features"]),
                         runtime=RuntimeConfig(**c["runtime"]))
    out = {}
    seeded = structure_from_motion(images, calib, cfg, mesh=mesh)
    out["seeded/track_obs"], out["seeded/world"] = seeded.track_obs, seeded.world
    sparse = structure_from_motion(images, calib, cfg, mesh=mesh,
                                   ransac_samples=torch.from_numpy(z["draws"]))
    for f in ("track_offsets", "track_obs", "world"):
        out[f"sfm/{f}"] = getattr(sparse, f)
    recon, info = bundle_adjust(sparse, BaConfig(dtype="float64"), mesh=mesh)
    out["ba/world"] = recon.world
    out["ba/iterations"] = np.asarray(info["iterations"])
    out["ba/final_cost"] = np.asarray(info["final_cost"])
    mvs = MvsConfig(**json.loads(str(z["mvs"])))
    dense = dense_reconstruction(images, recon.calib, recon, mvs, mesh=mesh)
    for f in ("points", "colors", "normals", "scores", "refs"):
        out[f"mvs/{f}"] = getattr(dense, f)
    out["mvs/num_seeds"] = np.asarray(dense.num_seeds)

    # Checkpoints: the run killed after round 2, then resumed; every
    # write and removal of the state file counted in this process.
    writes = {"save": 0, "clear": 0}
    real = {"save": checkpoint.save_mvs_state, "clear": checkpoint.clear_mvs_state,
            "round": pipeline.expansion_round}

    def counted(kind):
        def fn(*a, **kw):
            writes[kind] += 1
            return real[kind](*a, **kw)
        return fn

    def killing_round(*a, **kw):
        killing_round.calls += 1
        if killing_round.calls > 2:
            raise KeyboardInterrupt("killed")
        return real["round"](*a, **kw)

    killing_round.calls = 0
    checkpoint.save_mvs_state = counted("save")
    checkpoint.clear_mvs_state = counted("clear")
    kw = dict(mesh=mesh, checkpoint_dir=spec["ckpt"], checkpoint_every=1)
    pipeline.expansion_round = killing_round
    try:
        dense_reconstruction(images, recon.calib, recon, mvs, **kw)
        raise AssertionError("the killed run ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        pipeline.expansion_round = real["round"]
    out["ckpt/saved_rounds"] = np.asarray(
        int(checkpoint.load_mvs_state(spec["ckpt"])["counters"][1]))
    resumed = dense_reconstruction(images, recon.calib, recon, mvs, **kw)
    for f in ("points", "colors", "normals", "scores", "refs"):
        out[f"resumed/{f}"] = getattr(resumed, f)
    out["ckpt/resumed_at"] = np.asarray(resumed.metrics.values["mvs_resumed_at_round"])
    out["ckpt/saves"] = np.asarray(writes["save"])
    out["ckpt/clears"] = np.asarray(writes["clear"])
    out["ckpt/left"] = np.asarray(checkpoint.load_mvs_state(spec["ckpt"]) is not None)
    return out


def cli(z, mesh):
    """The CLI in every rank, each told its own --out_dir: the mesh
    spans the group whatever --mesh_devices says."""
    import contextlib, io
    from sfm_tpu_torch.cli import main

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(spec["args"] + ["--out_dir", spec["out_dir"] + str(dist.get_rank())])
    summary = [ln for ln in text.getvalue().splitlines() if ln.startswith("{")][-1]
    return {"rc": np.asarray(rc), "summary": np.asarray(summary)}


info = distributed.initialize_multihost(
    spec["addr"], spec["world"], spec["rank"], backend="gloo")
mesh = data_mesh(devices=[CPU] * spec["local"])
with np.load(spec["inp"]) as z:
    out = globals()[spec["task"]](z, mesh)
out["info"] = np.asarray(json.dumps(info))
out["mesh"] = np.asarray([mesh.size, mesh.process_index, len(mesh.local_devices)])
out["jax_loaded"] = np.asarray("jax" in sys.modules)
np.savez(spec["out"], **out)
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, task, world, local, inputs, timeout=120, **extra):
    """Run ``task`` in ``world`` gloo rank processes of ``local`` CPU
    shards each; returns each rank's outputs (a dict), in rank order.
    Past ``timeout`` seconds every rank is killed and the test fails."""
    inp = tmp_path / f"{task}_in.npz"
    np.savez(inp, **inputs)
    addr = f"127.0.0.1:{free_port()}"
    procs, outs = [], []
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for r in range(world):
        spec = dict(root=ROOT, addr=addr, world=world, rank=r, local=local,
                    task=task, inp=str(inp),
                    out=str(tmp_path / f"{task}_out{r}.npz"), **extra)
        path = tmp_path / f"{task}_spec{r}.json"
        path.write_text(json.dumps(spec))
        outs.append(spec["out"])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, str(path)], cwd=str(tmp_path),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{task}: ranks still running after {timeout} s (killed)")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{task} rank {r} exited {p.returncode}:\n{log}"
    results = []
    for path in outs:
        with np.load(path) as z:
            results.append({k: z[k] for k in z.files})
    return results


def bf16_bits(t):
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


# --- (a), (b), (g): the mesh's moves, initialize_multihost, no jax ----------------

def mesh_inputs():
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((11, 3)).astype(np.float32)
    return {
        "f32": f32,
        "f64": rng.standard_normal((13, 2, 2)),
        "bf16": torch.from_numpy(f32 * 7).to(torch.bfloat16).view(torch.uint16).numpy(),
        "bool": rng.random((9, 4)) < 0.5,
        "int64": rng.integers(-2**40, 2**40, (8,)),
        "empty": np.zeros((0, 5), np.float32),
    }


def single_controller_ops(inputs, shards):
    """The moves of RANK_PROGRAM's ``mesh_ops`` on DataMesh([cpu] * shards)."""
    mesh = DataMesh([CPU] * shards)
    want = {}
    for key, a in inputs.items():
        x = torch.from_numpy(a)
        if key.startswith("bf16"):
            x = x.view(torch.bfloat16)
        parts = mesh.split(x, fill=1)
        want[key] = {"parts": [bf16_bits(p) for p in parts],
                     "gather": bf16_bits(mesh.gather(parts, x.shape[0])),
                     "psum": bf16_bits(mesh.psum(parts))}
        if x.dtype != torch.bool:
            want[key]["psum0d"] = bf16_bits(mesh.psum([p.sum() for p in parts]))
    return want


@pytest.fixture(scope="module", params=[(2, 1), (2, 2), (4, 1)],
                ids=["2x1", "2x2", "4x1"])
def mesh_run(request, tmp_path_factory):
    world, local = request.param
    inputs = mesh_inputs()
    got = run_ranks(tmp_path_factory.mktemp(f"mesh{world}x{local}"), "mesh_ops",
                    world, local, inputs)
    return world, local, inputs, got


def test_mesh_moves_bit_equal_to_single_controller(mesh_run):
    world, local, inputs, got = mesh_run
    want = single_controller_ops(inputs, world * local)
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["mesh"], [world * local, r, local])
        for key, w in want.items():
            for j in range(local):  # rank-major: rank r's shard j is r * local + j
                np.testing.assert_array_equal(out[f"{key}/split{j}"],
                                              w["parts"][r * local + j], err_msg=key)
            for op in ("gather", "psum", "psum0d"):
                if op in w:
                    assert out[f"{key}/{op}"].dtype == w[op].dtype
                    np.testing.assert_array_equal(out[f"{key}/{op}"], w[op],
                                                  err_msg=f"{key} {op}")
            # Local replicas only, and shards on one device share the tensor.
            np.testing.assert_array_equal(out[f"{key}/replicas"], [local, True])
    assert got[0]["empty/gather"].shape == (0, 5)
    assert got[0]["f32/gather"].shape == (11, 3)  # pad rows dropped


def test_initialize_multihost_in_processes(mesh_run):
    world, local, _, got = mesh_run
    want_keys = set(j_init())
    for r, out in enumerate(got):
        info = json.loads(str(out["info"]))
        assert set(info) == want_keys
        assert info == {"process_index": r, "process_count": world,
                        "local_devices": 1, "global_devices": world}


def test_ranks_import_no_jax(mesh_run):
    assert not any(bool(out["jax_loaded"]) for out in mesh_run[3])


# --- (c): the refusals -------------------------------------------------------------

def test_group_mesh_refusals(tmp_path):
    got = run_ranks(tmp_path, "refusals", 2, 1, {"unused": np.zeros(1)})
    for out in got:
        assert "disagree on their local shard counts [1, 2]" in str(out["unequal"])
        assert "cut processes out" in str(out["cut"])
        msg = str(out["nccl_one_gpu"])
        assert "two processes on one GPU" in msg and "gloo" in msg
        assert "differ between processes" in str(out["uneven_parts"])
        np.testing.assert_array_equal(out["after"], [0.0, 1.0])
        assert not bool(out["jax_loaded"])


def test_cli_in_processes_writes_once(tmp_path):
    """The CLI called in 2 processes of a group: both run every stage over
    the group's mesh, and only process 0 writes (PLY files, stage files)."""
    pytest.importorskip("PIL")
    ds = str(tmp_path / "ring")
    _, par, _ = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12)[:6], w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0,
    )
    ck = str(tmp_path / "ckpt")
    args = ["-img_p", ds, "-par_p", par, "-t", "png", "--max_corners", "512",
            "--max_matches", "256", "--mvs_round_capacity", "2048",
            "--mvs_rounds", "3", "--device", "cpu", "--checkpoint_dir", ck]
    got = run_ranks(tmp_path, "cli", 2, 1, {"unused": np.zeros(1)}, args=args,
                    out_dir=str(tmp_path / "out"))
    summaries = [json.loads(str(out["summary"])) for out in got]
    for out, s in zip(got, summaries):
        assert int(out["rc"]) == 0 and s["mvs_points"] > s["mvs_seeds"] > 0
    for k in ("sparse_tracks", "ba_final_cost", "mvs_seeds", "mvs_points"):
        assert summaries[0][k] == summaries[1][k], k
    assert sorted(os.listdir(tmp_path / "out0")) == [
        "all_patches.ply", "initial_patches.ply", "sparse_points.ply",
        "sparse_points_ba.ply"]
    assert not os.path.exists(tmp_path / "out1")
    assert sorted(os.listdir(ck)) == ["ba.npz", "sfm.npz"]


# --- (d): bundle adjustment over 2 processes x 2 shards ---------------------------

@pytest.fixture(scope="module")
def ba_run(tmp_path_factory):
    jp, _ = synthetic_problem(np.random.default_rng(1), n_cams=5, n_pts=100,
                              noise_3d=0.08, noise_px=0.3)
    arrays = {f: np.asarray(getattr(jp, f)) for f in FIELDS}
    got = run_ranks(tmp_path_factory.mktemp("ba"), "ba", 2, 2,
                    {**arrays, "modes": np.asarray(json.dumps(BA_MODES))})
    return jp, arrays, got


@pytest.mark.parametrize("mode", list(BA_MODES))
def test_solve_lm_across_processes(ba_run, mode):
    jp, arrays, got = ba_run
    kw = dict(max_iterations=15, **BA_MODES[mode])
    cams, pts, cost, it = solve_lm_sharded(BAProblem.from_numpy(
        *(arrays[f] for f in FIELDS)), DataMesh([CPU] * 4), **kw)
    for out in got:
        assert int(out[f"{mode}/iterations"]) == it >= 1
        np.testing.assert_array_equal(out[f"{mode}/cost"], cost.numpy())
        np.testing.assert_array_equal(out[f"{mode}/cams"], cams.numpy())
        np.testing.assert_array_equal(out[f"{mode}/points"], pts.numpy())
    jc, jpts, jcost, jit = j_solve_lm_sharded(jp, j_data_mesh(), **kw)
    out = got[0]
    assert int(out[f"{mode}/iterations"]) == int(jit)
    if mode == "points":
        np.testing.assert_allclose(float(out["points/cost"]), float(jcost), rtol=1e-9)
        np.testing.assert_allclose(out["points/points"], np.asarray(jpts),
                                   rtol=0, atol=1e-8)
        np.testing.assert_array_equal(out["points/cams"], arrays["cams"])
    else:
        np.testing.assert_allclose(float(out[f"{mode}/cost"]), float(jcost), rtol=1e-6)
        np.testing.assert_allclose(out[f"{mode}/points"], np.asarray(jpts),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(out[f"{mode}/cams"], np.asarray(jc),
                                   rtol=1e-6, atol=1e-5)


# --- (e), (f): SfM -> BA -> MVS, and a checkpointed MVS, in 2 processes ----------

def jax_draws(images, jcfg):
    """sfm_tpu's RANSAC hypotheses per pair, from its own matches (as
    tests/test_torch_sharded.py feeds them)."""
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
    return np.stack(draws)


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """The 12-frame 200x150 ring of tests/test_torch_sharded.py in 2
    processes x 2 shards, and the same stages on DataMesh([cpu] * 4)."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    cfg = tconfig.from_jax_config(jcfg, device="cpu")
    rank_cfg = {"features": {"max_corners": 512, "max_matches": 256},
                "runtime": {"device": "cpu"}}
    assert cfg == tconfig.PipelineConfig(  # what RANK_PROGRAM builds
        features=tconfig.FeatureConfig(**rank_cfg["features"]),
        runtime=tconfig.RuntimeConfig(**rank_cfg["runtime"]))
    draws = jax_draws(images, jcfg)
    tmp = tmp_path_factory.mktemp("ring")
    got = run_ranks(tmp, "ring", 2, 2, {
        "images": images, "K": cal.K, "R": cal.R, "t": cal.t,
        "names": np.asarray(cal.names), "draws": draws,
        "config": np.asarray(json.dumps(rank_cfg)),
        "mvs": np.asarray(json.dumps(MVS_CFG)),
    }, ckpt=str(tmp / "ckpt"))

    mesh4 = DataMesh([CPU] * 4)
    calib = Calibration.from_numpy(cal.K, cal.R, cal.t, cal.names)
    want = {"seeded": structure_from_motion(images, calib, cfg, mesh=mesh4),
            "sfm": structure_from_motion(images, calib, cfg, mesh=mesh4,
                                         ransac_samples=torch.from_numpy(draws))}
    sp = want["sfm"]
    want["ba"], want["ba_info"] = bundle_adjust(
        SparseReconstruction(calib=sp.calib, world=sp.world.copy(),
                             track_offsets=sp.track_offsets, track_obs=sp.track_obs),
        BaConfig(dtype="float64"), mesh=mesh4)
    want["mvs"] = dense_reconstruction(images, want["ba"].calib, want["ba"],
                                       MvsConfig(**MVS_CFG), mesh=mesh4)
    return images, cal, jcfg, got, want


def test_ring_stages_bit_equal_to_single_controller(ring_run):
    *_, got, want = ring_run
    sfm, ba, mvs = want["sfm"], want["ba"], want["mvs"]
    assert sfm.num_tracks > 50 and mvs.num_points > mvs.num_seeds > 50
    for out in got:
        np.testing.assert_array_equal(out["seeded/track_obs"], want["seeded"].track_obs)
        np.testing.assert_array_equal(out["seeded/world"], want["seeded"].world)
        for f in ("track_offsets", "track_obs", "world"):
            np.testing.assert_array_equal(out[f"sfm/{f}"], getattr(sfm, f), err_msg=f)
        np.testing.assert_array_equal(out["ba/world"], ba.world)
        assert int(out["ba/iterations"]) == want["ba_info"]["iterations"] >= 1
        assert float(out["ba/final_cost"]) == want["ba_info"]["final_cost"]
        assert int(out["mvs/num_seeds"]) == mvs.num_seeds
        for f in CLOUD:
            np.testing.assert_array_equal(out[f"mvs/{f}"], getattr(mvs, f), err_msg=f)


def test_ring_ranks_hold_one_result(ring_run):
    a, b = ring_run[3]
    # Everything but the ranks' own identities and file-write counts.
    keys = [k for k in a if k not in ("info", "mesh", "ckpt/saves", "ckpt/clears")]
    assert set(a) == set(b)
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not bool(a["jax_loaded"]) and not bool(b["jax_loaded"])


def test_ring_sfm_matches_jax_sharded_with_fed_draws(ring_run):
    images, cal, jcfg, got, _ = ring_run
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    want = j_sfm(images, jcal, jcfg, mesh=j_data_mesh())
    assert want.num_tracks > 50
    np.testing.assert_array_equal(got[0]["sfm/track_offsets"], want.track_offsets)
    np.testing.assert_array_equal(got[0]["sfm/track_obs"], want.track_obs)
    np.testing.assert_allclose(got[0]["sfm/world"], want.world, rtol=0, atol=1e-5)


def test_mvs_checkpoint_across_processes(ring_run):
    """Only process 0 writes (and clears) the state file; the run killed
    after round 2 and resumed in 2 processes gives the uninterrupted cloud
    bit for bit."""
    *_, got, want = ring_run
    for r, out in enumerate(got):
        assert int(out["ckpt/saved_rounds"]) == 2
        assert int(out["ckpt/resumed_at"]) == 2
        # Rounds 1 and 2 of the killed run, round 3 of the resumed one.
        assert int(out["ckpt/saves"]) == (3 if r == 0 else 0)
        assert int(out["ckpt/clears"]) == (1 if r == 0 else 0)
        assert not bool(out["ckpt/left"])
        for f in CLOUD:
            np.testing.assert_array_equal(out[f"resumed/{f}"], getattr(want["mvs"], f),
                                          err_msg=f)
