"""What only a CUDA device shows of the port's stages, on a rendered
12-frame 200x150 ring (the CPU tests' shape; its MVS grows to ~2,500
points in ~30 rounds and stops on a dry round):

- an expansion round, a chunk of two rounds, and a backlog split, round,
  merge and round make no synchronizing CUDA call under
  ``torch.cuda.set_sync_debug_mode("error")``, each payload equal to the
  same call's outside that mode;
- the kernels' launches over the stages: K4, K1 and K2 once each in SfM,
  no image kernel in BA, and in MVS one K2 sweep for the seeds plus one a
  round enqueued by the dispatch-ahead rule (``mvs_rounds.enqueued_rounds``),
  each through K2s's launch step;
- SfM, BA and MVS on 4 virtual shards of cuda:0 against the unsharded run,
  with K1, K2 and K2s launched once per shard and sweep;
- a one-process NCCL group whose mesh moves each dtype and runs BA as the
  single-controller mesh does, two NCCL processes on one GPU refused by
  ``data_mesh()``, and two gloo processes on one GPU (or one NCCL process
  a GPU, where there are two or more) running the stages as the
  single-controller mesh of the same devices does.  The groups run in
  processes of their own that import only ``sfm_tpu_torch``;
- MVS's outlier filter: one K2 sweep, and the keep mask of the host
  oracle; all-pairs SfM in 1 and in 10 pair chunks, one K1 and one K2
  launch each, the same tracks; on the 48-frame 640x480 ring its peak
  memory within the chunk budget; and the CLI's ``--profile_dir`` trace
  naming both kernels.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
False.  On the card (tests/conftest.py imports jax, which the card's
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_paths_cuda.py -q
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvs_rounds import enqueued_rounds

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = 4
BACKLOG_CAP = 32        # under half the ring's ~116 seeds: a backlog stays
GROUP_TIMEOUT_S = 300

# One process of a torch.distributed group: argv is mode, address, world
# size, rank and the repository root.  It builds ``data_mesh()``, in mode
# "nccl_two" on cuda:0 whatever the GPUs, which it must refuse.  Mode
# "nccl_one" holds a one-process NCCL group's moves and points-only BA to
# the single-controller mesh of cuda:0; modes "gloo_stages" and
# "nccl_stages" run SfM, BA and MVS over the group, one shard a process on
# cuda:(rank % GPUs), and print a digest of the outputs and the launches,
# and rank 0 prints its outputs beside the single-controller mesh of the
# same devices.
GROUP_PROGRAM = r'''
import hashlib, json, sys
mode, addr, world, rank, root = sys.argv[1:6]
world, rank = int(world), int(rank)
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist
from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import BaConfig, MvsConfig, PipelineConfig, RuntimeConfig
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.ops.gather import sample_normalized_patches
from sfm_tpu_torch.ops.harris import harris_response
from sfm_tpu_torch.parallel import DataMesh, data_mesh
from sfm_tpu_torch.parallel.distributed import GROUP_TIMEOUT
from sfm_tpu_torch.parallel.mesh import GroupMesh
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils import synth

dist.init_process_group("gloo" if mode.startswith("gloo") else "nccl",
                        init_method=f"tcp://{addr}", world_size=world, rank=rank,
                        timeout=GROUP_TIMEOUT)
dev = torch.device("cuda", 0)
mesh = data_mesh(devices=[dev]) if mode == "nccl_two" else data_mesh()
images, calib = synth.render_scene(synth.ring_rig(12), w=200, h=150, seed=0)
cfg = PipelineConfig(runtime=RuntimeConfig(device="cuda", kernels=True))


def copy(r):
    return SparseReconstruction(calib=r.calib, world=r.world.copy(),
                                track_offsets=r.track_offsets, track_obs=r.track_obs)


if mode == "nccl_one":
    single = DataMesh([dev])
    assert isinstance(mesh, GroupMesh) and mesh.backend == "nccl" and mesh.size == 1, mesh
    g = torch.Generator(device=dev).manual_seed(0)
    m = 4096
    moved = {
        "bf16": torch.randn((m, 5, 121), generator=g, device=dev).to(torch.bfloat16),
        "bool": torch.rand((m, 5), generator=g, device=dev) < 0.5,
        "f32": torch.randn((m, 5, 2), generator=g, device=dev),
        "f64": torch.randn((m, 3), generator=g, device=dev, dtype=torch.float64),
        "int64": torch.randint(0, 2**40, (m,), generator=g, device=dev),
    }
    for name, x in moved.items():
        for op in ("gather", "psum"):
            got, want = ((mm.gather(mm.split(x), m) if op == "gather"
                          else mm.psum(mm.split(x))) for mm in (mesh, single))
            assert got.dtype == want.dtype and torch.equal(got, want), (name, op)
    sparse = structure_from_motion(images, calib, cfg)
    out = []
    for mm in (mesh, single):
        r, info = bundle_adjust(copy(sparse), BaConfig(dtype="float32"), mesh=mm,
                                device="cuda")
        out.append((r.world, info["iterations"], info["final_cost"]))
    (w1, i1, c1), (w0, i0, c0) = out
    assert i1 == i0 >= 1 and c1 == c0 and np.array_equal(w1, w0), (i1, i0, c1, c0)
    print(f"NCCL ONE-PROCESS GROUP EQUAL: {len(moved)} dtypes moved, BA {i1} iterations")
elif mode.endswith("_stages"):
    def stages(mm):
        harris_response.launches = sample_normalized_patches.launches = 0
        sparse = structure_from_motion(images, calib, cfg, mesh=mm)
        sfm_launches = [harris_response.launches, sample_normalized_patches.launches]
        ba, info = bundle_adjust(copy(sparse), BaConfig(dtype="float32"), mesh=mm,
                                 device="cuda")
        sample_normalized_patches.launches = 0
        dense = dense_reconstruction(images, calib, ba, MvsConfig(), mesh=mm,
                                     device="cuda")
        torch.cuda.synchronize()
        out = {"sfm/track_offsets": sparse.track_offsets, "sfm/track_obs": sparse.track_obs,
               "sfm/world": sparse.world, "ba/world": ba.world,
               "ba/iterations": info["iterations"], "ba/rms": ba.rms_reprojection_error(),
               "mvs/num_seeds": dense.num_seeds,
               "mvs/num_points": dense.metrics.values["mvs_num_points"],
               "mvs/rounds": dense.metrics.values["mvs_rounds"]}
        for f in ("points", "colors", "normals", "scores", "refs"):
            out[f"mvs/{f}"] = getattr(dense, f)
        launches = {"sfm": sfm_launches, "mvs_k2": sample_normalized_patches.launches}
        return {k: np.asarray(v) for k, v in out.items()}, launches

    got, launches = stages(mesh)
    digest = hashlib.sha256(b"".join(got[k].tobytes() for k in sorted(got))).hexdigest()
    print("RANK " + json.dumps({"digest": digest, "launches": launches}))
    if rank == 0:
        gpus = torch.cuda.device_count()
        want, _ = stages(DataMesh([torch.device("cuda", r % gpus) for r in range(world)]))
        print("SINGLE " + json.dumps({
            "equal": {k: bool(np.array_equal(got[k], want[k])) for k in want},
            "got": {k: got[k].tolist() for k in got if got[k].size <= 2},
            "want": {k: want[k].tolist() for k in want if want[k].size <= 2}}))
dist.destroy_process_group()
assert "jax" not in sys.modules
'''


def run_group(mode, world):
    """``world`` processes of ``GROUP_PROGRAM`` on a fresh local port;
    [(exit code, output)] by rank, all killed past GROUP_TIMEOUT_S."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", GROUP_PROGRAM, mode, addr, str(world), str(r), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def counted(fn):
    """(``fn()``, the launches of K4, K1, K2 and K2s over it, by wrapper name)."""
    from sfm_tpu_torch.ops.gather import (
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.ops.gray import rgb_to_gray
    from sfm_tpu_torch.ops.harris import harris_response

    wrappers = (rgb_to_gray, harris_response, sample_normalized_patches,
                sample_normalized_patches_sharded)
    before = [f.launches for f in wrappers]
    out = fn()
    torch.cuda.synchronize()
    return out, {f.__name__: f.launches - b for f, b in zip(wrappers, before)}


def sparse_copy(r):
    """A SparseReconstruction with its own copy of the world points (BA
    refines them in place)."""
    from sfm_tpu_torch.sfm.pipeline import SparseReconstruction

    return SparseReconstruction(calib=r.calib, world=r.world.copy(),
                                track_offsets=r.track_offsets,
                                track_obs=r.track_obs)


def stages(images, calib, mesh=None, ba_input=None, mvs_input=None):
    """SfM (kernels on), points-only BA (f32) and MVS at the CLI defaults on
    cuda:0 or over ``mesh``; BA runs on ``ba_input`` and MVS on
    ``mvs_input`` where given.  Each stage's result and launches."""
    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig, MvsConfig, PipelineConfig, RuntimeConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.sfm import structure_from_motion

    cfg = PipelineConfig(runtime=RuntimeConfig(device="cuda", kernels=True))
    # A fresh host copy misses the per-process grayscale cache
    # (io.device_gray): SfM converts and uploads it, as a pass's first
    # stage does, and MVS finds its gray there.
    images = images.copy()
    sparse, l_sfm = counted(lambda: structure_from_motion(
        images, calib, cfg, mesh=mesh))
    ba_input = sparse if ba_input is None else ba_input
    (ba, info), l_ba = counted(lambda: bundle_adjust(
        sparse_copy(ba_input), BaConfig(dtype="float32"), mesh=mesh,
        device="cuda"))
    mvs_input = ba if mvs_input is None else mvs_input
    dense, l_mvs = counted(lambda: dense_reconstruction(
        images, calib, mvs_input, MvsConfig(), scale=1.0, mesh=mesh,
        device="cuda"))
    return {"sparse": sparse, "ba": ba, "ba_info": info, "dense": dense,
            "launches": {"sfm": l_sfm, "ba": l_ba, "mvs": l_mvs}}


def sweeps(dense):
    """MVS's K2 sweeps by the dispatch-ahead rule: the seeds' one, plus
    one a round enqueued."""
    from sfm_tpu_torch.config import MvsConfig

    mv = dense.metrics.values
    enq, _ = enqueued_rounds(mv["mvs_rounds"], mv["mvs_num_points"],
                             dense.num_seeds, MvsConfig())
    return 1 + enq


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def scene(card):
    from sfm_tpu_torch.utils import synth

    return synth.render_scene(synth.ring_rig(12), w=200, h=150, seed=0)


@pytest.fixture(scope="module")
def unsharded(scene):
    return stages(*scene)


def test_ring_launch_counts(unsharded):
    sparse, dense = unsharded["sparse"], unsharded["dense"]
    lc = unsharded["launches"]
    assert sparse.num_tracks > 50 and dense.num_points > dense.num_seeds > 50
    assert sparse.metrics.values["gray_route"] == "kernel"
    assert sparse.metrics.values["track_store_backend"] == "native"
    assert {k: lc["sfm"][k] for k in ("rgb_to_gray", "harris_response",
                                      "sample_normalized_patches")} == {
        "rgb_to_gray": 1, "harris_response": 1, "sample_normalized_patches": 1}
    assert lc["ba"] == dict.fromkeys(lc["ba"], 0)
    k2 = sweeps(dense)
    assert lc["mvs"] == {"rgb_to_gray": 0, "harris_response": 0,
                         "sample_normalized_patches": k2,
                         "sample_normalized_patches_sharded": k2}


def test_stages_on_four_virtual_shards(scene, unsharded):
    from sfm_tpu_torch.parallel import DataMesh

    want = unsharded
    # BA and MVS take the unsharded stage's input, so each stage is held
    # alone to its unsharded run.
    got = stages(*scene, mesh=DataMesh([torch.device("cuda", 0)] * SHARDS),
                 ba_input=want["sparse"], mvs_input=want["ba"])
    sp, sp0 = got["sparse"], want["sparse"]
    np.testing.assert_array_equal(sp.track_offsets, sp0.track_offsets)
    np.testing.assert_array_equal(sp.track_obs, sp0.track_obs)
    # f32 triangulation batched over another number of pairs a call: the
    # last bit may move (6e-8 on the card).
    np.testing.assert_allclose(sp.world, sp0.world, rtol=0, atol=1e-6)
    # BA's sums are regrouped per shard (f32).
    info, info0 = got["ba_info"], want["ba_info"]
    assert info["iterations"] == info0["iterations"] >= 1
    assert abs(got["ba"].rms_reprojection_error()
               - want["ba"].rms_reprojection_error()) <= 1e-4
    np.testing.assert_allclose(got["ba"].world, want["ba"].world, rtol=0, atol=1e-5)
    # MVS on the same input: K2s is bit-equal to one K2 call, so the same
    # patches are accepted; their mean NCC, reduced over another number of
    # candidates a shard, may move in its last bit (1.8e-7 on the card).
    d, d0 = got["dense"], want["dense"]
    assert d.num_seeds == d0.num_seeds
    assert d.metrics.values["mvs_rounds"] == d0.metrics.values["mvs_rounds"]
    for f in ("points", "colors", "normals", "refs"):
        np.testing.assert_array_equal(getattr(d, f), getattr(d0, f), f)
    np.testing.assert_allclose(d.scores, d0.scores, rtol=0, atol=1e-6)
    lc = got["launches"]
    assert lc["sfm"]["harris_response"] == lc["sfm"]["sample_normalized_patches"] == SHARDS
    assert lc["ba"] == dict.fromkeys(lc["ba"], 0)
    # Every sweep goes through K2s's launch step, once per shard; the seeds'
    # one runs on the lead shard alone.
    k2 = 1 + SHARDS * (sweeps(d) - 1)
    assert lc["mvs"] == {"rgb_to_gray": 0, "harris_response": 0,
                         "sample_normalized_patches": k2,
                         "sample_normalized_patches_sharded": k2}


def test_round_makes_no_synchronizing_call(scene, unsharded):
    """One ``expansion_round`` at the MVS defaults on the seeded frontier,
    a chunk of two rounds, then at ``BACKLOG_CAP`` the frontier split with
    a backlog, a round, the backlog merge and a round: first outside
    ``set_sync_debug_mode("error")`` (which also warms every op), then
    inside it, where a synchronizing CUDA call raises (as a host read
    there shows), each payload equal to the first pass's."""
    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.mvs.cells import make_occupancy
    from sfm_tpu_torch.mvs.expand import expansion_round
    from sfm_tpu_torch.mvs.pipeline import _merge_backlog, _split_frontier
    from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches

    images, _ = scene
    recon = unsharded["ba"]
    dev = torch.device("cuda", 0)
    n, h, w = images.shape[:3]
    cfg = MvsConfig()
    gray = device_gray(images, dev).to(torch.bfloat16)
    cal = recon.calib
    K, R, t, C = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (cal.K, cal.R, cal.t, cal.centers))
    tid, ref_obs, oth = build_seed_candidates(recon.track_offsets, recon.track_obs)
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tid, ref_obs, oth)]
    occ = make_occupancy(n, h, w, cfg.cell_size, dev)
    seeds, occ, _ = seed_patches(gray, K, R, t, C, *ints, recon.num_tracks, occ,
                                 cfg, cfg.visible_lower_bound)
    keys = ("c", "n", "vis", "proj", "valid")

    def step(fr, occ, cap, k=1):
        return expansion_round(gray, K, R, t, C, occ, *(fr[x] for x in keys),
                               cfg, cfg.visible_lower_bound, cap, 1.0,
                               rounds_per_call=k)

    def calls():
        fr, _ = _split_frontier(seeds, cfg.round_capacity)
        one = step(fr, occ, cfg.round_capacity)[2]
        two = step(fr, occ, cfg.round_capacity, k=2)[2]
        fr, bl = _split_frontier(seeds, BACKLOG_CAP)
        acc, occ2, first = step(fr, occ, BACKLOG_CAP)
        fr, bl = _merge_backlog(acc, bl, BACKLOG_CAP)
        merged = step(fr, occ2, BACKLOG_CAP)[2]
        return {"round": one, "chunk_of_2": two, "backlog_round_1": first,
                "backlog_merged_round": merged, "backlog_left": bl["valid"].sum()}

    want = calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode catches a host read
            torch.ones(1, device=dev).item()
        got = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(seeds["valid"].sum()) > 2 * BACKLOG_CAP
    assert int(got["backlog_left"]) > 0, "the backlog case kept no backlog"
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_one_process_nccl_group_runs_ba_as_one_device(card):
    ((rc, out),) = run_group("nccl_one", 1)
    assert rc == 0, out[-4000:]
    assert "NCCL ONE-PROCESS GROUP EQUAL" in out


def test_two_nccl_processes_on_one_gpu_are_refused(card):
    for rank, (rc, out) in enumerate(run_group("nccl_two", 2)):
        assert rc != 0, f"rank {rank} was not refused:\n{out[-4000:]}"
        assert "ValueError: NCCL group places two processes on one GPU" in out, (
            out[-4000:])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_group_processes_run_the_stages_as_the_single_controller_mesh(
        card, backend):
    """Processes of a group, one shard each: two gloo processes on cuda:0,
    or one NCCL process per GPU (two GPUs or more; NCCL refuses two
    processes on one GPU).  The same outputs in every process, K1 and K2
    once each in SfM and K2 once a sweep in MVS in each, and those
    outputs the single-controller mesh's of the same devices bit for
    bit."""
    from sfm_tpu_torch.config import MvsConfig

    world = 2 if backend == "gloo" else torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices: one NCCL process a GPU")
    ranks = run_group(f"{backend}_stages", world)
    for rank, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {rank}:\n{out[-4000:]}"
    lines = [{ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
              for ln in out.splitlines() if ln.startswith(("RANK ", "SINGLE "))}
             for _, out in ranks]
    assert len({line["RANK"]["digest"] for line in lines}) == 1
    got, want, equal = (lines[0]["SINGLE"][k] for k in ("got", "want", "equal"))
    # As tests/test_torch_multiprocess.py holds the CPU ranks: every output
    # bit for bit (the group moves raw bytes and sums in shard order).
    assert equal == dict.fromkeys(equal, True), equal
    assert got["ba/iterations"] >= 1 and got["mvs/num_seeds"] > 50
    enq, _ = enqueued_rounds(got["mvs/rounds"], got["mvs/num_points"],
                             got["mvs/num_seeds"], MvsConfig())
    for line in lines:
        assert line["RANK"]["launches"] == {"sfm": [1, 1], "mvs_k2": 1 + enq}


def test_outlier_filter_sweep_is_one_k2_launch_and_the_host_oracle(
        scene, unsharded, monkeypatch):
    """MVS with the outlier filter on the card: the filter's visibility
    sweep is one K2 launch on top of the unfiltered stage's, the rounds
    are the unfiltered stage's, and the device filter's keep mask equals
    the host oracle's (``mvs/filter.py:filter_outliers``) on the same
    visibility."""
    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction, pipeline
    from sfm_tpu_torch.mvs.filter import filter_outliers
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    seen = {}
    real_run, real_dev = pipeline._run_device_filter, pipeline.filter_outliers_device

    def counted_run(*a, **kw):
        before = sample_normalized_patches.launches
        keep = real_run(*a, **kw)
        seen["launches"] = sample_normalized_patches.launches - before
        return keep

    def held_to_oracle(pts, nrm, sco, vis, proj, valid, cell, gw, gh, **kw):
        keep, group, hits = real_dev(pts, nrm, sco, vis, proj, valid, cell,
                                     gw, gh, **kw)
        want = filter_outliers(*(x.cpu().numpy() for x in (pts, nrm, sco, vis, proj)),
                               cell, gw, gh)
        seen["oracle_equal"] = bool(np.array_equal(keep.cpu().numpy(), want))
        return keep, group, hits

    monkeypatch.setattr(pipeline, "_run_device_filter", counted_run)
    monkeypatch.setattr(pipeline, "filter_outliers_device", held_to_oracle)
    images, calib = scene
    dense0 = unsharded["dense"]
    fdense, lc = counted(lambda: dense_reconstruction(
        images, calib, unsharded["ba"], MvsConfig(enable_outlier_filter=True),
        scale=1.0, device="cuda"))
    fm = fdense.metrics.values
    assert seen == {"launches": 1, "oracle_equal": True}
    assert lc["sample_normalized_patches"] == sweeps(dense0) + 1
    assert fm["mvs_num_points"] == dense0.num_points
    assert fdense.num_points == fm["mvs_num_points"] - fm["mvs_filtered_out"] > 0


def resident_bytes(cfg, n, h, w, n_pairs):
    """What the SfM stage holds on the device besides a chunk of the pair
    program: the uint8 RGB upload, the gray stack (f32 and its bf16 copy),
    K1's response, the feature set, RANSAC's uniforms (f64) and the pair
    outputs."""
    k, m = cfg.features.max_corners, cfg.features.max_matches
    d = (2 * cfg.features.desc_wid + 1) ** 2
    return (n * h * w * (3 + 4 + 2 + 4) + n * k * (8 + 1 + 4 * d)
            + n_pairs * cfg.ransac.num_hypotheses * 8 * 8
            + n_pairs * (m * 8 * 4 + 4 * 4 + 9 * 4))


def test_allpairs_sfm_in_chunks_is_one_chunk(scene, monkeypatch):
    """All-pairs SfM, the ring's 66 pairs: in one chunk and, with the chunk
    budget set to 7 pairs' working set, in 10, the same tracks (the world
    points within 1e-6: f32 triangulation batched over another number of
    pairs a call, 4e-7 on the card), K1 and K2 launched once each."""
    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig, SfmConfig
    from sfm_tpu_torch.sfm import pipeline as t_pipeline
    from sfm_tpu_torch.sfm import structure_from_motion

    images, calib = scene
    cfg = PipelineConfig(sfm=SfmConfig(pair_mode="combination"),
                         runtime=RuntimeConfig(device="cuda", kernels=True))
    one, lc = counted(lambda: structure_from_motion(images.copy(), calib, cfg))
    assert one.metrics.values["num_pairs"] == 66
    assert one.metrics.values["pair_chunks"] == 1
    assert lc["harris_response"] == lc["sample_normalized_patches"] == 1
    budget = 7 * t_pipeline.pair_working_bytes(cfg)
    monkeypatch.setattr(t_pipeline, "chunk_budget_bytes", lambda device: budget)
    got, lc = counted(lambda: structure_from_motion(images.copy(), calib, cfg))
    assert got.metrics.values["pair_chunks"] == 10
    assert lc["harris_response"] == lc["sample_normalized_patches"] == 1
    for f in ("track_offsets", "track_obs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f), f)
    np.testing.assert_allclose(got.world, one.world, rtol=0, atol=1e-6)


def test_allpairs_peak_memory_within_the_chunk_budget(card):
    """All-pairs SfM on the 48-frame 640x480 ring (1,128 pairs) at the
    default chunk budget, a quarter of the card: the pairs take two chunks
    or more, and the stage's peak device memory above what it found
    allocated stays within the budget plus what it holds besides a chunk
    (``resident_bytes``).  At small budgets the per-pair estimate is not a
    bound (ROADMAP F14), so the check runs where the budget binds on the
    main path's shape."""
    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig, SfmConfig
    from sfm_tpu_torch.sfm import pipeline as t_pipeline
    from sfm_tpu_torch.sfm import structure_from_motion
    from sfm_tpu_torch.utils import synth

    images, calib = synth.render_scene(synth.ring_rig(48), w=640, h=480, seed=0)
    n, h, w = images.shape[:3]
    cfg = PipelineConfig(sfm=SfmConfig(pair_mode="combination"),
                         runtime=RuntimeConfig(device="cuda", kernels=True))
    budget = t_pipeline.chunk_budget_bytes(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    recon, lc = counted(lambda: structure_from_motion(images, calib, cfg))
    peak = torch.cuda.max_memory_allocated() - base
    assert recon.metrics.values["num_pairs"] == 1128
    assert recon.metrics.values["pair_chunks"] >= 2
    assert lc["harris_response"] == lc["sample_normalized_patches"] == 1
    assert peak <= budget + resident_bytes(cfg, n, h, w, 1128), (peak, budget)


def test_cli_profile_dir_trace_names_k1_and_k2(card, tmp_path):
    """``--profile_dir`` on a CUDA device records the device's activity:
    the Chrome trace of an all-pairs SfM names K1's and K2's kernels."""
    pytest.importorskip("PIL")
    from sfm_tpu_torch.cli import TRACE_FILE
    from sfm_tpu_torch.cli import main as cli_main
    from sfm_tpu_torch.tools.measure import kernel_named
    from sfm_tpu_torch.utils import synth

    ds, prof = str(tmp_path / "ring"), str(tmp_path / "prof")
    _, par, _ = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12), w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), seed=0)
    rc = cli_main(["-img_p", ds, "-par_p", par, "-t", "png", "--stages", "sfm",
                   "--nonSequence", "--out_dir", str(tmp_path / "out"),
                   "--profile_dir", prof])
    assert rc == 0
    with open(os.path.join(prof, TRACE_FILE)) as f:
        trace = json.load(f)
    kernels = [e.get("name", "") for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    for base in ("harris_kernel", "gather_kernel"):
        assert any(kernel_named(k, base) for k in kernels), base
