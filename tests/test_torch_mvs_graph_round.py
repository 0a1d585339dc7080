"""MVS expansion rounds over the call's static buffers (``mvs/pipeline.py:
_Rounds``), on the CPU.

Each chunk of rounds reads the frontier and occupancy buffers allocated
once a call and copies its accepted frontier and occupancy back into them;
the backlog merge writes its frontier into them between chunks.  On one
CUDA device the chunks after the first replay a CUDA graph of that body
(``tests/test_torch_card_paths_cuda.py`` holds the replay to the eager
body on the card); everywhere else the body runs eagerly.  Here:

- the body on the buffers, run eagerly for several chunks, gives payloads,
  a frontier and an occupancy bit-identical to the rounds chained as the
  loop chained them before the buffers (each chunk's outputs handed to the
  next), at ``rounds_per_call`` 1 and 2, with a frontier that fits and one
  that overflows into a backlog merged back between chunks;
- the graph predicate (``parallel.mesh.graphable``) holds only for a mesh
  of one CUDA device in one process;
- the round counters count the eager rounds of whole ``dense_reconstruction``
  calls, and the benchmark's reader of ``mvs_round_graph_share`` reads
  0.0 there and None where no round could replay.

Scene: the port's own SfM and BA on a 12-frame 200x150 sphere ring.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import (
    BaConfig,
    FeatureConfig,
    MvsConfig,
    PipelineConfig,
    RuntimeConfig,
    mvs_device_knobs,
)
from sfm_tpu_torch.io.images import device_gray
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.mvs import pipeline as t_pipeline
from sfm_tpu_torch.mvs.cells import make_occupancy
from sfm_tpu_torch.mvs.expand import expansion_round
from sfm_tpu_torch.mvs.pipeline import (
    _FRONTIER_KEYS,
    _merge_backlog,
    _Rounds,
    _split_frontier,
)
from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
from sfm_tpu_torch.parallel.mesh import DataMesh, GroupMesh, graphable
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

torch.set_num_threads(2)

CHUNKS = 4        # chunks run on each side
BACKLOG_CAP = 64  # under the ring's seeds: the split leaves a backlog
COUNTERS = ("rounds_dispatched", "rounds_first", "rounds_replayed")


@pytest.fixture(scope="module")
def scene():
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    cfg = PipelineConfig(
        features=FeatureConfig(max_corners=512, max_matches=256),
        runtime=RuntimeConfig(device="cpu"))
    sparse = structure_from_motion(images, cal, cfg)
    recon, _ = bundle_adjust(sparse, BaConfig(dtype="float32"), device="cpu")
    return images, recon


@pytest.fixture(scope="module")
def seeded(scene):
    """The stage's operands on the CPU and its seeds, as
    ``dense_reconstruction`` makes them at the defaults."""
    images, recon = scene
    n, h, w = images.shape[:3]
    cfg = mvs_device_knobs(MvsConfig())
    bound = cfg.visible_lower_bound
    gray = device_gray(images, "cpu").to(torch.bfloat16)
    cal = recon.calib
    K, R, t, C = (torch.as_tensor(np.asarray(a, np.float32))
                  for a in (cal.K, cal.R, cal.t, cal.centers))
    tid, ref_obs, oth = build_seed_candidates(recon.track_offsets,
                                              recon.track_obs)
    ints = [torch.as_tensor(np.asarray(a, np.int32))
            for a in (tid, ref_obs, oth)]
    occ = make_occupancy(n, h, w, cfg.cell_size)
    seeds, occ, _ = seed_patches(gray, K, R, t, C, *ints, recon.num_tracks,
                                 occ, cfg, bound)
    return dict(ops=(gray, K, R, t, C), cfg=cfg, bound=bound, seeds=seeds,
                occ=occ)


def run_chunk_of(seeded, cap, chunk):
    gray, K, R, t, C = seeded["ops"]

    def run(occ, fr):
        return expansion_round(
            gray, K, R, t, C, occ, *(fr[k] for k in _FRONTIER_KEYS),
            seeded["cfg"], seeded["bound"], cap, 1.0, rounds_per_call=chunk)

    return run


def chained(seeded, cap, chunk):
    """The rounds as the loop chained them before the static buffers: each
    chunk's accepted frontier and occupancy handed to the next, the
    backlog merged before every chunk after the first."""
    run = run_chunk_of(seeded, cap, chunk)
    fr, backlog = _split_frontier(seeded["seeds"], cap)
    occ = seeded["occ"]
    payloads = []
    for i in range(CHUNKS):
        if i and backlog is not None:
            fr, backlog = _merge_backlog(fr, backlog, cap)
        acc, occ, packed = run(occ, fr)
        fr = {k: acc[k] for k in _FRONTIER_KEYS}
        payloads.append(packed)
    return payloads, fr, occ, backlog


def on_buffers(seeded, cap, chunk):
    """The same chunks through ``_Rounds`` (eager: the CPU), the merge
    written into its frontier."""
    fr, backlog = _split_frontier(seeded["seeds"], cap)
    rounds = _Rounds(fr, seeded["occ"], chunk, run_chunk_of(seeded, cap, chunk),
                     graph=False)
    frontier_at = {k: v.data_ptr() for k, v in rounds.frontier.items()}
    payloads = []
    for i in range(CHUNKS):
        if i and backlog is not None:
            merged, backlog = _merge_backlog(rounds.frontier, backlog, cap)
            rounds.load(merged)
        payloads.append(rounds.dispatch())
    # The buffers are the call's own: never reallocated.
    assert {k: v.data_ptr() for k, v in rounds.frontier.items()} == frontier_at
    return payloads, rounds.frontier, rounds.occupancy, backlog


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("cap", [2048, BACKLOG_CAP])
def test_rounds_on_static_buffers_are_the_chained_rounds(seeded, cap, chunk):
    want = chained(seeded, cap, chunk)
    got = on_buffers(seeded, cap, chunk)
    n_seeds = int(seeded["seeds"]["valid"].sum())
    if cap == BACKLOG_CAP:
        assert n_seeds > 2 * cap, "the backlog case kept no backlog"
        assert want[3] is not None
    else:
        assert n_seeds <= cap and want[3] is None
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    # The rounds accepted patches: the comparison is not of empty rounds.
    accepted = [p.reshape(chunk, cap + 1, 11)[:, :cap, 10].sum()
                for p in want[0]]
    assert float(accepted[0]) > 0
    for k in _FRONTIER_KEYS:
        assert torch.equal(got[1][k], want[1][k]), k
    assert torch.equal(got[2], want[2])
    if want[3] is not None:
        for k in _FRONTIER_KEYS:
            assert torch.equal(got[3][k], want[3][k]), k


# --- where the graph engages --------------------------------------------------

def group_mesh_of(devices):
    """A ``GroupMesh`` object of one process's ``devices`` without a
    process group (the predicate reads only its type and devices)."""
    mesh = GroupMesh.__new__(GroupMesh)
    DataMesh.__init__(mesh, devices)
    return mesh


@pytest.mark.parametrize("mesh,want", [
    (DataMesh([torch.device("cpu")]), False),
    (DataMesh([torch.device("cpu")] * 4), False),
    (DataMesh([torch.device("cuda", 0)] * 2), False),
    (DataMesh([torch.device("cuda", 0), torch.device("cuda", 1)]), False),
    (group_mesh_of([torch.device("cuda", 0)]), False),
    (DataMesh([torch.device("cuda", 0)]), True),
], ids=["cpu", "4_cpu_shards", "2_shards_on_one_gpu", "2_gpus",
        "group_rank_on_one_gpu", "one_gpu"])
def test_graph_engages_on_one_cuda_device_in_one_process(mesh, want):
    assert graphable(mesh) is want


# --- the counters and the benchmark's reader ---------------------------------

def counts():
    return [getattr(dense_reconstruction, k) for k in COUNTERS]


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("shards", [1, 4])
def test_round_counters_count_eager_rounds(scene, monkeypatch, chunk, shards):
    images, recon = scene
    enqueued = [0]
    real = t_pipeline.expansion_round

    def counting(*a, **kw):
        enqueued[0] += kw["rounds_per_call"]
        return real(*a, **kw)

    monkeypatch.setattr(t_pipeline, "expansion_round", counting)
    mesh = DataMesh([torch.device("cpu")] * shards) if shards > 1 else None
    before = counts()
    dense = dense_reconstruction(
        images, recon.calib, recon,
        MvsConfig(max_rounds=6, rounds_per_call=chunk, shape_buckets=False),
        device="cpu", mesh=mesh)
    dispatched, first, replayed = (b - a for a, b in zip(before, counts()))
    assert dense.metrics.values["mvs_rounds"] > chunk
    assert dispatched == enqueued[0] > first == chunk
    assert replayed == 0


def reader():
    from benchkit.catalog import Catalog

    cat = Catalog(REPO)
    (entry,) = [m for m in cat.spec["per_layer"]
                if m["name"] == "mvs_round_graph_share"]
    return entry, cat.reader(entry), cat


def test_graph_share_reader_reads_the_round_counters(monkeypatch):
    from benchkit.harness import RunData

    entry, mod, cat = reader()
    by_name = {m["name"]: m for m in cat.spec["per_layer"]}
    assert (entry["source"], entry["unit"], entry["better"],
            entry["moves"]) == ("program_counter", "share", "higher",
                                "frames_per_s")
    assert entry["layer"] == by_name["mvs_enqueue_s"]["layer"]
    assert entry["workloads"] == by_name["mvs_s"]["workloads"]
    run = RunData(frames=16, shapes={})
    # Eager rounds only (the CPU, a mesh of several devices): 0.0.
    for k, v in zip(COUNTERS, (12, 2, 0)):
        monkeypatch.setattr(dense_reconstruction, k, v)
    assert mod.read(run) == 0.0
    # Every round after each call's first chunk replayed: 1.0.
    monkeypatch.setattr(dense_reconstruction, "rounds_replayed", 10)
    assert mod.read(run) == 1.0
    # No round dispatched, or none after a first chunk: nothing to read.
    for k, v in zip(COUNTERS, (2, 2, 0)):
        monkeypatch.setattr(dense_reconstruction, k, v)
    assert mod.read(run) is None
    for k in COUNTERS:
        monkeypatch.setattr(dense_reconstruction, k, 0)
    assert mod.read(run) is None
    # A program without the counters (the parent) gives nothing.
    monkeypatch.delattr(dense_reconstruction, "rounds_replayed")
    assert mod.read(run) is None
