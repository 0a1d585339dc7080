"""The MVS and BA schedule of the port against sfm_tpu's, on the CPU.

The JAX package's host loop enqueues ``rounds_per_call`` rounds as one
chunk and merges the backlog only between chunks, so with a backlog the
chunk size changes the cloud; it also enqueues the next chunk before it
reads this one (dispatch-ahead), and round 1 before the seed payload
(``overlap_seed_fetch``).  The port follows it letter for letter.

Scene: ``tests/test_torch_mvs.py``'s 12-frame 200x150 sphere ring with
sfm_tpu's sparse result carried across, ``max_rounds`` 8, ``max_patches``
20,000, ``shape_buckets`` off.  Across packages the counts agree within 2 %
and the round and backlog counters exactly, the tolerances of
``test_dense_reconstruction_on_carried_sparse_matches_jax`` (borderline NCC
flips, found and bounded there).  Within the port, a schedule that only
moves when the host reads gives a bit-identical cloud.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba.run import bundle_adjust as j_bundle_adjust
from sfm_tpu.config import BaConfig as JBaConfig
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.mvs import dense_reconstruction as j_dense
from sfm_tpu.mvs.expand import ordered_compact as j_ordered_compact
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import BaConfig, MvsConfig, mvs_device_knobs, sparse_from_jax
from sfm_tpu_torch.io.images import gray_tensor
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.mvs import pipeline as t_pipeline
from sfm_tpu_torch.mvs.cells import make_occupancy
from sfm_tpu_torch.mvs.expand import expansion_round, ordered_compact
from sfm_tpu_torch.mvs.pipeline import _split_frontier
from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
from sfm_tpu_torch.parallel import DataMesh
from sfm_tpu_torch.utils import checkpoint as t_ckpt
from sfm_tpu_torch.utils import synth

from mvs_rounds import enqueued_rounds

torch.set_num_threads(2)

BASE = dict(max_rounds=8, max_patches=20000, shape_buckets=False)
CLOUD = ("points", "colors", "normals", "scores", "refs")
COUNTERS = ("mvs_rounds", "mvs_backlog_rounds", "mvs_seed_frontier_deferred")


@pytest.fixture(scope="module")
def scene():
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    jrec = j_sfm(images, jcal, jcfg)
    return dict(images=images, jcal=jcal, jrec=jrec, rec=sparse_from_jax(jrec))


@pytest.fixture(scope="module")
def jax_dense(scene):
    """sfm_tpu's cloud per MVS configuration, each computed once."""
    cache = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = j_dense(scene["images"], scene["jcal"], scene["jrec"],
                                 JMvsConfig(**BASE, **kw))
        return cache[key]

    return run


@pytest.fixture(scope="module")
def port_dense(scene):
    """The port's cloud per MVS configuration and call options, each
    computed once."""
    cache = {}

    def run(mesh=None, checkpoint_dir=None, checkpoint_every=16, **kw):
        key = (tuple(sorted(kw.items())), checkpoint_dir, checkpoint_every,
               None if mesh is None else mesh.size)
        if key not in cache:
            rec = scene["rec"]
            cache[key] = dense_reconstruction(
                scene["images"], rec.calib, rec, MvsConfig(**BASE, **kw),
                device="cpu", mesh=mesh, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
        return cache[key]

    return run


def assert_same_cloud(got, want):
    assert got.num_seeds == want.num_seeds
    for f in CLOUD:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for k in ("mvs_rounds", "mvs_num_points"):
        assert got.metrics.values[k] == want.metrics.values[k], k


# --- the compaction ---------------------------------------------------------

def nonzero_static(flags, size, fill):
    """The port's compaction before ``ordered_compact`` (one host read):
    ``torch.nonzero``, cut to ``size``, padded with ``fill``."""
    idx = torch.nonzero(flags).reshape(-1)[:size]
    pad = torch.full((size - idx.shape[0],), fill, dtype=idx.dtype)
    return torch.cat([idx, pad])


@pytest.mark.parametrize("case", ["none", "all", "over_size", "random"])
def test_ordered_compact_is_nonzero_static(case):
    rng = np.random.default_rng(7)
    n = 300
    flags = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
             "over_size": rng.random(n) < 0.9,
             "random": rng.random(n) < 0.2}[case]
    for size in (1, 10, 64, 150, 300):
        fill = n - 1 if size % 2 else 5
        want = np.asarray(jnp.nonzero(jnp.asarray(flags), size=size,
                                      fill_value=fill)[0])
        got = ordered_compact(torch.from_numpy(flags), size, fill)
        assert got.dtype == torch.int64 and got.shape == (size,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), nonzero_static(torch.from_numpy(flags), size, fill).numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_ordered_compact(jnp.asarray(flags), size, fill)))


# --- rounds_per_call in one call -------------------------------------------------

def test_chunk_of_rounds_is_chained_rounds(scene):
    """expansion_round(rounds_per_call=3) is three chained one-round calls,
    bit for bit: the frontier and occupancy carried, the payloads stacked."""
    images, rec = scene["images"], scene["rec"]
    cfg = MvsConfig(**BASE, round_capacity=256)
    knobs = mvs_device_knobs(cfg)
    gray = gray_tensor(images, "cpu").to(torch.bfloat16)
    cal = rec.calib
    K, R, t, C = (torch.from_numpy(np.asarray(a, np.float32))
                  for a in (cal.K, cal.R, cal.t, cal.centers))
    occ = make_occupancy(*images.shape[:3], cfg.cell_size, "cpu")
    tid, ref, other = build_seed_candidates(rec.track_offsets, rec.track_obs)
    seeds, occ, _ = seed_patches(
        gray, K, R, t, C, torch.from_numpy(tid).int(), torch.from_numpy(ref).int(),
        torch.from_numpy(other).int(), rec.num_tracks, occ, knobs, 3)
    fr, _ = _split_frontier(seeds, cfg.round_capacity)
    keys = ("c", "n", "vis", "proj", "valid")
    args = (knobs, 3, cfg.round_capacity, 1.0)
    acc3, occ3, pk3 = expansion_round(gray, K, R, t, C, occ,
                                      *(fr[k] for k in keys), *args,
                                      rounds_per_call=3)
    assert pk3.shape == (3, cfg.round_capacity + 1, 11)
    packs = []
    for _ in range(3):
        fr, occ, pk = expansion_round(gray, K, R, t, C, occ,
                                      *(fr[k] for k in keys), *args)
        assert pk.shape == (cfg.round_capacity + 1, 11)
        packs.append(pk)
    assert torch.equal(pk3, torch.stack(packs))
    assert torch.equal(occ3, occ)
    for k in acc3:
        assert torch.equal(acc3[k], fr[k]), k
    assert (pk3[:, -1, 6] > 0).all()  # three rounds that accepted patches


# --- F10: rounds_per_call against sfm_tpu ----------------------------------------

@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("cap,chunk", [(64, 1), (64, 3), (2048, 3)])
def test_rounds_per_call_matches_jax(jax_dense, port_dense, cap, chunk, overlap):
    """F10: with a backlog (cap 64 < the seed count) sfm_tpu merges it only
    between chunks, so its cloud at rounds_per_call 3 differs from one
    round a call (fewer backlog rounds); the port gives sfm_tpu's."""
    kw = dict(round_capacity=cap, rounds_per_call=chunk,
              overlap_seed_fetch=overlap)
    want, got = jax_dense(**kw), port_dense(**kw)
    assert want.num_points > 200
    assert abs(got.num_seeds - want.num_seeds) <= 0.02 * want.num_seeds
    assert abs(got.num_points - want.num_points) <= 0.02 * want.num_points, (
        got.num_points, want.num_points)
    for k in COUNTERS:
        assert got.metrics.values.get(k) == want.metrics.values.get(k), k
    if cap == 64:
        assert want.metrics.values["mvs_backlog_rounds"] > 0


# --- schedules that only move when the host reads ----------------------------------

@pytest.mark.parametrize("cap", [64, 2048])
def test_pipelined_is_serial(port_dense, tmp_path, cap):
    """Dispatch-ahead and the round-1 overlap against the serial loop: a
    checkpoint due every round rules dispatch-ahead out."""
    pipelined = port_dense(round_capacity=cap)
    serial = port_dense(round_capacity=cap, overlap_seed_fetch=False,
                        checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert_same_cloud(pipelined, serial)
    assert not (tmp_path / t_ckpt.MVS_STATE_FILE).exists()


@pytest.mark.parametrize("chunk", [1, 3])
def test_seed_overlap_is_bit_identical(port_dense, chunk):
    kw = dict(round_capacity=64, rounds_per_call=chunk)
    assert_same_cloud(port_dense(**kw, overlap_seed_fetch=True),
                      port_dense(**kw, overlap_seed_fetch=False))


def test_chunked_kill_and_resume_is_bit_identical(scene, port_dense, tmp_path):
    """At rounds_per_call 3 with a backlog: killed on its third chunk
    (after two saved chunks, six rounds), then resumed; the cloud is the
    uninterrupted run's."""
    images, rec = scene["images"], scene["rec"]
    kw = dict(round_capacity=64, rounds_per_call=3)
    full = port_dense(**kw)
    ck = str(tmp_path / "ckpt")
    real, calls = t_pipeline.expansion_round, {"n": 0}

    def killing_round(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    t_pipeline.expansion_round = killing_round
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            dense_reconstruction(images, rec.calib, rec, MvsConfig(**BASE, **kw),
                                 device="cpu", checkpoint_dir=ck,
                                 checkpoint_every=3)
    finally:
        t_pipeline.expansion_round = real
    state = t_ckpt.load_mvs_state(ck)
    assert int(state["counters"][1]) == 6 and state["b_valid"].sum() > 0
    resumed = dense_reconstruction(images, rec.calib, rec, MvsConfig(**BASE, **kw),
                                   device="cpu", checkpoint_dir=ck,
                                   checkpoint_every=3)
    assert resumed.metrics.values["mvs_resumed_at_round"] == 6
    assert_same_cloud(resumed, full)
    assert t_ckpt.load_mvs_state(ck) is None


def test_chunked_on_virtual_shards_is_unsharded(port_dense):
    kw = dict(round_capacity=64, rounds_per_call=3)
    sharded = port_dense(mesh=DataMesh([torch.device("cpu")] * 4), **kw)
    assert sharded.metrics.values["mvs_mesh_devices"] == 4
    assert_same_cloud(sharded, port_dense(**kw))


@pytest.mark.parametrize("budget", [dict(max_rounds=4), dict(max_patches=230)])
def test_budget_mid_chunk_matches_jax(scene, jax_dense, budget):
    """A budget reached inside a chunk of 3 stops there, as in sfm_tpu."""
    kw = dict(round_capacity=64, rounds_per_call=3)
    cfg = {**BASE, **kw, **budget}
    want = j_dense(scene["images"], scene["jcal"], scene["jrec"], JMvsConfig(**cfg))
    rec = scene["rec"]
    got = dense_reconstruction(scene["images"], rec.calib, rec,
                               MvsConfig(**cfg), device="cpu")
    rounds = got.metrics.values["mvs_rounds"]
    assert rounds == want.metrics.values["mvs_rounds"]
    assert rounds % 3 != 0  # the budget stopped the loop inside a chunk
    assert abs(got.num_points - want.num_points) <= 0.02 * want.num_points
    if "max_rounds" in budget:
        assert rounds == budget["max_rounds"]
    else:
        assert got.num_points >= budget["max_patches"]


# --- BA's defer_fetch ----------------------------------------------------------

def test_defer_fetch_matches_eager(scene):
    """bundle_adjust(defer_fetch=True) + finalize() (twice) gives the eager
    results bit for bit (``tests/test_ba.py``'s test of the JAX package),
    and the info keys of sfm_tpu's deferred call."""
    r = scene["jrec"]
    cfg = BaConfig(dtype="float64")
    r_eager, i_eager = bundle_adjust(sparse_from_jax(r), cfg, device="cpu")
    recon = sparse_from_jax(r)
    world0 = recon.world.copy()
    r_def, i_def = bundle_adjust(recon, cfg, device="cpu", defer_fetch=True)
    jrec = type(r)(calib=r.calib, world=np.array(r.world),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)
    _, j_def = j_bundle_adjust(jrec, JBaConfig(dtype="float64"), defer_fetch=True)
    assert set(i_def) == set(j_def)
    assert "final_cost" not in i_def and "ba_final_cost" not in r_def.metrics.values
    np.testing.assert_array_equal(r_def.world, world0)  # not written back yet
    assert i_def["finalize"]() == (r_def, i_def)
    i_def["finalize"]()  # idempotent
    assert set(i_def) == set(i_eager)
    for k in ("final_cost", "iterations", "rms_reproj_refined_px"):
        assert i_def[k] == i_eager[k], k
    np.testing.assert_array_equal(r_def.world, r_eager.world)
    assert r_def.metrics.values == r_eager.metrics.values
    assert set(i_def["timers"]) == {"assemble", "solve", "fetch"}


def test_defer_fetch_joint_cameras(scene):
    """With refine_cameras the refined cameras arrive with finalize."""
    cfg = BaConfig(dtype="float64", refine_cameras=True)
    r_eager, i_eager = bundle_adjust(sparse_from_jax(scene["jrec"]), cfg,
                                     device="cpu")
    r_def, i_def = bundle_adjust(sparse_from_jax(scene["jrec"]), cfg,
                                 device="cpu", defer_fetch=True)
    assert "cams11" not in i_def and "ba_rms_reproj_after_px" not in r_def.metrics.values
    i_def["finalize"]()
    np.testing.assert_array_equal(i_def["cams11"], i_eager["cams11"])
    np.testing.assert_array_equal(r_def.world, r_eager.world)
    assert i_def["final_cost"] == i_eager["final_cost"]
    assert r_def.metrics.values == r_eager.metrics.values


# --- the rule the card tests hold K2's launches to ---------------------------------

@pytest.mark.parametrize("cap,chunk,max_rounds,max_patches", [
    (2048, 1, 64, 20000),   # stops on a dry round: one round enqueued ahead
    (2048, 2, 8, 1500),     # a chunk cut by the patch budget
    (2048, 3, 64, 20000),   # stops on a dry round mid-chunk, a chunk ahead
    (64, 3, 8, 20000),      # a backlog all the way: nothing ahead
    (300, 2, 3, 20000),     # the round budget inside a chunk
])
def test_rounds_enqueued_follow_the_dispatch_ahead_rule(
        scene, cap, chunk, max_rounds, max_patches, monkeypatch):
    """The rounds the host loop enqueues (each one K2 sweep on the card)
    are those that ``enqueued_rounds`` derives from a run's final
    counters, read rounds and rounds never read included."""
    enqueued = [0]
    real = t_pipeline.expansion_round

    def counting(*a, **kw):
        enqueued[0] += kw["rounds_per_call"]
        return real(*a, **kw)

    monkeypatch.setattr(t_pipeline, "expansion_round", counting)
    cfg = MvsConfig(round_capacity=cap, rounds_per_call=chunk,
                    max_rounds=max_rounds, max_patches=max_patches,
                    shape_buckets=False)
    rec = scene["rec"]
    dense = dense_reconstruction(scene["images"], rec.calib, rec, cfg, device="cpu")
    mv = dense.metrics.values
    want, wasted = enqueued_rounds(
        mv["mvs_rounds"], mv["mvs_num_points"], dense.num_seeds, cfg,
        backlog_left=mv.get("mvs_backlog_remaining", 0))
    assert enqueued[0] == want
    assert wasted == want - mv["mvs_rounds"] >= 0
