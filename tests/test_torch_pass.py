"""The port's pass -- ``structure_from_motion`` -> ``bundle_adjust`` ->
``dense_reconstruction``, chained as the CLI and the benchmark chain them
(MVS at BA's output and calibration) -- against the same chain through
``sfm_tpu``, on the CPU.

Scene: the 12-frame 200x150 sphere ring of tests/test_torch_allpairs.py
(features 512 / 256), BA in float64, MVS at scale 1 with
tests/test_torch_multiprocess.py's round capacity 2048 and 3 rounds (at
scale 10 this ring's seeds grow no patch).  Each package's SfM result
comes from that file's ``runs`` fixture, where the port is fed
sfm_tpu's RANSAC draws for all pairs; for sequential pairs the port is
fed sfm_tpu's draws as tests/test_torch_sharded.py feeds them.  From there each package chains
its own stages.  Bounds: tracks equal observation for observation, world
points within 1e-5 (f32 DLT in two frameworks); BA's iterations equal and
its cost, points and cameras within the float64 bounds of
tests/test_torch_ba.py (1e-6 / 1e-5; 1e-2 by PCG, whose solves stop
unconverged on this ring); the dense cloud's seeds equal, its size within
2 % (tests/test_torch_mvs.py: borderline NCC flips across frameworks).

Within the port: the sequential stage forced into chunks of the pair axis
gives the one-chunk result bit for bit; BA's deferred fetch and MVS's seed
overlap move when the host reads, not what the pass returns; and MVS reads
no BA point (seeds re-triangulate from the observations), so the joint
chains' clouds are the points-only chain's.
"""

import numpy as np
import pytest
import torch

from sfm_tpu.ba.run import bundle_adjust as j_bundle_adjust
from sfm_tpu.config import BaConfig as JBaConfig
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.mvs import dense_reconstruction as j_dense
from test_torch_allpairs import assert_bit_equal, runs  # noqa: F401 (a fixture)
from test_torch_sharded import jax_draws

import sfm_tpu_torch.config as tconfig
import sfm_tpu_torch.sfm.pipeline as t_pipeline
from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import BaConfig, MvsConfig
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.sfm import structure_from_motion

torch.set_num_threads(2)

SCALE = 1.0
MVS = dict(round_capacity=2048, max_rounds=3)
CLOUD = ("points", "colors", "normals", "scores", "refs")
# Each chain's SfM (sequential or all pairs), BA options, and whether
# sfm_tpu's MVS runs: a joint chain's cloud is the points-only chain's (the
# module docstring), which the port's joint chains are held to.
CHAINS = {
    "sequential": ("sequential", {}, True),
    "joint_dense_schur": ("sequential", dict(refine_cameras=True), False),
    "joint_pcg": ("sequential", dict(refine_cameras=True, dense_schur_max_cams=0),
                  False),
    "allpairs": ("allpairs", {}, True),
}
CASES = [("sequential", "tracks"), ("sequential", "ba"), ("sequential", "dense"),
         ("joint_dense_schur", "ba"), ("joint_pcg", "ba"),
         ("allpairs", "tracks"), ("allpairs", "ba"), ("allpairs", "dense")]


def copy_sparse(r):
    """``r``'s tracks with their own copy of the world points (BA refines
    them in place) and their own metrics; either package's
    SparseReconstruction."""
    return type(r)(calib=r.calib, world=np.array(r.world, copy=True),
                   track_offsets=r.track_offsets, track_obs=r.track_obs)


def jax_pass(images, sparse, ba, mvs):
    recon, info = j_bundle_adjust(copy_sparse(sparse), JBaConfig(dtype="float64", **ba))
    dense = j_dense(images, recon.calib, recon, JMvsConfig(**MVS), SCALE) if mvs else None
    return recon, info, dense


def port_pass(images, sparse, ba, defer_fetch=False, mvs=MvsConfig(**MVS)):
    """BA and MVS on ``sparse``, as the CLI chains them; with
    ``defer_fetch`` BA's solution reaches the host after MVS has run."""
    recon, info = bundle_adjust(copy_sparse(sparse), BaConfig(dtype="float64", **ba),
                                device="cpu", defer_fetch=defer_fetch)
    dense = dense_reconstruction(images, recon.calib, recon, mvs, SCALE,
                                 device="cpu")
    if defer_fetch:
        info["finalize"]()
    return recon, info, dense


@pytest.fixture(scope="module")
def sequential(runs):  # noqa: F811
    """The port's sequential SfM fed sfm_tpu's draws; sfm_tpu's is
    ``runs["seq"]``, at the same configuration."""
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    cfg = tconfig.from_jax_config(jcfg, device="cpu")
    draws = jax_draws(runs["images"], jcfg)
    fed = structure_from_motion(runs["images"], runs["calib"], cfg,
                                ransac_samples=draws)
    return {"cfg": cfg, "draws": draws, "fed": fed}


@pytest.fixture(scope="module")
def passes(runs, sequential):  # noqa: F811
    """chain -> {"jax": (sparse, BA recon, BA info, dense), "port": ...},
    each chain run once, when a test first asks for it."""
    sparse = {"sequential": (runs["seq"], sequential["fed"]),
              "allpairs": (runs["want"], runs["fed"])}
    memo = {}

    def get(chain):
        if chain not in memo:
            sfm, ba, jax_mvs = CHAINS[chain]
            jsp, tsp = sparse[sfm]
            memo[chain] = {"jax": (jsp, *jax_pass(runs["images"], jsp, ba, jax_mvs)),
                           "port": (tsp, *port_pass(runs["images"], tsp, ba))}
        return memo[chain]

    return get


@pytest.mark.parametrize("chain,output", CASES, ids=[f"{c}-{o}" for c, o in CASES])
def test_pass_against_sfm_tpu(passes, chain, output):
    (jsp, jrec, jinfo, jdense) = passes(chain)["jax"]
    (tsp, trec, tinfo, tdense) = passes(chain)["port"]
    if output == "tracks":
        assert jsp.num_tracks > 50
        np.testing.assert_array_equal(tsp.track_offsets, jsp.track_offsets)
        np.testing.assert_array_equal(tsp.track_obs, jsp.track_obs)
        np.testing.assert_allclose(tsp.world, jsp.world, rtol=0, atol=1e-5)
    elif output == "ba":
        # PCG's solves stop at their iteration cap unconverged on this ring:
        # tests/test_torch_ba.py::test_bundle_adjust_refine_cameras_matches_jax's
        # 1e-2 there, its 1e-6 / 1e-5 elsewhere.
        tol, atol = (1e-2, 1e-2) if chain == "joint_pcg" else (1e-6, 1e-5)
        assert tinfo["camera_solver"] == jinfo["camera_solver"]
        assert tinfo["iterations"] == jinfo["iterations"] >= 1
        np.testing.assert_allclose(tinfo["final_cost"], jinfo["final_cost"], rtol=tol)
        np.testing.assert_allclose(trec.world, jrec.world, rtol=0, atol=atol)
        if "cams11" in jinfo:
            np.testing.assert_allclose(tinfo["cams11"], jinfo["cams11"],
                                       rtol=tol, atol=atol)
            # The joint optimum lies below the points-only one (at its own
            # cameras; against the calibration its points drift, as the
            # reference's do).
            points_only = passes("sequential")["port"][2]
            assert tinfo["rms_reproj_refined_px"] < points_only["rms_reproj_refined_px"]
        else:
            assert trec.rms_reprojection_error() < 0.3
    else:
        assert tdense.num_seeds == jdense.num_seeds > 50
        assert tdense.num_points > tdense.num_seeds
        assert abs(tdense.num_points - jdense.num_points) <= 0.02 * jdense.num_points


@pytest.mark.parametrize("chain", ["joint_dense_schur", "joint_pcg"])
def test_joint_chain_cloud_is_the_points_only_chains(passes, chain):
    got, want = passes(chain)["port"][3], passes("sequential")["port"][3]
    for f in CLOUD:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("pairs_per_chunk,chunks", [(4, 3), (1, 11)])
def test_sequential_pairs_in_chunks_are_one_chunk(runs, sequential, monkeypatch,
                                                  pairs_per_chunk, chunks):
    """The ring's 11 sequential pairs in chunks of 4 and of 1 pair give
    the one-chunk result bit for bit."""
    per_pair = t_pipeline.pair_working_bytes(sequential["cfg"])
    monkeypatch.setattr(t_pipeline, "chunk_budget_bytes",
                        lambda device: pairs_per_chunk * per_pair)
    got = structure_from_motion(runs["images"], runs["calib"], sequential["cfg"],
                                ransac_samples=sequential["draws"])
    assert sequential["fed"].metrics.values["pair_chunks"] == 1
    assert got.metrics.values["pair_chunks"] == chunks
    assert_bit_equal(got, sequential["fed"])


@pytest.mark.parametrize("defer_fetch,seed_overlap", [(True, True), (False, False),
                                                      (True, False)])
def test_overlap_switches_leave_the_pass_unchanged(runs, sequential, passes,
                                                   defer_fetch, seed_overlap):
    """BA's deferred fetch and MVS's seed overlap against the CLI's pass
    (eager fetch, seed overlap on): the same BA result and cloud."""
    _, want_rec, want_info, want_dense = passes("sequential")["port"]
    rec, info, dense = port_pass(
        runs["images"], sequential["fed"], {}, defer_fetch=defer_fetch,
        mvs=MvsConfig(**MVS, overlap_seed_fetch=seed_overlap))
    np.testing.assert_array_equal(rec.world, want_rec.world)
    for k in ("iterations", "final_cost", "rms_reproj_refined_px"):
        assert info[k] == want_info[k], k
    for f in CLOUD:
        np.testing.assert_array_equal(getattr(dense, f), getattr(want_dense, f), f)
