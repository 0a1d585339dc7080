"""All-pairs SfM (``pair_mode="combination"``, the CLI's ``--nonSequence``)
of the port against sfm_tpu's, on the CPU.

Scene: the 12-frame 200x150 sphere ring (66 pairs; sfm_tpu, at its
defaults, pads it to a 16-image bucket and 120 pairs).  As in
tests/test_torch_sfm.py the port is fed sfm_tpu's RANSAC draws, with the
keys split over the 66 real pairs as sfm_tpu's pipeline splits them; then
the reconstruction must agree observation for observation, the world
points within 1e-5 units.

One change to the draws, made in this test only: sfm_tpu draws each
hypothesis's 8 correspondences with replacement, and wide-baseline pairs
have only 9-40 matches, so many samples hold fewer than 8 distinct
correspondences.  Their 8-point system has a null space of two or more
dimensions, each framework's eigen-solver returns another member of it,
and such a sample won RANSAC on about one pair in six of this ring, with
another F in each package.  So while sfm_tpu runs here,
``jax.random.categorical`` draws 8 distinct correspondences (its
``distinct_draws``, the same keys), and the port is fed the same draws.
The pair program runs in chunks of the pair axis; chunked, unchunked and
on 8 virtual shards (pad pairs) it gives the same result bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfm_tpu.utils.fetch as j_fetch
from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.config import RansacConfig as JRansacConfig
from sfm_tpu.config import SfmConfig as JSfmConfig
from sfm_tpu.features.frontend import detect_and_describe as j_describe
from sfm_tpu.features.matching import match_descriptors as j_match
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu.sfm.pipeline import pair_schedule as j_pair_schedule
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
import sfm_tpu.sfm.pipeline as j_sfm_pipeline

import sfm_tpu_torch.config as tconfig
import sfm_tpu_torch.sfm.pipeline as t_pipeline
from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.io import Calibration, read_ply
from sfm_tpu_torch.parallel import DataMesh
from sfm_tpu_torch.sfm.pipeline import structure_from_motion
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

N_FRAMES = 12
N_PAIRS = N_FRAMES * (N_FRAMES - 1) // 2
H = 384  # hypotheses: a count no other test traces sfm_tpu's RANSAC at


def distinct_draws(key, logits, shape):
    """``jax.random.categorical``'s place in sfm_tpu's RANSAC for this
    module: each hypothesis takes 8 distinct valid correspondences (the
    Gumbel top-k trick), so no 8-point system is degenerate."""
    g = jax.random.gumbel(key, (shape[0], logits.shape[-1]), logits.dtype)
    return jax.lax.top_k(g + logits, shape[1])[1]


@pytest.fixture(scope="module")
def runs():
    images, cal = synth.render_scene(
        synth.ring_rig(N_FRAMES), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcfg = JPipelineConfig(
        features=JFeatureConfig(max_corners=512, max_matches=256),
        ransac=JRansacConfig(num_hypotheses=H),
        sfm=JSfmConfig(pair_mode="combination"),
    )
    assert jcfg.runtime.shape_buckets  # sfm_tpu at its defaults
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    # sfm_tpu's run with distinct draws (traced afresh: the pair program's
    # cache is cleared before and after), and its per-pair payload
    # (p1 | p2 | X | ok, stats in the last row) as its stage fetches it.
    fetched, real_fetch = [], j_fetch.fetch
    traced, real_draw = [], jax.random.categorical

    def keep(x):
        out = real_fetch(x)
        fetched.append(out)
        return out

    def draw(key, logits, shape):
        traced.append(shape)
        return distinct_draws(key, logits, shape)

    j_fetch.fetch, jax.random.categorical = keep, draw
    j_sfm_pipeline._make_pair_program.cache_clear()
    try:
        want = j_sfm(images, jcal, jcfg)
    finally:
        j_fetch.fetch, jax.random.categorical = real_fetch, real_draw
        j_sfm_pipeline._make_pair_program.cache_clear()
    assert traced == [(H, 8)], traced
    payload = [a for a in fetched if a.ndim == 3][0][:N_PAIRS]
    seq = j_sfm(images, jcal, JPipelineConfig(features=jcfg.features))
    # The same draws for the port, from JAX's own matches, with the keys
    # split over the real pairs (sfm_tpu/sfm/pipeline.py:414-416).
    fc = jcfg.features
    fs = j_describe(j_device_gray(images), fc, use_pallas=False)
    pairs = j_pair_schedule(N_FRAMES, "combination")
    keys = jax.random.split(jax.random.PRNGKey(jcfg.runtime.seed), len(pairs))
    match = jax.jit(functools.partial(
        j_match, lowe_ratio=fc.lowe_ratio, max_matches=fc.max_matches,
        mutual_check=fc.mutual_check))
    draws = []
    for p, (a, b) in enumerate(pairs):
        m = match(fs.descriptors[a], fs.valid[a], fs.descriptors[b], fs.valid[b])
        logits = jnp.where(m.valid & (m.count >= fc.min_matches), 0.0, -jnp.inf)
        draws.append(np.asarray(distinct_draws(keys[p], logits[None, :], (H, 8))))
    cfg = tconfig.from_jax_config(jcfg, device="cpu")
    calib = Calibration.from_numpy(cal.K, cal.R, cal.t, cal.names)
    samples = torch.from_numpy(np.stack(draws))
    fed = structure_from_motion(images, calib, cfg, ransac_samples=samples)
    return dict(images=images, calib=calib, cfg=cfg, samples=samples,
                want=want, seq=seq, fed=fed, payload=payload, pairs=pairs)


def test_allpairs_matches_jax_with_fed_draws(runs):
    want, fed, payload = runs["want"], runs["fed"], runs["payload"]
    assert want.metrics.values["num_pairs"] == N_PAIRS
    assert want.metrics.values["pair_axis_padded"] > 0  # the 16-image bucket
    assert fed.metrics.values["pair_chunks"] == 1
    np.testing.assert_array_equal(fed.track_offsets, want.track_offsets)
    np.testing.assert_array_equal(fed.track_obs, want.track_obs)
    # f32 DLT + Gauss-Newton in two frameworks: world points to 1e-5 units.
    np.testing.assert_allclose(fed.world, want.world, rtol=0, atol=1e-5)
    for k in ("num_pairs", "matches_per_pair_mean", "inliers_per_pair_mean",
              "gated_points_total", "num_tracks", "num_observations"):
        assert fed.metrics.values[k] == want.metrics.values[k], k
    np.testing.assert_allclose(
        fed.metrics.values["mean_pair_reprojection_error_px"],
        want.metrics.values["mean_pair_reprojection_error_px"], rtol=1e-4)
    # All pairs find more tracks than the sequential chain, and longer ones.
    assert want.num_tracks > runs["seq"].num_tracks > 50
    assert fed.track_lengths().max() > 2
    assert (payload[:, -1, 0] >= 8).sum() > 20  # pairs with enough matches


def assert_bit_equal(got, want):
    for f in ("world", "track_offsets", "track_obs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for k, v in want.metrics.values.items():
        if k not in ("pair_chunks", "mesh_devices", "features_image_axis_padded"):
            assert got.metrics.values[k] == v, k


def test_allpairs_chunked_is_bit_equal(runs, monkeypatch):
    """With the chunk budget forced down to 7 pairs' working set, the 66
    pairs run in 10 chunks and give the one-batch result bit for bit."""
    per_pair = t_pipeline.pair_working_bytes(runs["cfg"])
    monkeypatch.setattr(t_pipeline, "chunk_budget_bytes",
                        lambda device: 7 * per_pair + 1)
    got = structure_from_motion(runs["images"], runs["calib"], runs["cfg"],
                                ransac_samples=runs["samples"])
    assert got.metrics.values["pair_chunks"] == 10
    assert_bit_equal(got, runs["fed"])


def test_allpairs_on_8_virtual_shards(runs, monkeypatch):
    """66 pairs on 8 shards: 6 pad pairs, each shard's 9 pairs in chunks of
    4; the same reconstruction as one batch."""
    per_pair = t_pipeline.pair_working_bytes(runs["cfg"])
    monkeypatch.setattr(t_pipeline, "chunk_budget_bytes",
                        lambda device: 4 * per_pair)
    mesh = DataMesh([torch.device("cpu")] * 8)
    got = structure_from_motion(runs["images"], runs["calib"], runs["cfg"],
                                ransac_samples=runs["samples"], mesh=mesh)
    assert got.metrics.values["pair_chunks"] == 8 * 3
    assert got.metrics.values["mesh_devices"] == 8
    assert_bit_equal(got, runs["fed"])


def test_allpairs_own_generator_on_the_sphere(runs):
    """The port's own draws (no JAX): the ground-truth bounds of
    tests/test_pipeline_synthetic.py, and more tracks than the sequential
    chain."""
    own = structure_from_motion(runs["images"], runs["calib"], runs["cfg"])
    assert own.metrics.values["mean_pair_reprojection_error_px"] < 0.3
    r_err = np.abs(np.linalg.norm(own.world, axis=1) - 1.0)
    assert np.median(r_err) < 0.01 and np.percentile(r_err, 95) < 0.05
    assert own.num_tracks > runs["seq"].num_tracks
    want = runs["want"].num_tracks
    assert abs(own.num_tracks - want) <= 0.1 * want


def test_pairs_per_chunk_follows_the_budget(runs, monkeypatch):
    cfg = runs["cfg"]
    per_pair = t_pipeline.pair_working_bytes(cfg)
    # RANSAC's (H, M) tensors dominate at these shapes.
    assert per_pair >= 4 * 32 * cfg.ransac.num_hypotheses * cfg.features.max_matches
    for budget, want in ((0, 1), (per_pair - 1, 1), (per_pair, 1),
                         (5 * per_pair + 3, 5)):
        monkeypatch.setattr(t_pipeline, "chunk_budget_bytes",
                            lambda device, b=budget: b)
        assert t_pipeline.pairs_per_chunk(cfg, torch.device("cpu")) == want
    monkeypatch.undo()
    assert t_pipeline.chunk_budget_bytes(torch.device("cpu")) > 0


def test_cli_non_sequence_sfm_ba(tmp_path):
    """The twin of tests/test_cli.py::test_non_sequence_full_pipeline on a
    rendered Middlebury-layout dataset: ``--nonSequence --stages sfm,ba``
    exits 0 and keeps at least as many BA points as the sequential run."""
    pytest.importorskip("PIL")
    ds = str(tmp_path / "ring")
    _, par, spheres = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(N_FRAMES), w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0,
    )
    base = ["-img_p", ds, "-par_p", par, "-t", "png", "--max_corners", "512",
            "--max_matches", "256", "--stages", "sfm,ba", "--device", "cpu"]
    comb, seq = str(tmp_path / "comb"), str(tmp_path / "seq")
    assert t_main(base + ["--nonSequence", "--out_dir", comb]) == 0
    assert t_main(base + ["--out_dir", seq]) == 0
    pts_comb, _ = read_ply(f"{comb}/sparse_points_ba.ply")
    pts_seq, _ = read_ply(f"{seq}/sparse_points_ba.ply")
    assert pts_comb.shape[0] >= pts_seq.shape[0] > 50
    assert np.percentile(synth.surface_distance(pts_comb, spheres), 95) < 0.05
