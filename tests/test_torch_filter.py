"""The port's outlier filter against sfm_tpu's, on the CPU.

Host oracle against host oracle (the cases of tests/test_mvs.py and random
clouds): keep masks equal.  Device filter against the port's oracle and
against ``sfm_tpu.mvs.filter.filter_outliers_device``: keep masks,
``max_group`` and ``hits_dropped`` equal (every quantity is a decision or a
count; the support threshold is summed in float64 in the port and its
oracle, in float32 in sfm_tpu's device filter, and no case here sits within
that rounding of its threshold).  The pipeline flag on the 12-frame 200x150
sphere ring (cap 2048, 8 rounds, sfm_tpu's sparse result carried across):
the recompute of sfm_tpu's own cloud gives sfm_tpu's keep mask outside
borderline patches (NCC within EPS = 2e-3 of the threshold, found by
rerunning sfm_tpu's filter at thresholds -+EPS, as tests/test_torch_mvs.py
does), and the filtered run's counts lie within 2 % of sfm_tpu's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu.mvs import dense_reconstruction as j_dense
from sfm_tpu.mvs.filter import filter_outliers as j_filter
from sfm_tpu.mvs.filter import filter_outliers_device as j_filter_device
from sfm_tpu.mvs.pipeline import _run_device_filter as j_run_filter
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from sfm_tpu.utils.metrics import Metrics as JMetrics

from sfm_tpu_torch.config import MvsConfig, sparse_from_jax
from sfm_tpu_torch.io.images import gray_tensor
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.mvs import pipeline as t_pipeline
from sfm_tpu_torch.mvs.filter import filter_outliers, filter_outliers_device
from sfm_tpu_torch.parallel import DataMesh
from sfm_tpu_torch.utils import synth
from sfm_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(2)

EPS = 2e-3
GRID = dict(cell_size=2, grid_w=320, grid_h=240)


def stray_case():
    """tests/test_mvs.py::TestOutlierFilter: 5 coplanar supported patches
    and a weak stray off the plane, all in one cell of image 1."""
    d = 6
    points = np.zeros((d, 3), np.float32)
    points[:5, 0] = np.arange(5) * 0.01
    points[5] = [0.0, 0.0, 5.0]
    normals = np.zeros((d, 3), np.float32)
    normals[:, 2] = 1.0
    scores = np.asarray([0.9, 0.9, 0.9, 0.9, 0.95, 0.1], np.float32)
    vis = np.zeros((d, 4), bool)
    vis[:, 1] = True
    proj = np.zeros((d, 4, 2), np.float32)
    proj[:, 1] = [10.0, 10.0]
    return points, normals, scores, vis, proj


def consistent_case():
    d = 4
    points = np.random.default_rng(0).normal(size=(d, 3)).astype(np.float32) * 0.01
    normals = np.zeros((d, 3), np.float32)
    normals[:, 2] = 1.0
    return (points, normals, np.full(d, 0.9, np.float32), np.ones((d, 2), bool),
            np.full((d, 2, 2), 20.0, np.float32))


def nonbest_case():
    """tests/test_mvs.py::TestOutlierFilterExactPairwise: the weak patch is
    coplanar with the cell's best patch and non-neighbouring with another."""
    d = 3
    points = np.zeros((d, 3), np.float32)
    normals = np.zeros((d, 3), np.float32)
    normals[:, 2] = 1.0
    points[2] = [0.0, 0.0, 0.5]
    scores = np.asarray([0.95, 0.05, 0.5], np.float32)
    vis = np.zeros((d, 2), bool)
    vis[:, 0] = True
    proj = np.zeros((d, 2, 2), np.float32)
    proj[:, 0] = [30.0, 30.0]
    return points, normals, scores, vis, proj


def random_case(seed, d=200, n=6, span=24.0):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(d, 3)).astype(np.float32) * 0.05
    normals = rng.normal(size=(d, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    scores = rng.uniform(0.02, 1.0, d).astype(np.float32)
    vis = rng.random((d, n)) < 0.5
    proj = rng.uniform(0, span, (d, n, 2)).astype(np.float32)
    return points, normals, scores, vis, proj


def empty_case():
    return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros(0, np.float32), np.zeros((0, 2), bool),
            np.zeros((0, 2, 2), np.float32))


CASES = {
    "stray": stray_case, "consistent": consistent_case,
    "nonbest": nonbest_case, "empty": empty_case,
    "random3": lambda: random_case(3), "random7": lambda: random_case(7),
    # 4 x 4 cells for 400 patches x 6 views: crowded cells.
    "crowded": lambda: random_case(11, d=400, span=8.0),
}


def run_device(case, g_cap=64, k_hit=0, pad=0):
    points, normals, scores, vis, proj = case
    d = points.shape[0]

    def padded(a):
        return torch.from_numpy(
            np.concatenate([a, np.ones((pad, *a.shape[1:]), a.dtype)]))

    valid = torch.arange(d + pad) < d
    keep, max_group, hits = filter_outliers_device(
        *(padded(a) for a in (points, normals, scores, vis, proj)), valid,
        g_cap=g_cap, k_hit=k_hit, **GRID)
    return keep.numpy(), int(max_group), int(hits)


def run_jax_device(case, g_cap=64, k_hit=0):
    points, normals, scores, vis, proj = case
    keep, max_group, hits = j_filter_device(
        *(jnp.asarray(a) for a in (points, normals, scores, vis, proj)),
        jnp.ones(points.shape[0], bool), g_cap=g_cap, k_hit=k_hit, **GRID)
    return np.asarray(keep), int(max_group), int(hits)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_oracle_equals_jax(name):
    case = CASES[name]()
    keep = filter_outliers(*case, **GRID)
    np.testing.assert_array_equal(keep, j_filter(*case, **GRID))
    if name == "stray":
        assert keep[:5].all() and not keep[5]
    if name == "nonbest":
        assert not keep[1] and keep[0] and keep[2]
    if name in ("random3", "random7", "crowded"):
        assert 0 < (~keep).sum() < keep.size


@pytest.mark.parametrize("name", sorted(set(CASES) - {"empty"}))
def test_device_filter_equals_oracle_and_jax(name):
    case = CASES[name]()
    want = filter_outliers(*case, **GRID)
    keep, max_group, hits = run_device(case, g_cap=256)
    np.testing.assert_array_equal(keep, want)
    j_keep, j_group, j_hits = run_jax_device(case, g_cap=256)
    np.testing.assert_array_equal(keep, j_keep)
    assert (max_group, hits) == (j_group, j_hits) and hits == 0


def test_device_filter_empty():
    keep, max_group, hits = run_device(empty_case())
    assert keep.shape == (0,) and max_group == 0 and hits == 0


def test_padding_rows_are_inert():
    case = random_case(3)
    want = filter_outliers(*case, **GRID)
    keep, max_group, hits = run_device(case, g_cap=256, pad=37)
    np.testing.assert_array_equal(keep[:200], want)
    assert not keep[200:].any() and hits == 0
    assert max_group == run_device(case, g_cap=256)[1]


def test_k_hit_bounds_the_incidences():
    """A gated cloud (<= 3 visible views per patch) filtered with k_hit = 3
    equals the ungated filter; a row with more hits shows in hits_dropped."""
    points, normals, scores, vis, proj = random_case(5)
    extra = np.cumsum(vis, axis=1) > 3
    vis3 = vis & ~extra
    case = (points, normals, scores, vis3, proj)
    want = filter_outliers(*case, **GRID)
    keep, _, hits = run_device(case, g_cap=256, k_hit=3)
    np.testing.assert_array_equal(keep, want)
    assert hits == 0
    j_keep, _, j_hits = run_jax_device(case, g_cap=256, k_hit=3)
    np.testing.assert_array_equal(keep, j_keep)
    _, _, hits = run_device((points, normals, scores, vis, proj), k_hit=3)
    assert hits == int((vis & extra).sum()) > 0
    assert hits == run_jax_device((points, normals, scores, vis, proj), k_hit=3)[2]


def test_small_g_cap_reports_the_crowded_cell():
    """g_cap below the largest cell: max_group says so (the caller
    escalates), and the escalated cap gives the oracle's mask."""
    case = CASES["crowded"]()
    want = filter_outliers(*case, **GRID)
    _, max_group, _ = run_device(case, g_cap=2)
    assert max_group > 2
    keep, again, _ = run_device(case, g_cap=1 << (max_group - 1).bit_length())
    assert again == max_group
    np.testing.assert_array_equal(keep, want)


# --- the pipeline ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    jrec = j_sfm(images, jcal, jcfg)
    return images, cal, jcal, jrec, sparse_from_jax(jrec)


MVS = dict(round_capacity=2048, max_rounds=8, max_patches=20000,
           shape_buckets=False)


def port_filter(images, cal, cloud, cfg, mesh=None, metrics=None):
    mesh = mesh or DataMesh([torch.device("cpu")])
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    shards = [mesh.replicate(x) for x in (
        gray_tensor(images, "cpu").to(torch.bfloat16), f32(cal.K), f32(cal.R),
        f32(cal.t))]
    return t_pipeline._run_device_filter(
        mesh, *shards, cloud.points, cloud.normals, cloud.scores, cloud.refs,
        cloud.num_seeds, images.shape[1], images.shape[2], cfg,
        metrics or Metrics())


def jax_filter(images, jcal, cloud, jcfg):
    f32 = lambda a: jnp.asarray(a.astype(np.float32))  # noqa: E731
    return j_run_filter(
        j_device_gray(images), f32(jcal.K), f32(jcal.R), f32(jcal.t),
        cloud.points, cloud.normals, cloud.scores, cloud.refs, cloud.num_seeds,
        images.shape[1], images.shape[2], jcfg, JMetrics())


def fabricated(cloud):
    """The clean sphere gives the filter nothing to remove (cellmates are
    coplanar), so the rule is made to bite: a third of the patches get
    long normals (the rule does not normalise them, so their planarity
    with cellmates exceeds 0.2) and a third a weak score.  Points and
    reference images stay, so the recomputed visibility is the real one."""
    rng = np.random.default_rng(9)
    d = cloud.num_points
    normals = cloud.normals * np.where(rng.random(d) < 0.33, 300.0, 1.0)[:, None]
    scores = np.where(rng.random(d) < 0.33, 0.02, cloud.scores)
    return dataclasses.replace(cloud, normals=normals.astype(np.float32),
                               scores=scores.astype(np.float32))


@pytest.mark.parametrize("views", [-1, 5])
def test_recompute_of_jax_cloud_gives_jax_keep_mask(scene, views):
    """The unfiltered sfm_tpu cloud through both packages' filter host loops
    (one photo-consistency sweep of the whole cloud, then the device
    filter): keep masks equal outside patches that share a cell group with
    a borderline patch; views 5 takes the gated sweep and k_hit = 4."""
    images, cal, jcal, jrec, _ = scene
    jcfg = JMvsConfig(max_photo_views=views, **MVS)
    cloud = fabricated(j_dense(images, jcal, jrec, jcfg))
    want = jax_filter(images, jcal, cloud, jcfg)
    lo, hi = (jax_filter(images, jcal, cloud, dataclasses.replace(
        jcfg, min_ncc_seed=jcfg.min_ncc_seed + e,
        min_ncc_expand=jcfg.min_ncc_expand + e)) for e in (-EPS, EPS))
    metrics = Metrics()
    got = port_filter(images, cal, cloud,
                      MvsConfig(**dataclasses.asdict(jcfg)), metrics=metrics)
    assert got.shape == want.shape == (cloud.num_points,)
    assert 0 < (~want).sum() < 0.5 * want.size
    stable = (lo == want) & (hi == want)
    mismatch = got != want
    assert not (mismatch & stable).any(), np.flatnonzero(mismatch & stable)
    assert mismatch.sum() <= 0.005 * want.size
    assert metrics.values["mvs_filter_max_cell_group"] >= 2
    # Split over 8 virtual shards: the same mask.
    mesh = DataMesh([torch.device("cpu")] * 8)
    np.testing.assert_array_equal(
        port_filter(images, cal, cloud, MvsConfig(**dataclasses.asdict(jcfg)),
                    mesh=mesh), got)


def test_pipeline_flag_counts_match_jax(scene):
    images, cal, jcal, jrec, rec = scene
    jcfg = JMvsConfig(enable_outlier_filter=True, **MVS)
    want = j_dense(images, jcal, jrec, jcfg)
    got = dense_reconstruction(images, rec.calib, rec,
                               MvsConfig(**dataclasses.asdict(jcfg)), device="cpu")
    assert set(got.metrics.values) == set(want.metrics.values)
    gv, wv = got.metrics.values, want.metrics.values
    assert "mvs_filtered_out" in wv  # 0 on the clean sphere: cellmates coplanar
    # Borderline NCC flips compound over rounds (tests/test_torch_mvs.py):
    # counts within 2 % of the unfiltered cloud.
    tol = 0.02 * wv["mvs_num_points"]
    for k in ("mvs_num_points", "mvs_filtered_out", "mvs_num_points_filtered"):
        assert abs(gv[k] - wv[k]) <= tol, (k, gv[k], wv[k])
    assert abs(got.num_seeds - want.num_seeds) <= 0.02 * want.num_seeds
    assert got.num_points == gv["mvs_num_points_filtered"]
    assert got.num_points == gv["mvs_num_points"] - gv["mvs_filtered_out"]
    n = got.num_points
    assert got.colors.shape == (n, 3) and got.refs.shape == (n,)
    assert "filter" in got.timers.times
    # num_seeds is recounted after the filter: the leading rows are seeds.
    assert got.scores[: got.num_seeds].min() > 0.4
    # Two runs are identical.
    again = dense_reconstruction(images, rec.calib, rec,
                                 MvsConfig(**dataclasses.asdict(jcfg)), device="cpu")
    np.testing.assert_array_equal(again.points, got.points)


def test_escalation_loop_and_hits_dropped(scene, monkeypatch):
    """The host loop escalates g_cap past a crowded cell (metric recorded) and
    raises on dropped hits instead of returning an inexact mask (the
    reference package only records a metric there)."""
    images, cal, jcal, jrec, _ = scene
    cfg = MvsConfig(max_photo_views=5, **MVS)
    cloud = fabricated(
        j_dense(images, jcal, jrec, JMvsConfig(max_photo_views=5, **MVS)))
    plain = port_filter(images, cal, cloud, cfg)
    assert (~plain).sum() > 0
    real = t_pipeline.filter_outliers_device
    caps = []

    def recording(*a, g_cap, **kw):
        caps.append(g_cap)
        return real(*a, g_cap=g_cap, **kw)

    monkeypatch.setattr(t_pipeline, "filter_outliers_device", recording)
    monkeypatch.setattr(t_pipeline, "_FILTER_G_CAP", 2)
    metrics = Metrics()
    np.testing.assert_array_equal(
        port_filter(images, cal, cloud, cfg, metrics=metrics), plain)
    group = metrics.values["mvs_filter_max_cell_group"]
    assert group > 2 and metrics.values["mvs_filter_gcap_escalated"] == group
    assert caps == [2, 1 << (group - 1).bit_length()]
    monkeypatch.setattr(t_pipeline, "_FILTER_G_CAP", 64)

    def overfull(*a, k_hit, **kw):
        return real(*a, k_hit=1, **kw)

    monkeypatch.setattr(t_pipeline, "filter_outliers_device", overfull)
    metrics = Metrics()
    with pytest.raises(RuntimeError, match="beyond the view gate"):
        port_filter(images, cal, cloud, cfg, metrics=metrics)
    assert metrics.values["mvs_filter_hits_over_k"] > 0
