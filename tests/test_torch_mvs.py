"""Parity of the port's dense MVS with sfm_tpu's, on the CPU.

Scene: the 12-frame 200x150 sphere ring (ungated: fewer than 16 views),
``round_capacity`` 2048, ``max_rounds`` 8.  The JAX package's sparse result
is carried across (``config.sparse_from_jax``), because RANSAC draws cannot
be reproduced across frameworks.  K2's plain version samples the same bf16
stack as the JAX package, but the NCC sums run in another order, so a
candidate whose NCC lies within EPS = 2e-3 of its threshold may flip.  Such
candidates are found with sfm_tpu's own function at threshold +- EPS
("borderline"); every mismatch must be borderline, and mismatches are
bounded at 0.5 % of the candidates.  Other tolerances are stated per test.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.config import MvsConfig as JMvsConfig
from sfm_tpu.config import PipelineConfig as JPipelineConfig
from sfm_tpu.config import mvs_device_knobs as j_knobs
from sfm_tpu.config import resolve_photo_views as j_resolve
from sfm_tpu.io.calib import Calibration as JCalibration
from sfm_tpu.io.images import device_gray as j_device_gray
from sfm_tpu.mvs import cells as jcells
from sfm_tpu.mvs import dense_reconstruction as j_dense
from sfm_tpu.mvs.expand import expansion_round as j_expansion_round
from sfm_tpu.mvs.photoconsistency import photo_consistency as j_photo
from sfm_tpu.mvs.seed import build_seed_candidates as j_build_seed_candidates
from sfm_tpu.mvs.seed import seed_patches as j_seed_patches
from sfm_tpu.sfm.pipeline import structure_from_motion as j_sfm
from sfm_tpu.utils import checkpoint as j_ckpt

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import (
    BaConfig,
    FeatureConfig,
    MvsConfig,
    PipelineConfig,
    RuntimeConfig,
    mvs_device_knobs,
    resolve_photo_views,
    sparse_from_jax,
)
from sfm_tpu_torch.cli import main as t_main
from sfm_tpu_torch.io import read_ply
from sfm_tpu_torch.io.images import device_gray, gray_tensor
from sfm_tpu_torch.mvs import cells, dense_reconstruction
from sfm_tpu_torch.mvs import pipeline as t_pipeline
from sfm_tpu_torch.mvs.expand import expansion_round, ordered_compact
from sfm_tpu_torch.mvs.photoconsistency import (
    _top_k,
    pack_patch_payload,
    photo_consistency,
    unpack_patch_payload,
)
from sfm_tpu_torch.mvs.pipeline import _split_frontier
from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.utils import checkpoint as t_ckpt
from sfm_tpu_torch.utils import synth

torch.set_num_threads(2)

EPS = 2e-3          # NCC borderline band around a threshold
MAX_FLIPS = 0.005   # mismatches allowed, as a share of the candidates
CAP, ROUNDS = 2048, 8
SEED_FIELDS = ("c", "n", "ref", "vis", "proj", "score", "valid")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def t_(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def scene():
    """Images, both packages' cameras, sfm_tpu's sparse result and its
    carried copy, and both packages' inputs to the MVS functions."""
    images, cal = synth.render_scene(
        synth.ring_rig(12), w=200, h=150, seed=1, texture_freq_scale=1.0
    )
    jcal = JCalibration(K=cal.K, R=cal.R, t=cal.t, names=cal.names)
    jcfg = JPipelineConfig(features=JFeatureConfig(max_corners=512, max_matches=256))
    jrec = j_sfm(images, jcal, jcfg)
    cams = {k: getattr(cal, k).astype(np.float32) for k in ("K", "R", "t")}
    cams["C"] = cal.centers.astype(np.float32)
    j_in = dict(gray=j_device_gray(images),
                **{k: jnp.asarray(v) for k, v in cams.items()})
    t_in = dict(gray=gray_tensor(images, "cpu").to(torch.bfloat16),
                **{k: torch.from_numpy(v) for k, v in cams.items()})
    return dict(images=images, jcal=jcal, jrec=jrec, rec=sparse_from_jax(jrec),
                j=j_in, t=t_in)


# --- config, io, helpers ------------------------------------------------------

def test_config_helpers_match_jax():
    for mv in (-1, 0, 2, 5, 9):
        for n in (2, 12, 16, 48):
            assert resolve_photo_views(mv, n) == j_resolve(mv, n)
    with pytest.raises(ValueError, match="max_photo_views=1"):
        resolve_photo_views(1, 48)
    cfg = MvsConfig(cell_size=3, min_ncc_expand=0.6, max_rounds=5,
                    round_capacity=100, max_photo_views=4)
    jcfg = JMvsConfig(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(mvs_device_knobs(cfg)) == dataclasses.asdict(j_knobs(jcfg))


def test_device_gray_is_shared_and_content_keyed():
    images = np.random.default_rng(0).integers(0, 256, (3, 20, 30, 3), np.uint8)
    a = device_gray(images, "cpu")
    assert device_gray(images, "cpu") is a
    np.testing.assert_array_equal(a.numpy(), np.asarray(j_device_gray(images)))
    assert device_gray(images.copy(), "cpu") is not a
    images[0, 0, 0] = 255 - images[0, 0, 0]  # in-place edit: a new entry
    b = device_gray(images, "cpu")
    assert b is not a and not torch.equal(a, b)


def test_top_k_and_nonzero_static_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (50, 12)).astype(np.float32)  # many ties
    x[x == 0] = -np.inf
    for k in (1, 4, 12):
        jv, ji = jax_top_k(x, k)
        tv, ti = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(ti.numpy(), ji)
    flags = rng.random(300) < 0.2
    for size in (10, 64, 300):
        want = np.asarray(jnp.nonzero(jnp.asarray(flags), size=size,
                                      fill_value=299)[0])
        np.testing.assert_array_equal(
            ordered_compact(torch.from_numpy(flags), size, 299).numpy(), want)


def jax_top_k(x, k):
    import jax

    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def test_payload_roundtrip(scene):
    images = scene["images"]
    rng = np.random.default_rng(2)
    m = 40
    c, n = rng.normal(size=(m, 3)), rng.normal(size=(m, 3))
    pix = rng.uniform(-5, 205, (m, 2))
    ref = rng.integers(0, 12, m)
    valid = rng.random(m) < 0.5
    ph = pack_patch_payload(t_(c), t_(n), t_(rng.random(m)), t_(pix), t_(ref),
                            t_(valid)).numpy()
    assert ph.shape == (m, 11) and ph.dtype == np.float32
    v, c2, n2, _, colors = unpack_patch_payload(ph, images)
    np.testing.assert_array_equal(v, valid)
    np.testing.assert_allclose(c2, c, rtol=1e-6)
    x = np.clip(np.rint(ph[:, 7]).astype(int), 0, 199)
    y = np.clip(np.rint(ph[:, 8]).astype(int), 0, 149)
    np.testing.assert_array_equal(colors, images[ref, y, x])


def test_cells_match_jax():
    rng = np.random.default_rng(3)
    occ = rng.random((4,) + cells.grid_shape(150, 200, 2)) < 0.3
    assert cells.grid_shape(150, 200, 2) == jcells.grid_shape(150, 200, 2)
    assert cells.make_occupancy(4, 150, 200, 2).shape == occ.shape
    img = rng.integers(0, 4, (500,)).astype(np.int32)
    cell = rng.integers(-3, 104, (500, 2)).astype(np.int32)  # some off-grid
    mask = rng.random(500) < 0.6
    pix = rng.uniform(-4, 204, (500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        cells.which_cell(t_(pix), 2).numpy(), np.asarray(jcells.which_cell(jnp.asarray(pix), 2)))
    np.testing.assert_array_equal(
        cells.cell_center(t_(cell), 2).numpy(), np.asarray(jcells.cell_center(jnp.asarray(cell), 2)))
    np.testing.assert_array_equal(
        cells.is_vacant(t_(occ), t_(img), t_(cell)).numpy(),
        np.asarray(jcells.is_vacant(jnp.asarray(occ), jnp.asarray(img), jnp.asarray(cell))))
    got = cells.fill_cells(t_(occ), t_(img), t_(cell), t_(mask)).numpy()
    want = np.asarray(jcells.fill_cells(jnp.asarray(occ), jnp.asarray(img),
                                        jnp.asarray(cell), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)  # bit-equal grids
    assert got.sum() > occ.sum()


# --- photo-consistency --------------------------------------------------------

@pytest.fixture(scope="module")
def candidates(scene):
    """Track points jittered around the sphere (8 copies each, sigma 3e-3
    world units ~ 1 px) with the track's first image as reference."""
    r = scene["jrec"]
    rng = np.random.default_rng(4)
    pts = np.repeat(r.world, 8, axis=0)
    pts = pts + rng.normal(scale=3e-3, size=pts.shape)
    ref = np.repeat(r.track_obs[r.track_offsets[:-1], 0], 8).astype(np.int32)
    return pts.astype(np.float32), ref


def borderline_rows(a, b):
    """Rows where any field differs between two runs of sfm_tpu's function
    at threshold -EPS and +EPS."""
    out = np.zeros(np_(a[0]).shape[0], bool)
    for x, y in zip(a, b):
        d = np_(x) != np_(y)
        out |= d.reshape(d.shape[0], -1).any(axis=1)
    return out


@pytest.mark.parametrize("max_views", [0, 5])
def test_photo_consistency_matches_jax(scene, candidates, max_views):
    j, t = scene["j"], scene["t"]
    c, ref = candidates
    thr = 0.7
    jargs = (j["gray"], j["K"], j["R"], j["t"], jnp.asarray(c), jnp.asarray(ref))
    vis_j, proj_j, sm_j, cnt_j = (np_(x) for x in j_photo(*jargs, thr, 5, max_views))
    border = borderline_rows(
        [x for i, x in enumerate(j_photo(*jargs, thr - EPS, 5, max_views)) if i != 2],
        [x for i, x in enumerate(j_photo(*jargs, thr + EPS, 5, max_views)) if i != 2],
    )
    vis, proj, sm, cnt = (np_(x) for x in photo_consistency(
        t["gray"], t["K"], t["R"], t["t"], torch.from_numpy(c),
        torch.from_numpy(ref), thr, 5, max_views))
    assert vis.shape == vis_j.shape and cnt.dtype == np.int32
    np.testing.assert_allclose(proj, proj_j, rtol=0, atol=1e-4)  # pixels
    mismatch = (vis != vis_j).any(axis=1) | (cnt != cnt_j)
    assert not (mismatch & ~border).any(), np.flatnonzero(mismatch & ~border)
    assert mismatch.sum() <= MAX_FLIPS * len(c), (mismatch.sum(), len(c))
    np.testing.assert_allclose(sm[~border], sm_j[~border], rtol=0, atol=2e-3)
    assert (cnt_j >= 3).mean() > 0.2  # the scene is photo-consistent


# --- seeding and one expansion round --------------------------------------------

def seed_inputs(scene):
    r = scene["rec"]
    tid, ref_obs, oth = build_seed_candidates(r.track_offsets, r.track_obs)
    for x, y in zip((tid, ref_obs, oth),
                    j_build_seed_candidates(r.track_offsets, r.track_obs)):
        np.testing.assert_array_equal(x, y)
    return tid, ref_obs.astype(np.int32), oth.astype(np.int32), r.num_tracks


EDGE_PX = 1e-3  # a projection this close to a cell edge may change cell


def fills(occ0, out, rows, edge_of=None):
    """occ0 plus the cells a seed/expansion output would occupy from
    ``rows`` only: visible hits and the reference-projection cell.  With
    ``edge_of`` (a proj array), hits whose projection there lies within
    EDGE_PX of a cell edge are left out: the two packages' f32 projections
    differ by ~1e-5 px, which can put such a hit in the neighbouring cell."""
    occ0 = torch.from_numpy(np.array(np_(occ0)))
    vis, proj = t_(np_(out["vis"])), t_(np_(out["proj"]), torch.float32)
    valid = t_(np_(out["valid"])) & t_(rows)
    ref = t_(np_(out["ref"]), torch.int32)
    m, n = vis.shape
    hit = cells.which_cell(proj, 2)
    keep = torch.ones((m, n), dtype=torch.bool)
    if edge_of is not None:
        q = np_(edge_of) / 2.0
        keep = t_(~(np.abs(q - np.rint(q)) * 2.0 < EDGE_PX).any(axis=-1))
    img = torch.arange(n, dtype=torch.int32)[None].expand(m, n)
    occ = cells.fill_cells(occ0, img, hit, vis & valid[:, None] & keep)
    rows_m = torch.arange(m)
    ref_cell = hit[rows_m, ref.long()]
    return cells.fill_cells(occ, ref, ref_cell, valid & keep[rows_m, ref.long()]).numpy()


@pytest.fixture(scope="module")
def seeded(scene):
    j, t = scene["j"], scene["t"]
    tid, ref_obs, oth, n_tracks = seed_inputs(scene)
    occ0 = np.zeros((12,) + cells.grid_shape(150, 200, 2), bool)

    def run_jax(thr):
        cfg = JMvsConfig(min_ncc_seed=thr)
        return j_seed_patches(
            j["gray"], j["K"], j["R"], j["t"], j["C"], jnp.asarray(tid),
            jnp.asarray(ref_obs), jnp.asarray(oth), n_tracks,
            jnp.asarray(occ0), cfg, 3)

    want = run_jax(0.4)
    lo, hi = run_jax(0.4 - EPS), run_jax(0.4 + EPS)
    border = borderline_rows([lo[0][k] for k in SEED_FIELDS if k != "score"],
                             [hi[0][k] for k in SEED_FIELDS if k != "score"])
    got = seed_patches(
        t["gray"], t["K"], t["R"], t["t"], t["C"], t_(tid), t_(ref_obs),
        t_(oth), n_tracks, torch.from_numpy(occ0), MvsConfig(), 3)
    return occ0, want, got, border


def test_seed_patches_match_jax(seeded):
    occ0, (js, jocc, jpacked), (ts, tocc, tpacked), border = seeded
    valid_j, valid_t = np_(js["valid"]), np_(ts["valid"])
    assert valid_j.sum() > 100
    ok = ~border
    np.testing.assert_array_equal(valid_t[ok], valid_j[ok])
    both = ok & valid_j
    # The chosen candidate per track: same reference image and point (the
    # two-view DLT + Gauss-Newton in f32, to 1e-4 world units).
    np.testing.assert_array_equal(np_(ts["ref"])[both], np_(js["ref"])[both])
    np.testing.assert_allclose(np_(ts["c"])[both], np_(js["c"])[both], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np_(ts["vis"])[both], np_(js["vis"])[both])
    assert (valid_t != valid_j).sum() <= MAX_FLIPS * len(valid_j)
    # Occupancy: each package's grid is its own seeds' fills; outside the
    # borderline tracks the fills are the same cells.
    np.testing.assert_array_equal(np_(jocc), fills(occ0, js, np.ones_like(ok)))
    np.testing.assert_array_equal(np_(tocc), fills(occ0, ts, np.ones_like(ok)))
    np.testing.assert_array_equal(fills(occ0, ts, ok, js["proj"]),
                                  fills(occ0, js, ok, js["proj"]))
    np.testing.assert_allclose(np_(tpacked)[both], np_(jpacked)[both], rtol=0, atol=2e-3)


def test_expansion_round_from_jax_seeds_matches_jax(scene, seeded):
    j, t = scene["j"], scene["t"]
    _, (js, jocc, _), _, _ = seeded
    seeds = {k: t_(np_(js[k])) for k in ("c", "n", "vis", "proj", "valid")}
    frontier, backlog = _split_frontier(seeds, CAP)
    assert backlog is None and frontier["c"].shape[0] == CAP

    def run_jax(thr):
        return j_expansion_round(
            j["gray"], j["K"], j["R"], j["t"], j["C"], jocc,
            *(jnp.asarray(frontier[k].numpy()) for k in ("c", "n", "vis", "proj", "valid")),
            JMvsConfig(min_ncc_expand=thr), 3, CAP, 1.0)

    ja, jocc2, jpk = run_jax(0.7)
    lo, hi = run_jax(0.7 - EPS), run_jax(0.7 + EPS)
    border = borderline_rows([lo[0][k] for k in ("valid", "vis")],
                             [hi[0][k] for k in ("valid", "vis")])
    ta, tocc2, tpk = expansion_round(
        t["gray"], t["K"], t["R"], t["t"], t["C"], t_(np_(jocc)),
        frontier["c"], frontier["n"], frontier["vis"], frontier["proj"],
        frontier["valid"], MvsConfig(), 3, CAP, 1.0)
    jpk, tpk = np_(jpk), tpk.numpy()
    # Candidate enumeration, pre-dedup and geometry read identical inputs:
    # the counters before the NCC test agree exactly.
    np.testing.assert_array_equal(tpk[CAP, :5], jpk[CAP, :5])
    acc_j, acc_t = np_(ja["valid"]), np_(ta["valid"])
    assert acc_j.sum() > 50
    ok = ~border
    np.testing.assert_array_equal(acc_t[ok], acc_j[ok])
    assert (acc_t != acc_j).sum() <= MAX_FLIPS * acc_j.size
    both = ok & acc_j
    np.testing.assert_allclose(np_(ta["c"])[both], np_(ja["c"])[both], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np_(ta["ref"])[both], np_(ja["ref"])[both])
    np.testing.assert_array_equal(np_(jocc2), fills(jocc, ja, np.ones_like(ok)))
    np.testing.assert_array_equal(tocc2.numpy(), fills(jocc, ta, np.ones_like(ok)))
    np.testing.assert_array_equal(fills(jocc, ta, ok, ja["proj"]),
                                  fills(jocc, ja, ok, ja["proj"]))


# --- the slice ------------------------------------------------------------------

@pytest.mark.parametrize("cap,views", [(CAP, -1), (64, -1), (CAP, 5)])
def test_dense_reconstruction_on_carried_sparse_matches_jax(scene, cap, views,
                                                            tmp_path):
    """cap 64 < the seed count: the frontier overflows into the backlog;
    views 5: the gated sweep and its top-k hit enumeration (auto leaves a
    12-view rig ungated)."""
    images = scene["images"]
    jcfg = JMvsConfig(round_capacity=cap, max_rounds=ROUNDS, max_patches=20000,
                      max_photo_views=views, shape_buckets=False)
    want = j_dense(images, scene["jcal"], scene["jrec"], jcfg)
    rec = scene["rec"]
    got = dense_reconstruction(images, rec.calib, rec,
                               MvsConfig(**dataclasses.asdict(jcfg)), device="cpu")
    assert want.num_points > (500 if cap == CAP else 200)
    # Seed and dense counts within 2 % (borderline NCC flips compound
    # over rounds through the occupancy grid).
    assert abs(got.num_seeds - want.num_seeds) <= 0.02 * want.num_seeds
    assert abs(got.num_points - want.num_points) <= 0.02 * want.num_points
    assert set(got.metrics.values) == set(want.metrics.values)
    for k in ("mvs_rounds", "mvs_seed_frontier_deferred"):
        assert got.metrics.values.get(k) == want.metrics.values.get(k), k
    n = got.num_points
    assert got.colors.shape == (n, 3) and got.colors.dtype == np.uint8
    assert got.normals.shape == (n, 3) and got.refs.shape == (n,)
    assert got.scores[: got.num_seeds].min() > 0.4
    assert got.scores[got.num_seeds:].min() > 0.7
    if cap == 64:
        # The two options that used to raise run: the filter removes nothing
        # from the clean sphere (cellmates are coplanar), and a run that
        # checkpoints every round gives the same cloud and clears its state.
        cfg = MvsConfig(**dataclasses.asdict(jcfg))
        filtered = dense_reconstruction(
            images, rec.calib, rec,
            dataclasses.replace(cfg, enable_outlier_filter=True), device="cpu")
        assert filtered.metrics.values["mvs_filtered_out"] == 0
        np.testing.assert_array_equal(filtered.points, got.points)
        saved = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu",
                                     checkpoint_dir=str(tmp_path),
                                     checkpoint_every=1)
        np.testing.assert_array_equal(saved.points, got.points)
        assert not os.path.exists(tmp_path / t_ckpt.MVS_STATE_FILE)


# --- checkpoint / resume ----------------------------------------------------------

CKPT_CFG = dict(round_capacity=64, max_rounds=ROUNDS, max_patches=20000,
                shape_buckets=False)


def killed_run(run, module, after, *args, **kw):
    """``run(*args, **kw)`` with ``module.expansion_round`` raising on call
    ``after`` + 1: the state on disk is the one saved after ``after``
    rounds."""
    real = module.expansion_round
    calls = {"n": 0}

    def killing_round(*a, **k):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    module.expansion_round = killing_round
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            run(*args, **kw)
    finally:
        module.expansion_round = real


def test_kill_and_resume_is_bit_identical(scene, tmp_path):
    """Cap 64 is below the seed count, so the saved state carries a live
    backlog; the resumed cloud equals the uninterrupted one bit for bit."""
    images, rec = scene["images"], scene["rec"]
    cfg = MvsConfig(**CKPT_CFG)
    full = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu")
    ck = str(tmp_path / "ckpt")
    killed_run(dense_reconstruction, t_pipeline, 3, images, rec.calib, rec, cfg,
               device="cpu", checkpoint_dir=ck, checkpoint_every=1)
    state = t_ckpt.load_mvs_state(ck)
    assert int(state["counters"][1]) == 3 and state["b_valid"].sum() > 0
    resumed = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu",
                                   checkpoint_dir=ck, checkpoint_every=1)
    assert resumed.metrics.values["mvs_resumed_at_round"] == 3
    assert resumed.num_seeds == full.num_seeds
    for f in ("points", "colors", "normals", "scores", "refs"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f), f)
    for k in ("mvs_rounds", "mvs_num_points", "mvs_candidates_over_capacity"):
        assert resumed.metrics.values[k] == full.metrics.values[k], k
    assert t_ckpt.load_mvs_state(ck) is None  # completion clears the state
    # A coarser cadence saves less often: killed after 3 rounds at every=2,
    # the state on disk is round 2's, and the resume still ends the same.
    killed_run(dense_reconstruction, t_pipeline, 3, images, rec.calib, rec, cfg,
               device="cpu", checkpoint_dir=ck, checkpoint_every=2)
    assert int(t_ckpt.load_mvs_state(ck)["counters"][1]) == 2
    again = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu",
                                 checkpoint_dir=ck, checkpoint_every=2)
    np.testing.assert_array_equal(again.points, full.points)


def test_fingerprint_mismatch_rejected(scene, tmp_path):
    images, rec = scene["images"], scene["rec"]
    ck = str(tmp_path / "ckpt")
    killed_run(dense_reconstruction, t_pipeline, 1, images, rec.calib, rec,
               MvsConfig(**CKPT_CFG), device="cpu", checkpoint_dir=ck,
               checkpoint_every=1)
    for change in (dict(cell_size=4), dict(min_ncc_expand=0.6),
                   dict(enable_outlier_filter=True)):
        with pytest.raises(ValueError, match="different configuration"):
            dense_reconstruction(
                images, rec.calib, rec, MvsConfig(**{**CKPT_CFG, **change}),
                device="cpu", checkpoint_dir=ck, checkpoint_every=1)
    with pytest.raises(ValueError, match="different configuration"):
        dense_reconstruction(images, rec.calib, rec, MvsConfig(**CKPT_CFG),
                             scale=2.0, device="cpu", checkpoint_dir=ck)
    # Budgets are not part of the fingerprint: a resume may raise them.
    more = dense_reconstruction(
        images, rec.calib, rec, MvsConfig(**{**CKPT_CFG, "max_rounds": 3}),
        device="cpu", checkpoint_dir=ck)
    assert more.metrics.values["mvs_rounds"] == 3


def test_mid_mvs_state_is_the_jax_packages_format(scene, tmp_path):
    """Both packages killed after 2 rounds: the same file name, keys, dtypes
    and shapes, the same fingerprint string letter for letter; sfm_tpu's
    loader reads the port's file, and the port resumes from sfm_tpu's."""
    import sfm_tpu.mvs.pipeline as j_pipeline

    images, rec = scene["images"], scene["rec"]
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "torch")
    killed_run(j_dense, j_pipeline, 2, images, scene["jcal"], scene["jrec"],
               JMvsConfig(**CKPT_CFG), checkpoint_dir=jck, checkpoint_every=1)
    killed_run(dense_reconstruction, t_pipeline, 2, images, rec.calib, rec,
               MvsConfig(**CKPT_CFG), device="cpu", checkpoint_dir=tck,
               checkpoint_every=1)
    assert os.listdir(jck) == os.listdir(tck) == [j_ckpt.MVS_STATE_FILE]
    want, got = j_ckpt.load_mvs_state(jck), j_ckpt.load_mvs_state(tck)
    assert set(got) == set(want) and "b_c" in got
    assert str(got["fingerprint"]) == str(want["fingerprint"])
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if not k.startswith(("acc_", "b_")):  # counts differ by NCC flips
            assert got[k].shape == want[k].shape, k
        assert got[k].shape[1:] == want[k].shape[1:], k
    np.testing.assert_array_equal(got["counters"][[1, 2]], want["counters"][[1, 2]])
    full = j_dense(images, scene["jcal"], scene["jrec"], JMvsConfig(**CKPT_CFG))
    resumed = dense_reconstruction(images, rec.calib, rec, MvsConfig(**CKPT_CFG),
                                   device="cpu", checkpoint_dir=jck)
    assert resumed.metrics.values["mvs_resumed_at_round"] == 2
    assert resumed.num_seeds == full.num_seeds
    assert abs(resumed.num_points - full.num_points) <= 0.02 * full.num_points


# Both packages' default: sfm_tpu pads 12 images to a 16-image bucket.
CKPT_BUCKETS = {**CKPT_CFG, "shape_buckets": True}


def test_mid_mvs_state_crosses_at_default_buckets(scene, tmp_path):
    """The twin of test_mid_mvs_state_is_the_jax_packages_format with shape
    buckets on: both packages write the 16-wide state (``|nb16``, inert pad
    views) letter for letter, the port resumes from sfm_tpu's file and
    sfm_tpu from the port's, each within 2 % of sfm_tpu's uninterrupted
    run with the same seeds."""
    import sfm_tpu.mvs.pipeline as j_pipeline

    images, rec = scene["images"], scene["rec"]
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "torch")
    killed_run(j_dense, j_pipeline, 2, images, scene["jcal"], scene["jrec"],
               JMvsConfig(**CKPT_BUCKETS), checkpoint_dir=jck,
               checkpoint_every=1)
    killed_run(dense_reconstruction, t_pipeline, 2, images, rec.calib, rec,
               MvsConfig(**CKPT_BUCKETS), device="cpu", checkpoint_dir=tck,
               checkpoint_every=1)
    want, got = j_ckpt.load_mvs_state(jck), j_ckpt.load_mvs_state(tck)
    assert set(got) == set(want) and "b_c" in got
    assert str(got["fingerprint"]) == str(want["fingerprint"])
    assert str(got["fingerprint"]).endswith("|nb16")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if not k.startswith(("acc_", "b_")):  # counts differ by NCC flips
            assert got[k].shape == want[k].shape, k
        assert got[k].shape[1:] == want[k].shape[1:], k
    assert got["occupancy"].shape[0] == 16 and got["f_vis"].shape[1] == 16
    assert not got["occupancy"][12:].any() and not got["f_vis"][:, 12:].any()
    np.testing.assert_array_equal(got["counters"][[1, 2]], want["counters"][[1, 2]])
    full = j_dense(images, scene["jcal"], scene["jrec"], JMvsConfig(**CKPT_BUCKETS))
    resumed = dense_reconstruction(images, rec.calib, rec,
                                   MvsConfig(**CKPT_BUCKETS), device="cpu",
                                   checkpoint_dir=jck)
    j_resumed = j_dense(images, scene["jcal"], scene["jrec"],
                        JMvsConfig(**CKPT_BUCKETS), checkpoint_dir=tck)
    for r in (resumed, j_resumed):
        assert r.metrics.values["mvs_resumed_at_round"] == 2
        assert r.num_seeds == full.num_seeds
        assert abs(r.num_points - full.num_points) <= 0.02 * full.num_points


def test_kill_and_resume_with_buckets_is_bit_identical(scene, tmp_path):
    """With shape buckets on the port saves 16-wide and slices back to 12 on
    load: the resumed cloud is still the uninterrupted one, bit for bit; a
    state whose pad views are not inert is refused."""
    images, rec = scene["images"], scene["rec"]
    cfg = MvsConfig(**CKPT_BUCKETS)
    full = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu")
    ck = str(tmp_path / "ckpt")
    killed_run(dense_reconstruction, t_pipeline, 3, images, rec.calib, rec, cfg,
               device="cpu", checkpoint_dir=ck, checkpoint_every=1)
    state = t_ckpt.load_mvs_state(ck)
    assert state["occupancy"].shape[0] == 16 and state["b_vis"].shape[1] == 16
    resumed = dense_reconstruction(images, rec.calib, rec, cfg, device="cpu",
                                   checkpoint_dir=ck, checkpoint_every=1)
    assert resumed.metrics.values["mvs_resumed_at_round"] == 3
    for f in ("points", "colors", "normals", "scores", "refs"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f), f)
    # An occupied pad view: not a state of this input.
    state["occupancy"][14, 0, 0] = True
    t_ckpt.save_mvs_state(ck, state)
    with pytest.raises(ValueError, match="padded view"):
        dense_reconstruction(images, rec.calib, rec, cfg, device="cpu",
                             checkpoint_dir=ck)


def test_cli_resumes_from_the_jax_packages_sfm_checkpoint(scene, tmp_path, capsys):
    """sfm_tpu writes ``sfm.npz``; the port's ``--stages ba,mvs`` resumes
    from it, writes ``ba.npz``, and ``--stages mvs`` alone then resumes
    from that; with all three ported flags on."""
    pytest.importorskip("PIL")
    ds = str(tmp_path / "ring")
    _, par, spheres = synth.write_middlebury_dataset(
        ds, centers=synth.ring_rig(12), w=200, h=150, image_type="png",
        spheres=(((0.0, 0.0, 0.0), 1.0),), texture_freq_scale=1.0, seed=1,
    )
    ck, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    j_ckpt.save_sparse(j_ckpt.stage_path(ck, "sfm"), scene["jrec"])
    loaded = t_ckpt.load_sparse(os.path.join(ck, "sfm.npz"))
    np.testing.assert_array_equal(loaded.track_obs, scene["jrec"].track_obs)
    assert loaded.calib.names == tuple(scene["jcal"].names)
    args = ["-img_p", ds, "-par_p", par, "-t", "png", "--mvs_round_capacity",
            "2048", "--mvs_rounds", "8", "--out_dir", out, "--device", "cpu",
            "--checkpoint_dir", ck, "--mvs_checkpoint_every", "2"]
    assert t_main(args + ["--stages", "ba,mvs", "--refine_cameras",
                          "--enable_outlier_filter"]) == 0
    summary = json.loads(
        [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert set(summary) == {"ba_final_cost", "ba_rms_reproj_px", "mvs_seeds",
                            "mvs_points", "timers_s"}
    assert sorted(os.listdir(ck)) == ["ba.npz", "sfm.npz"]
    ba_pts, _ = read_ply(os.path.join(out, "sparse_points_ba.ply"))
    assert ba_pts.shape == (scene["jrec"].num_tracks, 3)
    dense, _ = read_ply(os.path.join(out, "all_patches.ply"))
    assert dense.shape[0] == summary["mvs_points"] > 1000
    assert np.median(synth.surface_distance(dense, spheres)) < 0.02
    # sfm_tpu reads the port's ba.npz.
    back = j_ckpt.load_sparse(os.path.join(ck, "ba.npz"))
    np.testing.assert_allclose(back.world, ba_pts, atol=1e-5)
    # --stages mvs alone: from ba.npz, the same dense cloud.
    out2 = str(tmp_path / "out2")
    assert t_main(args[:args.index("--out_dir")] + ["--out_dir", out2]
                  + args[args.index("--out_dir") + 2:]
                  + ["--stages", "mvs", "--enable_outlier_filter"]) == 0
    dense2, _ = read_ply(os.path.join(out2, "all_patches.ply"))
    np.testing.assert_array_equal(dense2, dense)
    # Without a checkpoint there is nothing to resume from.
    assert t_main(["-img_p", ds, "-par_p", par, "-t", "png", "--device", "cpu",
                   "--out_dir", out2, "--stages", "mvs"]) == 2
    assert "no reconstruction" in capsys.readouterr().err


@pytest.fixture(scope="module")
def own_pipeline(scene):
    """The port's own sfm -> ba -> mvs (the bounds of
    tests/test_pipeline_synthetic.py)."""
    images = scene["images"]
    calib = scene["rec"].calib
    cfg = PipelineConfig(
        features=FeatureConfig(max_corners=512, max_matches=256),
        ba=BaConfig(dtype="float64"),
        mvs=MvsConfig(round_capacity=CAP, max_rounds=ROUNDS, max_patches=20000),
        runtime=RuntimeConfig(device="cpu"),
    )
    recon = structure_from_motion(images, calib, cfg)
    recon, info = bundle_adjust(recon, cfg.ba, device="cpu")
    dense = dense_reconstruction(images, calib, recon, cfg.mvs, scale=1.0,
                                 device="cpu")
    return recon, info, dense


def test_own_sparse_points_on_sphere(own_pipeline):
    recon, _, _ = own_pipeline
    assert recon.num_tracks > 50
    r_err = np.abs(np.linalg.norm(recon.world, axis=1) - 1.0)
    assert np.median(r_err) < 0.01
    assert np.percentile(r_err, 95) < 0.05


def test_own_ba_tightens_reprojection(own_pipeline):
    recon, info, _ = own_pipeline
    assert recon.rms_reprojection_error() < 0.3
    assert info["iterations"] >= 1


def test_own_dense_points_on_sphere(own_pipeline):
    _, _, dense = own_pipeline
    assert dense.num_points > 1000
    r_err = np.abs(np.linalg.norm(dense.points, axis=1) - 1.0)
    assert np.median(r_err) < 0.02
    assert np.percentile(r_err, 90) < 0.06


def test_own_dense_normals_point_outward(own_pipeline):
    _, _, dense = own_pipeline
    dots = np.einsum("ij,ij->i", dense.normals, dense.points)
    assert (dots > 0).mean() > 0.9
