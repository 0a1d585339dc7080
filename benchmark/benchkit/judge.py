"""The comparison that decides ``correct``: a pass's outputs against the
plain reference's, stage by stage.

The reference's SfM works from the same images, cameras and RANSAC draws
as the pass; its BA and MVS work from the pass's own tracks, so each stage
is judged on its own input.  Every number is a share or a relative gap, 0
where the two agree:

- ``tracks_differ``: the share of tracks (of the larger set) that the
  other side has no track for with the same observations (image, x, y)
  and a point within ``POINT_TOL`` (scene units; the sphere's radius is
  1);
- ``ba_points_moved``: the share of the pass's tracks whose refined point
  lies more than ``POINT_TOL`` from the reference BA's on the same tracks;
- ``ba_rms_gap``: |rms - rms_ref| / rms_ref, rms being the reprojection
  error of the refined points over the pass's tracks, worked out here in
  float64 against the calibration;
- ``dense_differ``: the larger, over the two directions, of the share of
  dense points whose nearest point of the other cloud (the reference's
  grown from the same tracks) lies more than ``POINT_TOL`` away or has a
  normal more than ``NORMAL_TOL`` apart.

The counts and the widest point gaps are printed beside them but judge
nothing.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import sfmref

POINT_TOL = 1e-5
NORMAL_TOL = 1e-4


def _track_keys(offsets, obs):
    """Each track's observations, sorted, as bytes."""
    keys = []
    for a, b in zip(offsets[:-1], offsets[1:]):
        rows = obs[a:b]
        rows = rows[np.lexsort(rows.T[::-1])]
        keys.append(np.ascontiguousarray(rows, np.int32).tobytes())
    return keys


def _nearest(a_pts, b_pts, device, block=4096):
    """For each row of ``a_pts`` (A, 3) the index of its nearest row of
    ``b_pts`` (B, 3) and the distance, in float64 (whose matrix-product
    form errs by ~1e-8 at these magnitudes, far below ``POINT_TOL``)."""
    a = torch.from_numpy(np.asarray(a_pts, np.float64)).to(device)
    b = torch.from_numpy(np.asarray(b_pts, np.float64)).to(device)
    idx, dist = [], []
    for s in range(0, a.shape[0], block):
        d = torch.cdist(a[s:s + block], b,
                        compute_mode="use_mm_for_euclid_dist")
        v, i = d.min(dim=1)
        idx.append(i)
        dist.append(v)
    return torch.cat(idx).cpu().numpy(), torch.cat(dist).cpu().numpy()


def _unmatched_share(pa, na, pb, nb, device):
    if pa.shape[0] == 0:
        return 0.0
    if pb.shape[0] == 0:
        return 1.0
    i, d = _nearest(pa, pb, device)
    dn = np.linalg.norm(na.astype(np.float64) - nb[i].astype(np.float64),
                        axis=1)
    return float(np.mean((d > POINT_TOL) | (dn > NORMAL_TOL)))


def reprojection_rms(world, offsets, obs, K, R, t) -> float:
    """The rms pixel error of ``world`` (T, 3) over the tracks'
    observations (image, x, y) with pinhole cameras K, R, t (float64)."""
    if obs.shape[0] == 0:
        return float("nan")
    point = np.repeat(np.arange(world.shape[0]), np.diff(offsets))
    cam = obs[:, 0]
    pc = np.einsum("oij,oj->oi", R[cam], world[point]) + t[cam]
    uv = pc[:, :2] / pc[:, 2:3]
    k = K[cam]
    u = k[:, 0, 0] * uv[:, 0] + k[:, 0, 1] * uv[:, 1] + k[:, 0, 2]
    v = k[:, 1, 1] * uv[:, 1] + k[:, 1, 2]
    e2 = (u - obs[:, 1]) ** 2 + (v - obs[:, 2]) ** 2
    return float(np.sqrt(np.mean(e2)))


def compare(prog: dict, ref_sfm: dict, ref_next: dict, cams, device) -> dict:
    """The numbers of one pass (see the module's docstring) and the counts
    beside them.  ``ref_sfm``: the reference's tracks from the images;
    ``ref_next``: its BA (``ba_world``) and MVS (``dense_points``,
    ``dense_normals``) from the pass's own tracks; ``cams``: the scene's
    float64 (K, R, t)."""
    ka = _track_keys(prog["offsets"], prog["obs"])
    kb = _track_keys(ref_sfm["offsets"], ref_sfm["obs"])
    where = {k: i for i, k in enumerate(kb)}
    pairs = np.array([(i, where[k]) for i, k in enumerate(ka) if k in where],
                     np.int64).reshape(-1, 2)
    gap = np.linalg.norm(prog["world"][pairs[:, 0]]
                         - ref_sfm["world"][pairs[:, 1]], axis=1)
    same = int(np.sum(gap <= POINT_TOL))
    n_max = max(len(ka), len(kb))
    out = {"tracks": len(ka), "tracks_ref": len(kb),
           "tracks_differ": 1.0 - same / n_max if n_max else 0.0,
           "sfm_point_gap_max": float(gap.max()) if gap.size else 0.0}
    moved = np.linalg.norm(prog["ba_world"] - ref_next["ba_world"], axis=1)
    out["ba_points_moved"] = float(np.mean(moved > POINT_TOL)) \
        if moved.size else 0.0
    out["ba_point_gap_max"] = float(moved.max()) if moved.size else 0.0
    rms = reprojection_rms(prog["ba_world"], prog["offsets"], prog["obs"],
                           *cams)
    rms_ref = reprojection_rms(ref_next["ba_world"], prog["offsets"],
                               prog["obs"], *cams)
    out["ba_rms_px"], out["ba_rms_px_ref"] = rms, rms_ref
    out["ba_rms_gap"] = abs(rms - rms_ref) / rms_ref if prog["obs"].size \
        else 0.0
    if "dense_points" in ref_next:
        pa, na = prog["dense_points"], prog["dense_normals"]
        pb, nb = ref_next["dense_points"], ref_next["dense_normals"]
        out["dense_points"] = int(pa.shape[0])
        out["dense_points_ref"] = int(pb.shape[0])
        out["dense_differ"] = max(_unmatched_share(pa, na, pb, nb, device),
                                  _unmatched_share(pb, nb, pa, na, device))
    return out


def reference_next(images, cams, tracks, params, job, device,
                   control=False) -> dict:
    """The reference's BA and (with the mvs stage) MVS from ``tracks``."""
    out = {"ba_world": sfmref.ba_stage(*cams, tracks, params, job, device,
                                       control)}
    if "mvs" in job["stages"]:
        out["dense_points"], out["dense_normals"] = sfmref.mvs_stage(
            images, *cams, tracks, params, job, device, control)
    return out


def tracks_digest(out: dict) -> bytes:
    """Identity of a pass's tracks, to work out the reference's later
    stages once for passes that made the same tracks."""
    h = hashlib.sha1()
    for k in ("world", "offsets", "obs"):
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.digest()


def worst(readings: list) -> dict:
    """The largest of each number over several passes' readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, checks): every limited number present, finite and at most
    its limit; ``checks`` maps each to {"value", "limit"}."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
