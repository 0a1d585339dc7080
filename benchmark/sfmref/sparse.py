"""Plain sparse reconstruction of the reference: grayscale, Harris corners,
patch descriptors, mutual-ratio matching, batched RANSAC on the weighted
8-point solver, two-view triangulation with its gates, and the track store
that merges the pairs into tracks.

A frozen copy of the plain paths of ``sfm_tpu_torch`` at commit bfc7f14:
``io/images.py`` (``to_gray``, ``gray_tensor``), ``ops/harris.py``
(``_harris_math``, ``detect_corners``), ``ops/patches.py``,
``ops/ncc.py`` (``ncc_scores``), ``features/frontend.py`` (its
``kernels=False`` branch), ``features/matching.py``, ``sfm/ransac.py``,
``sfm/tracks.py`` (its pure-Python store) and ``sfm/pipeline.py`` (one
device, no mesh).  The RANSAC draws are handed in as uniforms, as the
program draws them from its seed.  Plain PyTorch and NumPy; imports
nothing of the program.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from sfmref.geometry import (
    eight_point,
    project_pinhole,
    projection_matrix,
    refine_triangulation,
    sampson_distance,
    triangulate_dlt,
)

_INT32_MIN = -(2 ** 31)
_EPS = 1e-8
_NEG = -2.0  # below any valid NCC score (range [-1, 1])


def gray_stack(images: np.ndarray, device) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> float32 (N, H, W) on ``device``: BT.601
    weights in float32 on the host, rounded to uint8, converted there."""
    img = images.astype(np.float32)
    gray = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return torch.from_numpy(np.rint(gray).astype(np.uint8)).to(device).float()


def _shift(img, dy, dx):
    """Shift a (..., H, W) image by (dy, dx), zero-filled."""
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad(img, (1, 1, 1, 1))
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel(gray):
    tl = _shift(gray, -1, -1)
    tc = _shift(gray, -1, 0)
    tr = _shift(gray, -1, 1)
    ml = _shift(gray, 0, -1)
    mr = _shift(gray, 0, 1)
    bl = _shift(gray, 1, -1)
    bc = _shift(gray, 1, 0)
    br = _shift(gray, 1, 1)
    ix = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    iy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return ix, iy


def _box3(img):
    return (
        _shift(img, -1, -1) + _shift(img, -1, 0) + _shift(img, -1, 1)
        + _shift(img, 0, -1) + img + _shift(img, 0, 1)
        + _shift(img, 1, -1) + _shift(img, 1, 0) + _shift(img, 1, 1)
    )


def _harris_math(gray, k):
    """Plain version of K1: Sobel, 3x3 box sums, R = det - k trace^2.

    Rounds as the JAX package's ``_harris_math`` does once XLA:CPU contracts
    it into fused multiply-adds: det = fma(sxx, syy, -round(sxy^2)) and
    R = fma(-round(k trace), trace, det).  Each fma is evaluated in float64
    and rounded once to float32; for integer gray values (0..255) the
    float64 intermediates are exact, so this is the fma bit for bit (and
    what kernel K1 computes with ``__fmaf_rn``).
    """
    ix, iy = _sobel(gray)
    sxx = _box3(ix * ix)
    syy = _box3(iy * iy)
    sxy = _box3(ix * iy)
    det = (sxx.double() * syy.double() - (sxy * sxy).double()).float()
    trace = sxx + syy
    kt = k * trace
    return (det.double() - kt.double() * trace.double()).float()


def _running_max(x, r, dim):
    """Max over a centred window of 2r+1 along ``dim``, INT32_MIN padding."""
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [r, r]
    p = F.pad(x, pad, value=_INT32_MIN)
    n = x.shape[dim]
    out = p.narrow(dim, 0, n)
    for d in range(1, 2 * r + 1):
        out = torch.maximum(out, p.narrow(dim, d, n))
    return out


def detect_corners(
    gray,
    max_corners: int = 4096,
    nms_radius: int = 4,
    rel_threshold: float = 0.01,
    border: int = 0,
    k: float = 0.04,
):
    """Detect top-K Harris corners per image.

    Args:
      gray: (N, H, W) float32 grayscale stack.
      max_corners: corner capacity K per image.
      nms_radius: non-max-suppression radius (pixels).
      rel_threshold: keep responses > rel_threshold * per-image max.
      border: reject corners within this many pixels of the edge.

    Returns:
      corners (N, K, 2) int32 (x, y) sorted by response; valid (N, K) bool;
      response (N, H, W) float32.
    """
    resp = _harris_math(gray, k)
    n, h, w = resp.shape
    win = 2 * nms_radius + 1
    # NMS on per-pixel-unique keys: the f32 response bitcast to int32 (order
    # preserving for non-negative floats) with its low bits replaced by a
    # pixel id, so equal responses break ties by id and each window has one
    # peak.  Same key as the JAX package, bit for bit.
    id_bits = max(((win - 1) * (w + 1) + 1).bit_length(), 1)
    if id_bits > 18:
        raise ValueError(
            f"NMS tie-break id field needs {id_bits} bits for width {w} "
            f"(nms_radius={nms_radius}); more than 18 would corrupt the "
            "response ordering"
        )
    id_mask = (1 << id_bits) - 1
    pos = torch.clamp_min(resp, 0.0) + 1e-30
    bits = pos.view(torch.int32)
    dev = resp.device
    pix_id = (
        torch.arange(h, dtype=torch.int32, device=dev)[:, None] * w
        + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    )
    key = (bits & ~id_mask) | (pix_id & id_mask)
    pooled = _running_max(_running_max(key, nms_radius, 1), nms_radius, 2)
    peak = key == pooled
    maxval = torch.amax(resp, dim=(1, 2), keepdim=True)
    mask = peak & (resp > rel_threshold * maxval)
    if border > 0:
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        mask = mask & inb[None]
    scored = torch.where(mask, resp, torch.full_like(resp, float("-inf")))
    # Stable descending sort = jax.lax.top_k's order: among equal values
    # (the many -inf slots) the lower index comes first.
    vals, idx = torch.sort(scored.reshape(n, h * w), dim=1, descending=True,
                           stable=True)
    vals = vals[:, :max_corners]
    idx = idx[:, :max_corners]
    corners = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    return corners, torch.isfinite(vals), resp
def extract_patches(gray, corners, wid: int = 5):
    """Gather square patches around integer corner coordinates.

    Args:
      gray: (N, H, W) grayscale stack.
      corners: (N, K, 2) int (x, y) positions.
      wid: half-width; patch side = 2*wid+1.

    Returns:
      patches (N, K, (2*wid+1)**2) float32, row-major; inbounds (N, K) bool.
    """
    n, h, w = gray.shape
    k = corners.shape[1]
    side = 2 * wid + 1
    x = corners[..., 0].long()
    y = corners[..., 1].long()
    inb = (x >= wid) & (x < w - wid) & (y >= wid) & (y < h - wid)
    # The (image, row) axes fold into one.  Out-of-border corners (inb
    # False, masked by the caller) read defined values: starts wrap when
    # negative and then clamp, as jax.lax.dynamic_slice's do, so even their
    # patches equal the JAX package's.
    flat = gray.reshape(n * h, w)
    img = torch.arange(n, device=gray.device).repeat_interleave(k)

    def start(s, size):
        return torch.where(s < 0, s + size, s).clamp(0, size - side)

    row = start(img * h + y.reshape(-1) - wid, n * h)
    col = start(x.reshape(-1) - wid, w)
    off = torch.arange(side, device=gray.device)
    patches = flat[(row[:, None] + off)[:, :, None], (col[:, None] + off)[:, None, :]]
    return patches.reshape(n, k, side * side).float(), inb


def normalize_descriptors(patches):
    """Zero-mean, unit-L2 normalize flattened patches (last axis).

    The mean is the sum times the f32 reciprocal of the length, as XLA
    computes ``jnp.mean`` (a constant patch then normalizes to the JAX
    package's values too).
    """
    mean = patches.sum(dim=-1, keepdim=True) * (1.0 / patches.shape[-1])
    c = patches - mean
    norm = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True))
    return c / torch.clamp_min(norm, _EPS)
def ncc_scores(desc1, desc2):
    """(..., K1, D) x (..., K2, D) -> (..., K1, K2) correlation, f32."""
    return torch.matmul(desc1, desc2.transpose(-1, -2))


@dataclass
class MatchResult:
    """Static-capacity match sets.

    idx1/idx2: (..., M) int32 indices into each FeatureSet's corners;
    valid: (..., M) bool; count: (...,) int32 number of valid matches.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    lowe_ratio: float = 0.8,
    max_matches: int = 2048,
    mutual_check: bool = True,
) -> MatchResult:
    """Match (..., K1, D) against (..., K2, D); indices padded to max_matches."""
    s = ncc_scores(desc1, desc2)  # (..., K1, K2)
    s = torch.where(valid1[..., :, None] & valid2[..., None, :], s,
                    torch.full_like(s, _NEG))
    k1, k2 = s.shape[-2], s.shape[-1]
    # argmax returns the first maximal index in both frameworks.
    best = torch.amax(s, dim=-1)
    j_best = torch.argmax(s, dim=-1)
    cols = torch.arange(k2, device=s.device)
    masked = torch.where(cols == j_best[..., None], torch.full_like(s, _NEG), s)
    second = torch.amax(masked, dim=-1)
    r2 = lowe_ratio * lowe_ratio
    d1 = torch.clamp_min(1.0 - best, 0.0)
    d2 = torch.clamp_min(1.0 - second, 0.0)
    accept = (d1 < r2 * d2) & valid1 & (best > _NEG + 1.0)
    if mutual_check:
        col_best = torch.argmax(s, dim=-2)  # (..., K2)
        rows = torch.arange(k1, device=s.device)
        accept = accept & (torch.gather(col_best, -1, j_best) == rows)
    score = torch.where(accept, best, torch.full_like(best, _NEG))
    # Stable descending sort = jax.lax.top_k's tie order (lower index first).
    vals, rows = torch.sort(score, dim=-1, descending=True, stable=True)
    m = min(max_matches, k1)
    vals, rows = vals[..., :m], rows[..., :m]
    if m < max_matches:
        pad = [0, max_matches - m]
        vals = torch.nn.functional.pad(vals, pad, value=_NEG)
        rows = torch.nn.functional.pad(rows, pad, value=0)
    ok = vals > _NEG
    return MatchResult(
        idx1=rows.to(torch.int32),
        idx2=torch.gather(j_best, -1, rows).to(torch.int32),
        valid=ok,
        count=ok.sum(dim=-1, dtype=torch.int32),
    )


def matched_points(corners1, corners2, match: MatchResult):
    """(..., M, 2) float32 pixel coordinates of each match in both images,
    gathered from (..., K, 2) corners by ``match.idx1`` / ``match.idx2``."""

    def take(cor, idx):
        idx = idx.long()
        return torch.gather(cor, -2, idx[..., None].expand(*idx.shape, 2)).float()

    return take(corners1, match.idx1), take(corners2, match.idx2)


def match_pair_gate(match: MatchResult, min_matches: int = 8):
    """(...,) bool: pairs with at least ``min_matches`` matches (the
    reference skips the others)."""
    return match.count >= min_matches
def samples_from_uniforms(valid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map uniforms u (..., H*8) in [0, 1) to (..., H, 8) indices of valid
    rows of ``valid`` (..., M).  A batch row without valid entries draws
    index 0 (its hypotheses score nothing: every correspondence is
    invalid)."""
    batch = valid.shape[:-1]
    u = u.to(valid.device)
    n_valid = valid.sum(dim=-1, keepdim=True)
    r = torch.minimum((u * n_valid).long(), torch.clamp_min(n_valid - 1, 0))
    # The r-th valid row: first position whose running count exceeds r.
    cum = torch.cumsum(valid.long(), dim=-1)
    idx = torch.searchsorted(cum.contiguous(), r + 1)
    idx = torch.where(n_valid > 0, idx, torch.zeros_like(idx))
    return idx.reshape(*batch, u.shape[-1] // 8, 8)


def ransac_fundamental(
    pts1,
    pts2,
    valid,
    samples: torch.Tensor,
    threshold_px: float = 2.0,
    refit: bool = True,
):
    """Robustly estimate F from padded correspondences.

    Args:
      pts1, pts2: (..., M, 2) float correspondence coordinates (padded).
      valid: (..., M) bool validity of each correspondence.
      samples: (..., H, 8) int64 correspondence indices, one row per
        hypothesis.
      threshold_px: inlier threshold on sqrt(Sampson distance), px.
      refit: re-estimate F from all inliers of the best hypothesis.

    Returns (F (..., 3, 3), inliers (..., M) bool, num_inliers (...,) int32).
    """
    samples = samples.to(pts1.device).long()
    m = pts1.shape[-2]
    h = samples.shape[-2]
    weights = torch.zeros((*samples.shape[:-1], m), dtype=pts1.dtype,
                          device=pts1.device)
    weights.scatter_(-1, samples, 1.0)  # (..., H, M) one-hot minimal samples
    P1 = pts1[..., None, :, :]
    P2 = pts2[..., None, :, :]
    F_h = eight_point(
        P1.expand(*pts1.shape[:-2], h, m, 2),
        P2.expand(*pts2.shape[:-2], h, m, 2),
        weights,
    )  # (..., H, 3, 3)
    d = sampson_distance(F_h, P1, P2)  # (..., H, M)
    thr2 = threshold_px * threshold_px
    inl = (d < thr2) & valid[..., None, :]
    best = torch.argmax(inl.sum(dim=-1), dim=-1)  # first of the ties
    F = torch.gather(
        F_h, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3)
    )[..., 0, :, :]
    inliers = torch.gather(
        inl, -2, best[..., None, None].expand(*best.shape, 1, m)
    )[..., 0, :]
    if refit:
        F_refit = eight_point(pts1, pts2, inliers.to(pts1.dtype))
        inl_refit = (sampson_distance(F_refit, pts1, pts2) < thr2) & valid
        # Keep the refit only if it does not lose inliers.
        better = inl_refit.sum(dim=-1) >= inliers.sum(dim=-1)
        F = torch.where(better[..., None, None], F_refit, F)
        inliers = torch.where(better[..., None], inl_refit, inliers)
    return F, inliers, inliers.sum(dim=-1, dtype=torch.int32)


def descriptor_values(desc, fp8: bool = False):
    """Normalized float32 descriptors rounded to what the program's
    sampler (kernel K2) writes, bf16, and returned as float32; ``fp8``
    rounds them to float8 e4m3 first, the control's precision."""
    if fp8:
        desc = desc.to(torch.float8_e4m3fn)
    return desc.to(torch.bfloat16).float()


def detect_and_describe(gray, fc: dict, fp8: bool = False):
    """(N, H, W) float32 gray -> (corners (N, K, 2) int32, valid (N, K),
    descriptors (N, K, D) zero-mean unit-norm bf16 values as float32,
    zero where invalid)."""
    corners, valid, _ = detect_corners(
        gray,
        max_corners=fc["max_corners"],
        nms_radius=fc["nms_radius"],
        rel_threshold=fc["harris_rel_threshold"],
        border=fc["desc_wid"] + 1,
        k=fc["harris_k"],
    )
    patches, inb = extract_patches(gray, corners, wid=fc["desc_wid"])
    desc = descriptor_values(normalize_descriptors(patches), fp8)
    valid = valid & inb
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    return corners, valid, desc


def pair_schedule(n: int, mode: str):
    """'sequence': chained (i-1, i) pairs; 'combination': all C(n, 2)."""
    if mode == "sequence":
        return [(i - 1, i) for i in range(1, n)]
    if mode == "combination":
        return [(i, j) for i in range(n) for j in range(i + 1, n)]
    raise ValueError(f"unknown pair mode: {mode}")


def pair_geometry(feats, ia, ib, K, R, t, params: dict, uniforms):
    """The per-pair step for a batch of pairs: match, RANSAC from the
    given uniforms, triangulate, refine, gate.  Returns (geo (P, M, 8)
    [p1 | p2 | X | ok], stats (P, 4) [matches, inliers, gated, err_sum])."""
    fc, rc, sc = params["features"], params["ransac"], params["sfm"]
    corners, fvalid, desc = feats
    m = match_descriptors(
        desc[ia], fvalid[ia], desc[ib], fvalid[ib],
        lowe_ratio=fc["lowe_ratio"], max_matches=fc["max_matches"],
        mutual_check=fc["mutual_check"],
    )
    p1, p2 = matched_points(corners[ia], corners[ib], m)
    valid = m.valid & match_pair_gate(m, fc["min_matches"])[:, None]
    samples = samples_from_uniforms(valid, uniforms)
    _, inliers, n_inl = ransac_fundamental(
        p1, p2, valid, samples=samples,
        threshold_px=rc["inlier_threshold_px"], refit=rc["refit_on_inliers"],
    )
    P = projection_matrix(K, R, t)
    Pab = torch.stack([P[ia], P[ib]], dim=1)
    Pm = Pab[:, None].expand(-1, p1.shape[1], -1, -1, -1)
    pix = torch.stack([p1, p2], dim=2)
    X, w = triangulate_dlt(Pm, pix)
    X = refine_triangulation(Pm, pix, X)
    nondegenerate = w.abs() > 1e-9

    def err(Kc, Rc, tc, p):
        proj = project_pinhole(X, Kc[:, None], Rc[:, None], tc[:, None])
        d = proj - p
        return torch.sqrt(torch.sum(d * d, dim=-1))

    err_a = err(K[ia], R[ia], t[ia], p1)
    err_b = err(K[ib], R[ib], t[ib], p2)
    gate = (err_a <= sc["max_reprojection_error_px"]) & (
        err_b <= sc["max_reprojection_error_px"])
    ok = inliers & nondegenerate & gate
    geo = torch.cat([p1, p2, X.float(), ok.float()[..., None]], dim=-1)
    stats = torch.stack([m.count.float(), n_inl.float(),
                         ok.sum(dim=-1).float()], dim=-1)
    return geo, stats


# Floats one pair holds at the peak of the pair step (RANSAC's (H, M)
# tensors, matching's (K, K) scores): the program's own sizing rule, so
# the reference's chunks hold what the program's do.
_HM_FLOATS = 32
_KK_FLOATS = 6


def pairs_per_chunk(params: dict, device: torch.device) -> int:
    """Pairs in one chunk of the pair step: a quarter of the device's
    memory (the host's on the CPU) over one pair's working bytes."""
    fc = params["features"]
    h, m, k = params["ransac"]["num_hypotheses"], fc["max_matches"], fc["max_corners"]
    d = (2 * fc["desc_wid"] + 1) ** 2
    per_pair = 4 * (max(_HM_FLOATS * h * m, _KK_FLOATS * k * k) + 2 * k * d
                    + 16 * m)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return max(1, (total // 4) // per_pair)


class _Track:
    __slots__ = ("p", "obs", "valid", "alive")

    def __init__(self, p, obs):
        self.p = p
        self.obs = list(obs)
        self.valid = True
        self.alive = True


class TrackStore:
    """Union of two-view matches into tracks, pair by pair in schedule
    order: an observation (image, x, y) belongs to at most one track; a
    match joins or merges tracks while the new point lies within
    ``threshold`` of the track's first point, else invalidates them."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.index = {}
        self.tracks = []

    def _close(self, tid, p):
        a = self.tracks[tid].p
        return math.sqrt((a[0] - p[0]) ** 2 + (a[1] - p[1]) ** 2
                         + (a[2] - p[2]) ** 2) < self.threshold

    def _attach(self, tid, key):
        obs = self.tracks[tid].obs
        if key not in obs:
            obs.append(key)

    def add_pairs(self, obs_a, obs_b, pts):
        for ka, kb, p in zip(map(tuple, obs_a), map(tuple, obs_b), pts):
            i1 = self.index.get(ka, -1)
            i2 = self.index.get(kb, -1)
            tr = self.tracks
            if i1 < 0 and i2 < 0:
                tid = len(tr)
                tr.append(_Track(tuple(p), [ka, kb]))
                self.index[ka] = tid
                self.index[kb] = tid
            elif i1 < 0:
                if tr[i2].valid and self._close(i2, p):
                    self.index[ka] = i2
                    self._attach(i2, ka)
                    self._attach(i2, kb)
                else:
                    tr[i2].valid = False
            elif i2 < 0:
                if tr[i1].valid and self._close(i1, p):
                    self.index[kb] = i1
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            elif i1 == i2:
                if tr[i1].valid and self._close(i1, p):
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            else:
                if tr[i1].valid and tr[i2].valid and self._close(i1, p):
                    for k in tr[i2].obs:
                        self.index[k] = i1
                        self._attach(i1, k)
                    tr[i2].alive = False
                    tr[i2].obs = []
                else:
                    tr[i1].valid = False
                    tr[i2].valid = False

    def export(self):
        """Valid tracks in creation order: (world (T, 3) f64, offsets
        (T+1,) i64, obs (O, 3) i32)."""
        world, offsets, obs = [], [0], []
        for t in self.tracks:
            if not (t.alive and t.valid):
                continue
            world.append(t.p)
            obs.extend(t.obs)
            offsets.append(len(obs))
        return (np.asarray(world, np.float64).reshape(-1, 3),
                np.asarray(offsets, np.int64),
                np.asarray(obs, np.int32).reshape(-1, 3))


def sparse_reconstruction(gray, K, R, t, params: dict, pair_mode: str,
                          uniforms, fp8: bool = False):
    """Tracks of the (N, H, W) float32 gray stack with f32 cameras K, R, t
    on its device; ``uniforms`` (P, H*8) float64 are the RANSAC draws of
    the schedule's pairs.  Returns (world, offsets, obs) as
    ``TrackStore.export``."""
    device = gray.device
    n = gray.shape[0]
    feats = detect_and_describe(gray, params["features"], fp8)
    pairs = pair_schedule(n, pair_mode)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=device)
    step = pairs_per_chunk(params, device)
    geo = []
    for c in range(0, len(pairs), step):
        g, _ = pair_geometry(feats, ia[c:c + step], ib[c:c + step], K, R, t,
                             params, uniforms[c:c + step].to(device))
        geo.append(g.cpu().numpy())
    geo = np.concatenate(geo)
    p1 = geo[..., 0:2].astype(np.int32)
    p2 = geo[..., 2:4].astype(np.int32)
    X = geo[..., 4:7].astype(np.float64)
    ok = geo[..., 7] > 0.5
    store = TrackStore(params["sfm"]["track_merge_threshold"])
    for pi, (a, b) in enumerate(pairs):
        sel = ok[pi]
        if not sel.any():
            continue
        cnt = int(sel.sum())
        obs_a = np.concatenate([np.full((cnt, 1), a, np.int32), p1[pi][sel]], 1)
        obs_b = np.concatenate([np.full((cnt, 1), b, np.int32), p2[pi][sel]], 1)
        store.add_pairs(obs_a, obs_b, X[pi][sel])
    return store.export()
