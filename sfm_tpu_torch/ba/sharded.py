"""Multi-device bundle adjustment over a ``parallel.DataMesh``.

Counterpart of ``sfm_tpu/ba/sharded.py``: observations -- the only
O(problem size) axis -- are split over the mesh's shards; cameras and points
are replicated.  The JAX package runs its whole LM loop inside
``shard_map`` with every reduction a ``psum``; here the one LM loop of
``ba/solver.py`` takes the mesh and sums each shard's partials with
``mesh.psum``.

The joint solve's dense reduced camera system needs every observation of
a point on one shard (its same-point pairs are then local, and the shards'
partial S's sum to the exact S): ``shard_problem(track_aligned=True)``.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.ba.solver import _OBS_FIELDS, solve_lm


def shard_problem(
    problem: BAProblem, num_shards: int, track_aligned: bool = False
) -> BAProblem:
    """Pad the observation axis so it splits evenly across shards.

    Padded rows get mask=False and index 0, like ``build_problem``'s
    padding, so they are inert.  ``track_aligned=True`` cuts only at track
    boundaries (every observation of a point on one shard, each shard padded
    to the longest), the layout the JAX package's dense-Schur joint solve
    needs; the same index arrays and masks as ``sfm_tpu``'s.
    """
    o = problem.obs_2d.shape[0]
    if track_aligned:
        po_all = problem.point_idx.cpu().numpy()
        grouped = np.argsort(po_all, kind="stable")
        po = po_all[grouped]
        cuts = np.flatnonzero(np.diff(po) != 0) + 1
        bounds = np.concatenate([[0], cuts, [o]])
        target = -(-o // num_shards)
        starts = [0]
        for s in range(1, num_shards):
            pos = bounds[np.searchsorted(bounds, s * target)]
            starts.append(max(int(pos), starts[-1]))
        starts.append(o)
        lens = np.diff(starts)
        per = int(lens.max())
        idx = np.zeros((num_shards, per), np.int64)
        ok = np.zeros((num_shards, per), bool)
        for s in range(num_shards):
            idx[s, : lens[s]] = np.arange(starts[s], starts[s] + lens[s])
            ok[s, : lens[s]] = True
        dev = problem.obs_2d.device
        idx = torch.from_numpy(grouped[idx.reshape(-1)]).to(dev)
        ok = torch.from_numpy(ok.reshape(-1)).to(dev)
        return BAProblem(
            cams=problem.cams,
            points=problem.points,
            cam_idx=problem.cam_idx[idx] * ok,
            point_idx=problem.point_idx[idx] * ok,
            obs_2d=problem.obs_2d[idx] * ok[:, None],
            mask=problem.mask[idx] & ok,
        )
    per = -(-o // num_shards)
    pad = per * num_shards - o
    if pad == 0:
        return problem

    def padded(a):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])

    return BAProblem(
        cams=problem.cams, points=problem.points,
        **{f: padded(getattr(problem, f)) for f in _OBS_FIELDS},
    )


def solve_lm_sharded(problem: BAProblem, mesh, **solve_kw):
    """``solve_lm`` over ``mesh`` (a ``parallel.DataMesh``), the
    observations padded by ``shard_problem`` to split evenly, as ``sfm_tpu``
    cuts them: at track boundaries for the dense joint solve
    (``optimize_cameras`` and ``pair_span > 0``), anywhere otherwise.
    ``problem`` lies on the lead device.  Takes ``solve_lm``'s keywords."""
    dense = (solve_kw.get("optimize_cameras", True)
             and solve_kw.get("pair_span", 0) > 0)
    return solve_lm(
        shard_problem(problem, mesh.size, track_aligned=dense), mesh=mesh,
        **solve_kw,
    )
