"""Feature-track store: merging two-view matches into multi-view tracks.

The one inherently sequential, hash-based stage of the pipeline; it runs
on the host and consumes whole per-pair match batches.  Two backends with
identical semantics, as in ``sfm_tpu/sfm/tracks.py`` (see
``native/trackstore.cpp`` for the case analysis):

- the C++ union-find hash store, compiled from ``native/trackstore.cpp``
  into the port's build directory at first use (utils/build.py);
- a pure-Python mirror, used where no C++ compiler is installed, and as the
  reference the native store is tested against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np

from sfm_tpu_torch.utils.build import cxx_available, trackstore_library


class _PyTrack:
    __slots__ = ("p", "obs", "valid", "alive")

    def __init__(self, p, obs):
        self.p = p
        self.obs = list(obs)
        self.valid = True
        self.alive = True


class _PyBackend:
    """Pure-Python mirror of native/trackstore.cpp."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.index = {}
        self.tracks = []

    def _check(self, tid, p):
        a = self.tracks[tid].p
        return (
            math.sqrt(
                (a[0] - p[0]) ** 2 + (a[1] - p[1]) ** 2 + (a[2] - p[2]) ** 2
            )
            < self.threshold
        )

    def _attach(self, tid, key):
        obs = self.tracks[tid].obs
        if key not in obs:
            obs.append(key)

    def add_pairs(self, obs_a, obs_b, pts):
        for ka, kb, p in zip(
            map(tuple, obs_a), map(tuple, obs_b), pts
        ):
            i1 = self.index.get(ka, -1)
            i2 = self.index.get(kb, -1)
            tr = self.tracks
            if i1 < 0 and i2 < 0:
                tid = len(tr)
                tr.append(_PyTrack(tuple(p), [ka, kb]))
                self.index[ka] = tid
                self.index[kb] = tid
            elif i1 < 0:
                if tr[i2].valid and self._check(i2, p):
                    self.index[ka] = i2
                    self._attach(i2, ka)
                    self._attach(i2, kb)
                else:
                    tr[i2].valid = False
            elif i2 < 0:
                if tr[i1].valid and self._check(i1, p):
                    self.index[kb] = i1
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            elif i1 == i2:
                if tr[i1].valid and self._check(i1, p):
                    self._attach(i1, ka)
                    self._attach(i1, kb)
                else:
                    tr[i1].valid = False
            else:
                if tr[i1].valid and tr[i2].valid and self._check(i1, p):
                    for k in tr[i2].obs:
                        self.index[k] = i1
                        self._attach(i1, k)
                    tr[i2].alive = False
                    tr[i2].obs = []
                else:
                    tr[i1].valid = False
                    tr[i2].valid = False

    def info(self):
        nt = no = 0
        for t in self.tracks:
            if t.alive and t.valid:
                nt += 1
                no += len(t.obs)
        return nt, no

    def export(self):
        world, offsets, obs = [], [0], []
        for t in self.tracks:
            if not (t.alive and t.valid):
                continue
            world.append(t.p)
            obs.extend(t.obs)
            offsets.append(len(obs))
        return (
            np.asarray(world, np.float64).reshape(-1, 3),
            np.asarray(offsets, np.int64),
            np.asarray(obs, np.int32).reshape(-1, 3),
        )

    def update_world(self, pts):
        i = 0
        for t in self.tracks:
            if not (t.alive and t.valid):
                continue
            if i >= len(pts):
                break
            t.p = tuple(pts[i])
            i += 1


class TrackStore:
    """Batched host-side track store (GlobalSet-equivalent).

    Observations are (image_index, x, y) int triples; world points float64.
    ``native``: True = the C++ store (a failed build raises); False = the
    Python store; None = C++ when a compiler is installed.  ``backend``
    names the one in use.
    """

    def __init__(self, threshold: float = 0.01, native: Optional[bool] = None):
        if native is None:
            native = cxx_available()
        self._lib = trackstore_library() if native else None
        self._h = None
        self._py = None
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.ts_create(threshold))
        else:
            self._py = _PyBackend(threshold)
        self.threshold = threshold

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "python"

    def close(self) -> None:
        if self._lib is not None and self._h:
            self._lib.ts_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self.close()

    def add_pairs(self, obs_a, obs_b, points) -> None:
        """Insert matched observation pairs: obs_a, obs_b (M, 3) int rows
        (image_index, x, y); points (M, 3) float world points."""
        obs_a = np.ascontiguousarray(obs_a, np.int32)
        obs_b = np.ascontiguousarray(obs_b, np.int32)
        pts = np.ascontiguousarray(points, np.float64)
        m = obs_a.shape[0]
        if obs_a.shape != (m, 3) or obs_b.shape != (m, 3) or pts.shape != (m, 3):
            raise ValueError(
                f"add_pairs needs (M, 3) arrays, got {obs_a.shape}, "
                f"{obs_b.shape}, {pts.shape}"
            )
        if m == 0:
            return
        if self._lib is not None:
            self._lib.ts_add_pairs(
                self._h, m, obs_a.ctypes.data, obs_b.ctypes.data,
                pts.ctypes.data,
            )
        else:
            self._py.add_pairs(obs_a, obs_b, pts)

    def info(self):
        """(num_valid_tracks, num_observations)."""
        if self._lib is None:
            return self._py.info()
        nt = ctypes.c_int64()
        no = ctypes.c_int64()
        self._lib.ts_info(self._h, ctypes.byref(nt), ctypes.byref(no))
        return nt.value, no.value

    def export(self):
        """Valid tracks in creation order: (world (T, 3) f64, offsets (T+1,)
        i64, obs (O, 3) i32), track t's rows being obs[offsets[t]:offsets[t+1]]."""
        if self._lib is None:
            return self._py.export()
        nt, no = self.info()
        world = np.empty((nt, 3), np.float64)
        offsets = np.empty(nt + 1, np.int64)
        obs = np.empty((no, 3), np.int32)
        self._lib.ts_export(
            self._h, world.ctypes.data, offsets.ctypes.data, obs.ctypes.data
        )
        return world, offsets, obs

    def update_world(self, points) -> None:
        """Write refined world points back, in creation order."""
        pts = np.ascontiguousarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"update_world needs (T, 3) points, got {pts.shape}")
        if self._lib is not None:
            self._lib.ts_update_world(self._h, pts.ctypes.data, pts.shape[0])
        else:
            self._py.update_world(pts)
