"""Middlebury multi-view-stereo calibration files.

Format (one header line with the camera count, then per camera
``name k11..k33 r11..r33 t1 t2 t3``; P = K [R | t]).  Host-side numpy, as in
``sfm_tpu/io/calib.py``; tensors are made where the device math needs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Calibration:
    """Stacked pinhole calibration for N views (float64 on host).

    K: (N, 3, 3) intrinsics; R: (N, 3, 3) world->camera rotations;
    t: (N, 3) translations; names: image filenames in file order.
    """

    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    names: tuple

    @classmethod
    def from_numpy(cls, K, R, t, names) -> "Calibration":
        """Build from numpy arrays, e.g. the fields of ``sfm_tpu``'s
        Calibration, so both packages are fed the same cameras."""
        return cls(
            K=np.asarray(K, np.float64), R=np.asarray(R, np.float64),
            t=np.asarray(t, np.float64), names=tuple(names),
        )

    @property
    def num_views(self) -> int:
        return self.K.shape[0]

    @property
    def P(self) -> np.ndarray:
        """(N, 3, 4) projection matrices P = K [R|t]."""
        Rt = np.concatenate([self.R, self.t[:, :, None]], axis=2)
        return np.einsum("nij,njk->nik", self.K, Rt)

    @property
    def centers(self) -> np.ndarray:
        """(N, 3) camera optical centers C = -R^T t."""
        return -np.einsum("nji,nj->ni", self.R, self.t)

    def subset(self, indices) -> "Calibration":
        idx = np.asarray(indices)
        return Calibration(
            K=self.K[idx], R=self.R[idx], t=self.t[idx],
            names=tuple(self.names[i] for i in idx),
        )


def read_pars(path: str) -> Calibration:
    """Parse a Middlebury ``*_par.txt`` file into a :class:`Calibration`."""
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty calibration file")
    try:
        count = int(lines[0].split()[0])
    except ValueError:
        raise ValueError(
            f"{path}: first line must be the camera count "
            f"(Middlebury par format), got: {lines[0][:80]!r}"
        ) from None
    rows = lines[1 : 1 + count]
    if len(rows) != count:
        raise ValueError(
            f"{path}: header says {count} cameras but file has {len(rows)} rows"
        )
    names, Ks, Rs, ts = [], [], [], []
    for ln in rows:
        parts = ln.split()
        if len(parts) != 1 + 9 + 9 + 3:
            raise ValueError(f"{path}: malformed row: {ln[:80]}")
        names.append(parts[0])
        try:
            vals = np.asarray([float(v) for v in parts[1:]], dtype=np.float64)
        except ValueError:
            raise ValueError(
                f"{path}: non-numeric camera parameters in row: {ln[:80]!r}"
            ) from None
        Ks.append(vals[0:9].reshape(3, 3))
        Rs.append(vals[9:18].reshape(3, 3))
        ts.append(vals[18:21])
    return Calibration(
        K=np.stack(Ks), R=np.stack(Rs), t=np.stack(ts), names=tuple(names)
    )


def write_pars(path: str, calib: Calibration) -> None:
    """Write a :class:`Calibration` as a Middlebury ``*_par.txt`` file — the
    exact inverse of :func:`read_pars`."""
    with open(path, "w") as f:
        f.write(f"{calib.num_views}\n")
        for i in range(calib.num_views):
            vals = np.concatenate(
                [calib.K[i].reshape(-1), calib.R[i].reshape(-1), calib.t[i]]
            )
            f.write(
                calib.names[i] + " " + " ".join(f"{v:.17g}" for v in vals)
                + "\n"
            )
