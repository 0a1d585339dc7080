"""PLY point-cloud export.

The reference writes PLY through pyntcloud + pandas (utils.py:249-251).  We
write the format directly — a dependency-free binary-little-endian writer with
an ASCII option — covering the same schema: x, y, z float + red, green, blue
uchar per vertex (MVS2.py:264-274, 295).
"""

from __future__ import annotations


import numpy as np


def export_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write an (N, 3) float point cloud, optional (N, 3) uint8 colors."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    has_color = colors is not None
    if has_color:
        cols = np.asarray(colors).reshape(-1, 3)
        if cols.dtype != np.uint8:
            cols = np.clip(cols, 0, 255).astype(np.uint8)
        if cols.shape[0] != n:
            raise ValueError(f"points ({n}) / colors ({cols.shape[0]}) mismatch")

    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header.append("end_header")

    if binary:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            if has_color:
                rec = np.zeros(
                    n,
                    dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                )
                rec["xyz"] = pts
                rec["rgb"] = cols
                f.write(rec.tobytes())
            else:
                f.write(pts.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for i in range(n):
                row = f"{pts[i,0]} {pts[i,1]} {pts[i,2]}"
                if has_color:
                    row += f" {cols[i,0]} {cols[i,1]} {cols[i,2]}"
                f.write(row + "\n")


def read_ply(path: str):
    """Minimal reader for files written by :func:`export_ply` (tests)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
        has_color = any("red" in h for h in header)
        binary = any("binary" in h for h in header)
        if binary:
            if has_color:
                rec = np.frombuffer(
                    f.read(n * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)]
                )
                return rec["xyz"].copy(), rec["rgb"].copy()
            pts = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3)
            return pts.copy(), None
        rows = [f.readline().decode("ascii").split() for _ in range(n)]
        arr = np.asarray(rows, dtype=np.float64)
        pts = arr[:, :3].astype(np.float32)
        cols = arr[:, 3:6].astype(np.uint8) if has_color else None
        return pts, cols
