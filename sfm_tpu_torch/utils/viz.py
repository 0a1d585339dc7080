"""Optional matplotlib figures (``--plot``, ``--debug``).

Counterpart of ``sfm_tpu/utils/viz.py``: a 3-D scatter of a cloud, and the
epipolar lines and matches of one image pair.  Both save a PNG when given a
path.  matplotlib is imported inside each function (Agg backend), so the
package imports without it; ``require_matplotlib`` lets a caller fail early
with a message instead.
"""

from __future__ import annotations

import numpy as np
import torch


def require_matplotlib() -> None:
    """Raise RuntimeError naming matplotlib when it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "--plot and --debug draw with matplotlib, which is not installed"
        ) from e


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def scatter3d(points, colors=None, scale: float = 1.0, title: str = "",
              path: str | None = None):
    """3-D scatter of a point cloud; saves a PNG if ``path`` is given."""
    plt = _pyplot()
    pts = np.asarray(points) * scale
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_title(title)
    c = None
    if colors is not None:
        c = np.asarray(colors).reshape(-1, 3) / 255.0
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=c, s=1, linewidth=0.1)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def draw_epipolar_debug(img1, img2, pts1, pts2, F, path: str | None = None,
                        max_lines: int = 30):
    """Epipolar lines and matches of one pair, side by side: in each image
    its points and the lines of the other image's points."""
    from sfm_tpu_torch.geometry.epipolar import epipolar_lines

    plt = _pyplot()
    pts1 = np.asarray(pts1)[:max_lines]
    pts2 = np.asarray(pts2)[:max_lines]
    F_t = torch.as_tensor(np.asarray(F, np.float32))
    lines2 = epipolar_lines(F_t, torch.as_tensor(pts1, dtype=torch.float32), 1).numpy()
    lines1 = epipolar_lines(F_t, torch.as_tensor(pts2, dtype=torch.float32), 2).numpy()

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    h, w = img1.shape[:2]
    for ax, img, pts, lines in (
        (axes[0], img1, pts1, lines1),
        (axes[1], img2, pts2, lines2),
    ):
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        for (x, y), (a, b, c) in zip(pts, lines):
            ax.plot(x, y, "o", markersize=3)
            if abs(b) > 1e-9:
                xs = np.asarray([0.0, w])
                ys = -(a * xs + c) / b
                ax.plot(xs, ys, linewidth=0.5)
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
