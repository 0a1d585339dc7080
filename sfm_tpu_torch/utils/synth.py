"""Synthetic calibrated scene generation (numpy only).

A copy of ``sfm_tpu/utils/synth.py``, which the port cannot import (any
``sfm_tpu`` import pulls in jax).  Renders exact-calibration scenes: ring,
arc, grid and irregular rigs; textured spheres (closed-form ray-sphere
geometry, random-Fourier 3-D texture, so every point has an exact
ground-truth surface distance).  The parity tests, ``chip_smoke.py`` and
``tools/stress_scale.py`` render the textured-sphere ring with it;
``render_scene`` renders the frames on a thread pool, the same images as
``sfm_tpu``'s one frame after another.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from sfm_tpu_torch.io.calib import Calibration


def look_at(C: np.ndarray, target: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera (R, t) for a camera at C looking at ``target``."""
    z = target - C
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.98:  # degenerate: looking straight up/down
        up = np.array([1.0, 0.0, 0.0])
    x_ax = np.cross(up, z)
    x_ax /= np.linalg.norm(x_ax)
    y_ax = np.cross(z, x_ax)
    R = np.stack([x_ax, y_ax, z])
    return R, -R @ C


def ring_rig(n: int, radius: float = 3.0, y: float = 0.35,
             span: float = 2 * np.pi) -> np.ndarray:
    """Camera centers on a (partial) ring; span < 2*pi gives an ARC rig."""
    angs = np.linspace(0.0, span, n, endpoint=span < 2 * np.pi)
    return np.stack(
        [radius * np.cos(angs), np.full(n, y), radius * np.sin(angs)], axis=1
    )


def grid_rig(nx: int, ny: int, extent: float = 1.6,
             dist: float = 3.0) -> np.ndarray:
    """Cameras on a planar grid at z = dist (a gantry/array rig, not a ring)."""
    gx, gy = np.meshgrid(
        np.linspace(-extent, extent, nx), np.linspace(-extent, extent, ny)
    )
    return np.stack(
        [gx.ravel(), gy.ravel(), np.full(nx * ny, dist)], axis=1
    )


def irregular_rig(n: int, radius: float = 3.0, seed: int = 7,
                  jitter: float = 0.35) -> np.ndarray:
    """Ring with random radial/height/angular perturbation — handheld-ish."""
    rng = np.random.default_rng(seed)
    angs = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = radius * (1 + rng.uniform(-jitter, jitter, n))
    y = rng.uniform(-0.5, 0.9, n)
    return np.stack([r * np.cos(angs), y, r * np.sin(angs)], axis=1)


def make_texture(seed: int, strength: float = 1.0, n_freq: int = 48,
                 freq_scale: float = 1.0):
    """Random-Fourier 3-D texture field -> [0, 255] grayscale.

    ``freq_scale`` multiplies the spatial frequencies: the 8-40 rad/unit
    default was tuned for 320-px renders (the top frequency is ~30 px/cycle
    there); at higher resolutions the same field is ~flat inside an 11-px
    patch and matching collapses (measured: ring(16) at 640x480 yields 27
    tracks vs 455 at 320x240).  Pass ~w/320 to keep per-patch contrast
    resolution-invariant."""
    rng = np.random.default_rng(seed)
    omega = (
        rng.normal(size=(n_freq, 3))
        * rng.uniform(8, 40, (n_freq, 1))
        * freq_scale
    )
    phase = rng.uniform(0, 2 * np.pi, n_freq)
    amp = rng.uniform(0.5, 1.0, n_freq) / np.sqrt(n_freq)

    def texture(p):
        v = np.tensordot(p, omega.T, axes=1) + phase
        t = (np.sin(v) * amp).sum(-1)
        return np.clip(127 + 90 * strength * t, 0, 255)

    return texture


def render_scene(
    centers: np.ndarray,
    w: int = 320,
    h: int = 240,
    fx: float | None = None,
    fy: float | None = None,
    spheres: Sequence[Tuple[Sequence[float], float]] = (((0, 0, 0), 1.0),),
    texture_strength: float = 1.0,
    texture_freq_scale: float | None = None,
    target: Sequence[float] = (0, 0, 0),
    seed: int = 0,
) -> Tuple[np.ndarray, Calibration]:
    """Ray-trace textured spheres from calibrated cameras.

    Args:
      centers: (N, 3) camera centers (from one of the rig functions).
      fx, fy: focal lengths in px (default 1.2*w each; pass fx != fy to
        exercise anisotropic intrinsics).
      spheres: ((cx, cy, cz), radius) list; nearest-hit shading, so a second
        sphere OCCLUDES the first from some views.
      texture_strength: 1.0 = stress-scale texture; ~0.08 approaches the
        matcher/NCC noise floor (weak-texture scene).
      texture_freq_scale: spatial-frequency multiplier; default w/320 keeps
        per-patch contrast resolution-invariant (see make_texture).

    The frames render on a pool of ``min(N, os.cpu_count())`` threads, one
    frame a task: numpy's ufuncs and matrix products release the GIL, and
    each frame's arithmetic is that of one frame after another, so the
    images are bit-equal to it.

    Returns (images uint8 (N, H, W, 3), exact Calibration).
    """
    n = centers.shape[0]
    fx = 1.2 * w if fx is None else fx
    fy = fx if fy is None else fy
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float64)
    target = np.asarray(target, np.float64)
    if texture_freq_scale is None:
        # max(1, ...) keeps every <= 320-px render (the tuned regime: scene
        # tests, small fixtures) bit-identical to the pre-round-4 field.
        texture_freq_scale = max(1.0, w / 320.0)
    textures = [
        make_texture(seed + 11 * i, texture_strength,
                     freq_scale=texture_freq_scale)
        for i in range(len(spheres))
    ]
    ys, xs = np.mgrid[0:h, 0:w]

    def frame(i):
        C = centers[i].astype(np.float64)
        R, t = look_at(C, target)
        d_cam = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
             np.ones_like(xs, np.float64)], -1)
        d_w = d_cam @ R
        d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)
        depth = np.full((h, w), np.inf)
        g = np.full((h, w), 12.0)
        for (sc, rho), tex in zip(spheres, textures):
            sc = np.asarray(sc, np.float64)
            oc = C - sc
            b = d_w @ oc
            disc = b * b - (oc @ oc - rho * rho)
            hit = disc > 0
            s = -b - np.sqrt(np.maximum(disc, 0))
            hit &= s > 0
            closer = hit & (s < depth)
            p = C + s[..., None] * d_w
            g = np.where(closer, tex((p - sc) / rho), g)
            depth = np.where(closer, s, depth)
        img = np.repeat(
            np.clip(g, 0, 255)[..., None], 3, axis=-1
        ).astype(np.uint8)
        return R, t, img

    with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 1)) as pool:
        frames = list(pool.map(frame, range(n)))
    Rs, ts, imgs = zip(*frames)
    calib = Calibration(
        K=np.stack([K] * n), R=np.stack(Rs), t=np.stack(ts),
        names=tuple(f"s{i:04d}" for i in range(n)),
    )
    return np.stack(imgs), calib


def surface_distance(points: np.ndarray,
                     spheres: Sequence[Tuple[Sequence[float], float]]
                     ) -> np.ndarray:
    """Exact distance of each point to the nearest sphere surface."""
    d = np.full(points.shape[0], np.inf)
    for sc, rho in spheres:
        d = np.minimum(
            d, np.abs(np.linalg.norm(points - np.asarray(sc), axis=1) - rho)
        )
    return d


def write_middlebury_dataset(
    out_dir: str,
    centers: np.ndarray = None,
    w: int = 640,
    h: int = 480,
    prefix: str = "templeSR",
    image_type: str = "ppm",
    spheres: Sequence[Tuple[Sequence[float], float]] = (
        ((0.0, 0.0, 0.0), 1.0),
        ((1.0, 0.1, 0.9), 0.55),
    ),
    **render_kwargs,
):
    """Render a synthetic scene and materialize it ON DISK in Middlebury
    layout — images + ``{prefix}_par.txt`` — so the CLI can be driven with
    the reference's exact run_temple.sh invocation shape
    (``run_temple.sh``: ``-img_p dir -par_p dir/templeSR_par.txt
    -t ppm``).  The two-sphere default gives a temple-ish
    occluding scene rather than the dino-tuned single sphere.

    Returns (dataset_dir_path, par_path, spheres) for driving + ground
    truth (``surface_distance``)."""
    import os

    from PIL import Image

    from sfm_tpu_torch.io.calib import write_pars

    if centers is None:
        centers = ring_rig(16)
    images, calib = render_scene(
        centers, w=w, h=h, spheres=spheres, **render_kwargs
    )
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for i in range(images.shape[0]):
        name = f"{prefix}{i + 1:04d}.{image_type}"
        Image.fromarray(images[i]).save(os.path.join(out_dir, name))
        names.append(name)
    calib = Calibration(K=calib.K, R=calib.R, t=calib.t, names=tuple(names))
    par_path = os.path.join(out_dir, f"{prefix}_par.txt")
    write_pars(par_path, calib)
    return out_dir, par_path, spheres
