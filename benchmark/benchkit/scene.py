"""Calibrated ring scenes of textured spheres, rendered on the device.

A frozen copy of ``sfm_tpu_torch/utils/synth.py`` at commit bfc7f14
(``look_at``, ``ring_rig``, ``make_texture``, ``render_scene``): the same
rig, the same random-Fourier texture drawn from the seed with NumPy, the
same closed-form ray-sphere shading and the same uint8 truncation, with
the per-pixel arithmetic in float64 PyTorch on the run's device, one frame
at a time, so that a 48-frame 640x480 ring takes tens of milliseconds of
set-up on the card instead of seconds of host time.
"""

from __future__ import annotations

import numpy as np
import torch


def look_at(C: np.ndarray, target: np.ndarray):
    """World->camera (R, t) for a camera at C looking at ``target``."""
    z = target - C
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([1.0, 0.0, 0.0])
    x_ax = np.cross(up, z)
    x_ax /= np.linalg.norm(x_ax)
    y_ax = np.cross(z, x_ax)
    R = np.stack([x_ax, y_ax, z])
    return R, -R @ C


def ring_rig(n: int, radius: float, y: float) -> np.ndarray:
    """(n, 3) camera centres evenly spaced on a full ring."""
    angs = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack(
        [radius * np.cos(angs), np.full(n, y), radius * np.sin(angs)], axis=1)


def texture_params(seed: int, strength: float, freq_scale: float,
                   n_freq: int = 48):
    """(omega (F, 3), phase (F,), amp (F,), strength) of a random-Fourier
    3-D texture, drawn with NumPy from ``seed``."""
    rng = np.random.default_rng(seed)
    omega = (rng.normal(size=(n_freq, 3)) * rng.uniform(8, 40, (n_freq, 1))
             * freq_scale)
    phase = rng.uniform(0, 2 * np.pi, n_freq)
    amp = rng.uniform(0.5, 1.0, n_freq) / np.sqrt(n_freq)
    return omega, phase, amp, strength


def render_set(scene: dict, count: int, device):
    """The configuration's ``count`` scenes: its rig with the textures of
    seeds 0 .. count - 1, the same for every run, so that every run does
    the same work.  Returns (list of uint8 (N, H, W, 3) host arrays, K, R,
    t), the cameras shared by all."""
    images = []
    for k in range(count):
        img, K, R, t = render(scene, k, device)
        images.append(img)
    return images, K, R, t


def render(scene: dict, seed: int, device):
    """Render the configuration's ``scene`` block for ``seed``.

    Returns (images uint8 (N, H, W, 3) on the host, K, R, t float64 numpy
    (N, 3, 3), (N, 3, 3), (N, 3)).  The rig is fixed by the block; the seed
    draws the spheres' textures (sphere i from ``seed + 11 i``)."""
    device = torch.device(device)
    n, w, h = scene["frames"], scene["width"], scene["height"]
    f = float(scene["focal_px"])
    centers = ring_rig(n, scene["rig_radius"], scene["rig_height"])
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    freq_scale = max(1.0, w / 320.0)
    spheres = [(np.asarray(c, np.float64), float(r))
               for c, r in scene["spheres"]]
    textures = [
        tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
              if isinstance(a, np.ndarray) else a
              for a in texture_params(seed + 11 * i,
                                      scene["texture_strength"], freq_scale))
        for i in range(len(spheres))
    ]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    d_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                         torch.ones_like(xs)], -1)
    Rs, ts = [], []
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        C = centers[i]
        R, t = look_at(C, np.zeros(3))
        Rs.append(R)
        ts.append(t)
        d_w = d_cam @ torch.as_tensor(R, device=device)
        d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)
        Ct = torch.as_tensor(C, device=device)
        depth = torch.full((h, w), float("inf"), dtype=torch.float64,
                           device=device)
        g = torch.full((h, w), 12.0, dtype=torch.float64, device=device)
        for (sc, rho), (omega, phase, amp, strength) in zip(spheres, textures):
            oc = Ct - torch.as_tensor(sc, device=device)
            b = d_w @ oc
            disc = b * b - (oc @ oc - rho * rho)
            hit = disc > 0
            s = -b - torch.sqrt(torch.clamp_min(disc, 0))
            hit &= s > 0
            closer = hit & (s < depth)
            p = (Ct + s[..., None] * d_w - torch.as_tensor(sc, device=device)) / rho
            v = p @ omega.T + phase
            tex = torch.clamp(127 + 90 * strength * (torch.sin(v) * amp).sum(-1),
                              0, 255)
            g = torch.where(closer, tex, g)
            depth = torch.where(closer, s, depth)
        frames[i] = torch.clamp(g, 0, 255).to(torch.uint8)[..., None].expand(h, w, 3)
    return (frames.cpu().numpy(), np.stack([K] * n), np.stack(Rs),
            np.stack(ts))
