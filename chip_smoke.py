#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels and the track store from the sources, holds
each kernel against its plain PyTorch version at the shapes of the main
path, drives the sparse SfM stage (library and CLI) on a rendered
48-frame 640x480 textured-sphere ring, times the kernels, and prints as its
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the exit code is nonzero.  Without CUDA it exits 1 and prints no result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_FRAMES, WIDTH, HEIGHT = 48, 640, 480       # the dinoRing shape
WID = 5                                      # 11x11 descriptors
MVS_SAMPLES = 32768 * 5                      # round_capacity x photo views
K2_FRAC_ATOL = 8e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg):
    print(msg, flush=True)


def render_ring(n=N_FRAMES, w=WIDTH, h=HEIGHT):
    from sfm_tpu_torch.utils import synth

    return synth.render_scene(synth.ring_rig(n), w=w, h=h, seed=0)


def bf16_ulps(got, want):
    """Largest |got - want| in units of the bf16 spacing at the larger value."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    exp = torch.floor(torch.log2(torch.clamp_min(mag, 2.0 ** -126)))
    ulp = torch.exp2(exp - 7)
    return float(((g - w).abs() / ulp).max())


def check_k1(gray):
    """K1 against its plain version: bit-equal response and corners."""
    import torch

    from sfm_tpu_torch.ops.harris import _harris_math, detect_corners, harris_response

    got = harris_response(gray, 0.04)
    want = _harris_math(gray, 0.04)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K1 response bit-equal to the plain version")
    kw = dict(max_corners=1024, nms_radius=4, rel_threshold=1e-6, border=WID + 1)
    ck, vk, _ = detect_corners(gray, kernels=True, **kw)
    cp, vp, _ = detect_corners(gray, kernels=False, **kw)
    check(torch.equal(ck, cp) and torch.equal(vk, vp),
          "detect_corners through K1 bit-equal to the plain version")
    log(f"K1: response bit-equal on {tuple(gray.shape)}; corners bit-equal "
        f"({int(vk.sum())} valid of {vk.numel()})")
    return {"max_abs_err": float((got - want).abs().max()), "corners": ck}


def k2_inputs(gray, corners):
    """The two K2 shapes of the main path: integer centers at the feature
    shape, and MVS-round fractional centers (incl. near the clip edges)."""
    import torch

    n, h, w = gray.shape
    k = corners.shape[1]
    img_i = (torch.arange(n, dtype=torch.int32, device=gray.device)[:, None]
             .expand(n, k).reshape(-1).contiguous())
    ctr_i = corners.reshape(-1, 2).float().contiguous()
    g = torch.Generator(device="cpu").manual_seed(0)
    m = MVS_SAMPLES
    img_f = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    ctr_f = torch.rand((m, 2), generator=g) * torch.tensor([w + 6.0, h + 6.0]) - 3.0
    # A quarter of the samples sit within a pixel of the in-bounds edges.
    q = m // 4
    edge_x = torch.tensor([WID + 1.0, w - WID - 2.0])[torch.randint(0, 2, (q,), generator=g)]
    edge_y = torch.tensor([WID + 1.0, h - WID - 2.0])[torch.randint(0, 2, (q,), generator=g)]
    ctr_f[:q, 0] = edge_x + torch.rand(q, generator=g) * 2 - 1
    ctr_f[q:2 * q, 1] = edge_y[: q] + torch.rand(q, generator=g) * 2 - 1
    dev = gray.device
    return (img_i, ctr_i), (img_f.to(dev), ctr_f.to(dev).contiguous())


def check_k2(gray_bf16, k2_in):
    """K2 against its plain version at both shapes."""
    import torch

    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import bilinear_sample_patches_stack

    (img_i, ctr_i), (img_f, ctr_f) = k2_in
    out = {}
    for name, img, ctr in (("integer", img_i, ctr_i), ("fractional", img_f, ctr_f)):
        got, inb = sample_normalized_patches(gray_bf16, img, ctr, WID)
        want = _sample_plain(gray_bf16, img, ctr, WID)
        _, inb_plain = bilinear_sample_patches_stack(gray_bf16.float(), img, ctr, WID)
        torch.cuda.synchronize()
        check(torch.equal(inb, inb_plain), f"K2 {name}: in-bounds mask equal")
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulps(got, want)
        if name == "integer":
            check(ulps <= 1.0, f"K2 integer: {ulps} bf16 ulps > 1")
        else:
            check(err <= K2_FRAC_ATOL, f"K2 fractional: {err} > {K2_FRAC_ATOL}")
        check(bool(torch.isfinite(got.float()).all()), f"K2 {name}: finite")
        log(f"K2 {name}: {img.numel()} samples, max abs err {err:.3e} "
            f"({ulps:.2f} bf16 ulps), in-bounds {int(inb.sum())}")
        out[name] = err
    return out


def cuda_ms(fn, reps=20, batch=10):
    """Median milliseconds per call: ``reps`` CUDA-event windows, each over
    ``batch`` back-to-back calls (so host launch overhead overlaps)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def sphere_bounds(world):
    import numpy as np

    r = np.abs(np.linalg.norm(world, axis=1) - 1.0)
    return float(np.median(r)), float(np.percentile(r, 95))


def run_sfm(images, calib, kernels):
    import torch

    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig
    from sfm_tpu_torch.sfm import structure_from_motion

    cfg = PipelineConfig(runtime=RuntimeConfig(device="cuda", kernels=kernels))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg)
    torch.cuda.synchronize()
    return recon, time.perf_counter() - t0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; chip_smoke needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import sfm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: sfm_tpu_torch not importable next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 1
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response
    from sfm_tpu_torch.utils import build

    # --- 1. device, build ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    build.kernel_library()
    t_k = time.perf_counter() - t0
    build.trackstore_library()
    log(f"build: CUDA kernels {t_k:.1f} s, track store "
        f"{time.perf_counter() - t0 - t_k:.1f} s")
    for line in build.kernel_build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 2./3. kernels against their plain versions -------------------------
    t0 = time.perf_counter()
    images, calib = render_ring()
    log(f"rendered {images.shape} ring in {time.perf_counter() - t0:.1f} s")
    from sfm_tpu_torch.io.images import gray_tensor

    gray = gray_tensor(images, "cuda")
    k1 = check_k1(gray)
    gray_bf16 = gray.to(torch.bfloat16)
    k2_in = k2_inputs(gray, k1["corners"])
    k2 = check_k2(gray_bf16, k2_in)

    # --- 4. the SfM stage ---------------------------------------------------
    run_sfm(images, calib, kernels=True)  # warm: allocator, cuBLAS, sort
    harris_response.launches = 0
    sample_normalized_patches.launches = 0
    recon, wall = run_sfm(images, calib, kernels=True)
    launches = {"harris_response": harris_response.launches,
                "sample_normalized_patches": sample_normalized_patches.launches}
    log(f"launches in the timed SfM run: {launches}")
    for kname, cnt in launches.items():
        check(cnt > 0, f"{kname} not launched on the main path")
    mv = recon.metrics.values
    med, p95 = sphere_bounds(recon.world)
    log(f"SfM (kernels): {recon.num_tracks} tracks, {recon.num_observations} "
        f"observations, mean pair reproj {mv['mean_pair_reprojection_error_px']:.4f} px, "
        f"sphere |r-1| median {med:.2e} p95 {p95:.2e}, backend "
        f"{mv['track_store_backend']}")
    log(f"SfM stage wall {wall:.4f} s; timers "
        + json.dumps({k: round(v, 4) for k, v in recon.timers.times.items()}))
    check(recon.num_tracks > 500, f"num_tracks {recon.num_tracks} <= 500")
    check(mv["mean_pair_reprojection_error_px"] < 0.3, "pair reprojection >= 0.3 px")
    check(med < 0.01 and p95 < 0.05, f"sphere bounds median {med} p95 {p95}")
    check(mv["track_store_backend"] == "native", "native track store")
    plain, plain_wall = run_sfm(images, calib, kernels=False)
    log(f"SfM (plain versions on the card): {plain.num_tracks} tracks, wall "
        f"{plain_wall:.4f} s; timers "
        + json.dumps({k: round(v, 4) for k, v in plain.timers.times.items()}))
    check(abs(plain.num_tracks - recon.num_tracks) <= 0.1 * plain.num_tracks,
          "kernel and plain SfM track counts within 10%")

    # --- 5. the CLI on the scene written as a Middlebury dataset ------------
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    log(f"CLI phase: {'runs' if have_pil else 'skipped (Pillow not installed)'}")
    if have_pil:
        from sfm_tpu_torch.cli import main as cli_main
        from sfm_tpu_torch.io.ply import read_ply
        from sfm_tpu_torch.utils import synth

        with tempfile.TemporaryDirectory() as tmp:
            ds = os.path.join(tmp, "ring")
            _, par, _ = synth.write_middlebury_dataset(
                ds, centers=synth.ring_rig(N_FRAMES), w=WIDTH, h=HEIGHT,
                image_type="png", spheres=(((0.0, 0.0, 0.0), 1.0),), seed=0,
            )
            out = os.path.join(tmp, "out")
            rc = cli_main(["-img_p", ds, "-par_p", par, "-t", "png",
                           "--stages", "sfm", "--out_dir", out])
            check(rc == 0, f"CLI exit code {rc}")
            pts, _ = read_ply(os.path.join(out, "sparse_points.ply"))
            med_c, p95_c = sphere_bounds(pts.astype("float64"))
            log(f"CLI: {pts.shape[0]} sparse points, sphere median {med_c:.2e} "
                f"p95 {p95_c:.2e}")
            check(pts.shape[0] > 500 and med_c < 0.01 and p95_c < 0.05,
                  "CLI sparse cloud on the sphere")

    # --- 6. kernel times against the plain versions -------------------------
    (img_i, ctr_i), (img_f, ctr_f) = k2_in
    t = {
        "k1": cuda_ms(lambda: harris_response(gray, 0.04)),
        "k1_plain": cuda_ms(lambda: _harris_math(gray, 0.04)),
        "k2_int": cuda_ms(lambda: sample_normalized_patches(gray_bf16, img_i, ctr_i, WID)),
        "k2_int_plain": cuda_ms(lambda: _sample_plain(gray_bf16, img_i, ctr_i, WID)),
        "k2_frac": cuda_ms(lambda: sample_normalized_patches(gray_bf16, img_f, ctr_f, WID)),
        "k2_frac_plain": cuda_ms(lambda: _sample_plain(gray_bf16, img_f, ctr_f, WID)),
    }
    log(f"kernel times, ms per call, median of 20 windows of 10 calls, on {smi}: "
        + json.dumps({k: round(v, 4) for k, v in t.items()}))

    kernels = [
        {"name": "harris_response", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/harris.cu",
         "replaces": "sfm_tpu/ops/harris.py:79",
         "launches": launches["harris_response"],
         "max_abs_err": k1["max_abs_err"], "ms": t["k1"], "plain_ms": t["k1_plain"],
         "shape": list(gray.shape)},
        {"name": "sample_normalized_patches", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/gather.cu",
         "replaces": "sfm_tpu/ops/gather.py:112",
         "launches": launches["sample_normalized_patches"],
         "max_abs_err": max(k2.values()), "ms": t["k2_int"],
         "plain_ms": t["k2_int_plain"], "samples": img_i.numel(),
         "ms_fractional": t["k2_frac"], "plain_ms_fractional": t["k2_frac_plain"],
         "samples_fractional": img_f.numel()},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
