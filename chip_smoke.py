#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels and the track store from the sources, holds
each kernel against its plain PyTorch version at the shapes of the main
path (K2 also at the centres of one expansion round and at non-finite
centres), drives the main path on a rendered 48-frame 640x480
textured-sphere ring -- the SfM stage, points-only bundle adjustment and
dense MVS at the CLI defaults, each as a library call with the launch
counts read around it, then the CLI's default ``--stages sfm,ba,mvs`` --
times the kernels and the stages (with a torch.profiler table of one MVS
run), and prints as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is nonzero.  Without CUDA it exits 1 and prints no result.  Imports
nothing of JAX.
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
    # A fresh copy misses the per-process grayscale cache (io.device_gray),
    # so the stage pays its conversion and upload, as a first stage does.
    images = images.copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg)
    torch.cuda.synchronize()
    return recon, time.perf_counter() - t0


def check_k2_mvs_round(gray, calib, recon):
    """K2 against its plain version at the centres that one ported
    expansion round (the MVS defaults, gated to 5 views) produces from the
    seeded frontier of ``recon`` on the card, plus NaN, +-inf and huge
    centres.  The stack sits between two NaN images: a window read outside
    it would turn a finite centre's descriptor into NaN."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig, resolve_photo_views
    from sfm_tpu_torch.mvs.cells import make_occupancy
    from sfm_tpu_torch.mvs.expand import expansion_round
    from sfm_tpu_torch.mvs.photoconsistency import _gated_samples
    from sfm_tpu_torch.mvs.pipeline import _split_frontier
    from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import _inbounds

    n, h, w = gray.shape
    dev = gray.device
    buf = torch.full((n + 2, h, w), float("nan"), dtype=torch.bfloat16, device=dev)
    buf[1:-1] = gray.to(torch.bfloat16)
    g = buf[1:-1]
    cfg = MvsConfig()
    views = resolve_photo_views(cfg.max_photo_views, n)
    K, R, t, C = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (calib.K, calib.R, calib.t, calib.centers))
    tid, ref_obs, oth = build_seed_candidates(recon.track_offsets, recon.track_obs)
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tid, ref_obs, oth)]
    occ = make_occupancy(n, h, w, cfg.cell_size, dev)
    seeds, occ, _ = seed_patches(g, K, R, t, C, *ints, recon.num_tracks, occ,
                                 cfg, cfg.visible_lower_bound)
    fr, _ = _split_frontier(seeds, cfg.round_capacity)
    acc, _, packed = expansion_round(
        g, K, R, t, C, occ, fr["c"], fr["n"], fr["vis"], fr["proj"],
        fr["valid"], cfg, cfg.visible_lower_bound, cfg.round_capacity, 1.0)
    _, vidx, pix, _, _ = _gated_samples(K, R, t, acc["c"], acc["ref"], h, w,
                                        WID, views)
    inf, nan = float("inf"), float("nan")
    bad = torch.tensor(
        [[nan, 100], [100, nan], [nan, nan], [inf, 100], [-inf, 100],
         [100, inf], [100, -inf], [inf, -inf], [1e10, 100], [100, 1e10],
         [-1e10, -1e10], [3e9, -3e9], [-3e9, 3e9]], device=dev)
    img = torch.cat([vidx.reshape(-1).to(torch.int32),
                     torch.arange(bad.shape[0], dtype=torch.int32, device=dev) % n])
    ctr = torch.cat([pix.reshape(-1, 2), bad]).contiguous()
    got, inb = sample_normalized_patches(g, img, ctr, WID)
    want = _sample_plain(g, img, ctr, WID)
    inb_plain = _inbounds(ctr[:, 0], ctr[:, 1], h, w, WID)
    torch.cuda.synchronize()
    check(torch.equal(inb, inb_plain), "K2 MVS round: in-bounds mask equal")
    check(not bool(inb[-bad.shape[0]:].any()), "K2: non-finite/huge centres out of bounds")
    fin = torch.isfinite(ctr).all(dim=1)
    check(bool(torch.isfinite(got.float()[fin]).all()),
          "K2 read outside the stack (a NaN guard image reached a finite centre)")
    err = float((got.float() - want.float())[fin].abs().max())
    check(err <= K2_FRAC_ATOL, f"K2 MVS round: {err} > {K2_FRAC_ATOL}")
    out = {"samples": int(img.numel()), "max_abs_err": err,
           "nonfinite_centres": int((~fin).sum()),
           "round_candidates": int(packed[-1, 2]), "round_accepted": int(packed[-1, 6])}
    log(f"K2 at one expansion round's centres (+{bad.shape[0]} NaN/inf/huge): "
        + json.dumps(out))
    return out


def run_ba(recon):
    import torch

    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig

    before = recon.rms_reprojection_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon, info = bundle_adjust(recon, BaConfig(dtype="float32"), device="cuda")
    torch.cuda.synchronize()
    return recon, info, before, time.perf_counter() - t0


def run_mvs(images, recon, kernels):
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = dense_reconstruction(images, recon.calib, recon, MvsConfig(),
                                 scale=1.0, device="cuda", kernels=kernels)
    torch.cuda.synchronize()
    return dense, time.perf_counter() - t0


def dense_bounds(points, normals):
    import numpy as np

    r = np.abs(np.linalg.norm(points, axis=1) - 1.0)
    outward = float((np.einsum("ij,ij->i", normals, points) > 0).mean())
    return float(np.median(r)), float(np.percentile(r, 90)), outward


def profile_mvs(images, recon, smi):
    """One MVS run under torch.profiler: K2's device time and every
    kernel's, summed, and a table by device and by host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dense, wall = run_mvs(images, recon, kernels=None)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k2_ms = sum(e.time_range.elapsed_us() for e in kernels
                if "gather_kernel" in e.name) / 1e3
    check(k2_ms > 0, "the profiler saw no K2 kernel in the MVS run")
    ka = prof.key_averages()
    log(f"one MVS stage under the profiler: wall {wall:.4f} s, "
        f"{dense.num_points} points, on {smi}")
    log(ka.table(sort_by="self_cuda_time_total", row_limit=25))
    log(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    log(f"MVS profiled: wall {wall:.4f} s, device kernels busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / 1e3 / wall:.1f} % of the wall), K2 {k2_ms:.3f} ms")
    return {"wall_s": wall, "busy_ms": busy_ms, "k2_ms": k2_ms}


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
    plain_sfm, plain_wall_sfm = run_sfm(images, calib, kernels=False)
    log(f"SfM (plain versions on the card): {plain_sfm.num_tracks} tracks, wall "
        f"{plain_wall_sfm:.4f} s; timers "
        + json.dumps({k: round(v, 4) for k, v in plain_sfm.timers.times.items()}))
    check(abs(plain_sfm.num_tracks - recon.num_tracks) <= 0.1 * plain_sfm.num_tracks,
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

    # --- 7. K2 at one expansion round's centres, and non-finite ones -------
    k2_round = check_k2_mvs_round(gray, calib, recon)

    # --- 8. points-only bundle adjustment on the phase-4 sparse result ------
    from sfm_tpu_torch.sfm.pipeline import SparseReconstruction

    warm = SparseReconstruction(calib=recon.calib, world=recon.world.copy(),
                                track_offsets=recon.track_offsets,
                                track_obs=recon.track_obs)
    _, _, _, ba_cold = run_ba(warm)  # warm-up: the first BA call in the process
    harris_response.launches = 0
    sample_normalized_patches.launches = 0
    recon, info, rms_before, ba_wall = run_ba(recon)
    check(harris_response.launches == 0 and sample_normalized_patches.launches == 0,
          "BA launched an image kernel")
    rms_after = recon.rms_reprojection_error()
    med, p95 = sphere_bounds(recon.world)
    log(f"BA (f32, cameras frozen): {info['iterations']} iterations, final cost "
        f"{info['final_cost']:.6g}, rms {rms_before:.4f} -> {rms_after:.4f} px, "
        f"sphere |r-1| median {med:.2e} p95 {p95:.2e}; wall {ba_wall:.4f} s "
        f"(first call {ba_cold:.4f} s); timers "
        + json.dumps({k: round(v, 4) for k, v in info["timers"].items()}))
    check(rms_after < 0.3, f"BA rms {rms_after} >= 0.3 px")
    check(rms_after <= rms_before, "BA rms rose")
    check(info["iterations"] >= 1, "BA ran no iteration")
    check(med < 0.01 and p95 < 0.05, f"BA sphere bounds median {med} p95 {p95}")

    # --- 9. dense MVS at the CLI defaults -----------------------------------
    first, first_wall = run_mvs(images, recon, kernels=None)  # warm
    harris_response.launches = 0
    sample_normalized_patches.launches = 0
    dense, mvs_wall = run_mvs(images, recon, kernels=None)
    launches_mvs = sample_normalized_patches.launches
    check(harris_response.launches == 0, "MVS launched K1")
    log(f"launches in the timed MVS run: sample_normalized_patches {launches_mvs}")
    check(launches_mvs > 0, "sample_normalized_patches not launched on the MVS path")
    mv = dense.metrics.values
    med, p90, outward = dense_bounds(dense.points, dense.normals)
    log(f"MVS (kernels): {dense.num_seeds} seeds -> {dense.num_points} points in "
        f"{mv['mvs_rounds']} rounds; |c|-1 median {med:.2e} p90 {p90:.2e}; "
        f"n.c > 0 share {outward:.4f}; wall {mvs_wall:.4f} s (first run "
        f"{first_wall:.4f} s); timers "
        + json.dumps({k: round(v, 4) for k, v in dense.timers.times.items()}))
    log("MVS metrics: " + dense.metrics.to_json())
    check(dense.num_points > 10000, f"dense points {dense.num_points} <= 10000")
    check(med < 0.02 and p90 < 0.06, f"dense sphere bounds median {med} p90 {p90}")
    check(outward > 0.9, f"n.c > 0 share {outward} <= 0.9")
    same = dense.num_points == first.num_points and dense.num_seeds == first.num_seeds
    log(f"MVS second kernel run identical counts: {same} "
        f"({first.num_points} then {dense.num_points} points)")
    plain, plain_wall = run_mvs(images, recon, kernels=False)
    log(f"MVS (plain K2 version on the card): {plain.num_seeds} seeds -> "
        f"{plain.num_points} points in {plain.metrics.values['mvs_rounds']} rounds; "
        f"wall {plain_wall:.4f} s vs {mvs_wall:.4f} s with K2")
    check(abs(plain.num_points - dense.num_points) <= 0.01 * dense.num_points,
          "kernel and plain MVS dense counts within 1%")
    prof = profile_mvs(images, recon, smi)

    # --- 10. the CLI, default stages sfm,ba,mvs, on the written dataset -----
    if have_pil:
        with tempfile.TemporaryDirectory() as tmp:
            ds = os.path.join(tmp, "ring")
            _, par, _ = synth.write_middlebury_dataset(
                ds, centers=synth.ring_rig(N_FRAMES), w=WIDTH, h=HEIGHT,
                image_type="png", spheres=(((0.0, 0.0, 0.0), 1.0),), seed=0,
            )
            out = os.path.join(tmp, "out")
            t0 = time.perf_counter()
            rc = cli_main(["-img_p", ds, "-par_p", par, "-t", "png",
                           "--out_dir", out])
            cli_wall = time.perf_counter() - t0
            check(rc == 0, f"CLI exit code {rc}")
            clouds = {name: read_ply(os.path.join(out, name + ".ply"))
                      for name in ("sparse_points", "sparse_points_ba",
                                   "initial_patches", "all_patches")}
            pts = clouds["sparse_points"][0].astype("float64")
            med_c, p95_c = sphere_bounds(pts)
            dpts = clouds["all_patches"][0].astype("float64")
            dmed, dp90, _ = dense_bounds(dpts, dpts)
            log(f"CLI (sfm,ba,mvs) in {cli_wall:.2f} s: "
                + ", ".join(f"{k} {v[0].shape[0]}" for k, v in clouds.items())
                + f"; sparse median {med_c:.2e} p95 {p95_c:.2e}; dense median "
                f"{dmed:.2e} p90 {dp90:.2e}")
            check(pts.shape[0] > 500 and med_c < 0.01 and p95_c < 0.05,
                  "CLI sparse cloud on the sphere")
            check(clouds["sparse_points_ba"][0].shape == pts.shape, "CLI BA cloud")
            check(dpts.shape[0] > 10000 and dmed < 0.02 and dp90 < 0.06,
                  "CLI dense cloud on the sphere")
            check(clouds["all_patches"][1] is not None, "CLI dense colors")

    log(f"stage walls on {smi}: " + json.dumps({
        "sfm_s": wall, "sfm_plain_s": plain_wall_sfm, "ba_s": ba_wall,
        "mvs_s": mvs_wall, "mvs_plain_s": plain_wall,
        "mvs_profiled_s": prof["wall_s"], "mvs_device_busy_ms": prof["busy_ms"],
        "mvs_k2_ms": prof["k2_ms"], "mvs_k2_share": prof["k2_ms"] / 1e3 / prof["wall_s"],
        "mvs_rounds": dense.metrics.values["mvs_rounds"],
        "dense_points": dense.num_points, "dense_points_plain": plain.num_points,
    }))

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
         "samples_fractional": img_f.numel(),
         "launches_mvs": launches_mvs,
         "mvs_share": prof["k2_ms"] / 1e3 / prof["wall_s"],
         "max_abs_err_mvs_round": k2_round["max_abs_err"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
