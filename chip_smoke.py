#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels and the track store from the sources, holds
each kernel against its plain PyTorch version at the shapes of the main
path (K4, the grayscale conversion, against the host conversion over all
2^24 RGB triples and on shapes and alignments off the main path, one
device kernel a call, one launch in SfM and none in MVS; K2 also at the
centres of one expansion round and at non-finite centres, on the
in-bounds limits, at M = 1, 7 and 163,843, at wid 0, 2 and
8 and on guarded and odd-width stacks, with its mask held to the plain
``_inbounds`` and one device kernel per call; K1 also on an odd width, on
tiny images, on a 4-byte-aligned stack and on non-integer gray), drives the
main path on a rendered 48-frame 640x480
textured-sphere ring -- the SfM stage, points-only bundle adjustment and
dense MVS at the CLI defaults, each as a library call with the launch
counts read around it, then the CLI's default ``--stages sfm,ba,mvs`` --
times the kernels and the stages (with a torch.profiler table of one MVS
run).  Then the multi-device path: K2s (the sharded K2 wrapper) bit-equal
to one K2 call on 4 virtual shards of the card, the three stages on that
4-shard mesh held to the unsharded results (both also over 2 GPUs and
over every GPU, and K1 and K2 on a second GPU while the first is current,
where there are two or more: ``chiprun --chips 4 -- python3 chip_smoke.py``
drives those branches), where K2s's time goes (host enqueue, device
kernels), and the CLI with ``--mesh_devices 4``.  Then K3 (the tile-resident
sampler) in its three modes against its plain versions and K2, the staging
route each of its input sets took (by the device kernel's name: the
tensor-map kernel on 640-wide stacks, the per-row kernel on an odd
width), and K3's entry point
``sfm_tpu_torch.tools.prof_tile``; MVS with the outlier filter
(its K2 launch counted, the device filter held to the host oracle); MVS
killed after two rounds and resumed from its checkpoint, and the CLI with
``--checkpoint_dir`` then ``--stages mvs`` alone; joint bundle adjustment
with both camera solvers.  Then all-pairs mode: SfM over the ring's 1,128
pairs (K1 and K2 counted, peak device memory against the pair program's
chunk budget, and once more in a single chunk), points-only and joint BA
and MVS on its tracks, and the sequential stage forced into three chunks;
and the CLI with ``--nonSequence --profile_dir`` (plus ``--debug --plot``
where matplotlib is installed), whose trace must name K1's and K2's device
kernels.  Then the scale envelope: the 96-frame 1280x960 stress ring
through ``sfm_tpu_torch.tools.stress_scale`` (K1 bit-equal on the whole
stack, K2 at its 393,216 descriptor centres and at one expansion round's;
SfM, BA and MVS held to the gates of the JAX package's ``STRESS_r05.json``,
a warm repeat, K1's and K2's kernel-only times at that shape), bundle
adjustment at 1M observations through ``sfm_tpu_torch.tools.ba_scale``
(each solve's rms held to ``BA_SCALE_r05.txt``'s, dense against PCG, 8
virtual shards against one device), and ``quality_torch.py``'s solver
parity on the reference's captured BA problem.  Then the mesh across
processes (phase 23): the ring through SfM, points-only and joint BA and
MVS in two processes of a gloo group on the card (this script again, with
``--rank SPEC``; one shard each), the two bit-identical and held to the
single-controller mesh of two virtual shards, with each rank's K1 / K2
launches counted; a one-process NCCL group moving an MVS round's tensors
and running BA, equal to the single-controller mesh; two NCCL processes
on one GPU refused by ``data_mesh()``; and, with two or more GPUs
(e.g. one host with four H100s), one NCCL process per GPU held to the
single-controller mesh over them.  Then the benchmark harness (phase 24):
``bench_torch.py`` in a process of its own on the ring written in
dinoRing's layout, once with three warm passes and once with joint bundle
adjustment; its tracks, rms and dense points held to phases 4 and 8 and
to an in-process MVS at its scale 10, its K1 / K2 launches and
kernel-only times read from its ``kernels`` block, and once more with
``--no-defer-fetch --no-seed-overlap`` (the same outputs).  Then the MVS
schedule (phase 25): one expansion round, a chunk of two and a backlog
split and merge under ``torch.cuda.set_sync_debug_mode("error")`` (no
host read in a round); at scales 1 and 10 the default (pipelined) loop
against the serial one (``overlap_seed_fetch`` off, a checkpoint every
round) and ``rounds_per_call`` 2 and 4 against the same chunk serial, the
clouds bit-identical, K2's launches those of the dispatch-ahead rule
(``enqueued_rounds``; every exact K2 launch check of phases 9, 12, 18, 23
and 24 is derived from it, the wasted rounds printed beside it), the
walls and the device busy share of each; phase 20 runs the pipelined
against the serial loop once on the stress ring.  Each of those six
phases prints its wall, and the script its whole wall.  It prints as its
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the exit code is nonzero.  Without CUDA, or without Pillow (the CLI
phases need it), it exits 1 and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
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
SHARDS = 4                                   # virtual shards of one card
# What this script read for the kernels' first designs (a 16 x 32 tile in
# shared memory for K1; one 2-byte load per tap and a mask of seven
# elementwise launches for K2)
# on an NVIDIA H100 80GB HBM3 at 700 W, the last time it ran on them:
# kernel-only ms, and the host microseconds and device kernels of one K2
# call.  Logged beside this run's numbers, never in the ``kernels`` line
# (that holds only what this run measured); nothing is checked against them.
# tools/bench_kernels.py times two versions of the sources in one process.
PARENT = {"k1_kernel_only_ms": 0.14676, "k2_int_kernel_only_ms": 0.0360,
          "k2_frac_kernel_only_ms": 0.11444,
          "k2_host_us_per_call": 144.0, "k2_device_kernels_per_call": 7.94}


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


def check_k1_shapes(dev):
    """K1 on shapes off the main path, bit-equal on integer gray: the CPU
    tests' 2 x 150 x 200; an odd width (4-byte loads and stores); images
    smaller than a thread's 4 columns and than the 3 x 3 support; a stack
    whose first element is only 4-byte aligned.  And on non-integer gray,
    where K1's separable box sums may differ from ``_box3``'s in their last
    bit (and det = sxx syy - sxy^2 amplifies that where it cancels): within
    1e-5 of the largest |R|."""
    import torch

    from sfm_tpu_torch.ops.harris import _harris_math, harris_response

    g = torch.Generator(device="cpu").manual_seed(3)
    for shape in ((2, 150, 200), (3, 37, 201), (1, 5, 3), (1, 2, 2), (2, 33, 128)):
        gray = torch.randint(0, 256, shape, generator=g).float().to(dev)
        check(torch.equal(harris_response(gray, 0.04), _harris_math(gray, 0.04)),
              f"K1 bit-equal on integer gray {shape}")
    n, h, w = 2, 64, 128
    buf = torch.randint(0, 256, (n * h * w + 1,), generator=g).float().to(dev)
    off = buf[1:].view(n, h, w)
    check(off.data_ptr() % 16 == 4, "the offset stack is 4-byte aligned")
    check(torch.equal(harris_response(off, 0.04), _harris_math(off, 0.04)),
          "K1 bit-equal on a stack that is not 16-byte aligned")
    real = (torch.rand((3, 150, 200), generator=g) * 255).to(dev)
    got, want = harris_response(real, 0.04), _harris_math(real, 0.04)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    rel = float(diff.max() / want.abs().max())
    check(rel <= 1e-5, f"K1 on non-integer gray: {rel} of max |R| > 1e-5")
    log(f"K1: bit-equal on integer gray at 2x150x200, 3x37x201, 1x5x3, 1x2x2, "
        f"2x33x128 and on a 4-byte-aligned stack; non-integer 3x150x200: "
        f"{int((diff > 0).sum())} of {diff.numel()} values differ, max "
        f"{rel:.3e} of max |R|")
    return {"nonint_rel_err": rel}


def all_rgb_triples():
    """Every (r, g, b) uint8 triple once, as one (1, 4096, 4096, 3) stack."""
    import numpy as np

    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    return rgb.astype(np.uint8).reshape(1, 4096, 4096, 3)


def host_gray(images):
    """The host route's values: ``np.rint(to_gray(x)).astype(np.uint8)`` as
    float32, what ``gray_tensor`` uploads and converts."""
    import numpy as np

    from sfm_tpu_torch.io.images import to_gray

    return np.rint(to_gray(images)).astype(np.uint8).astype(np.float32)


def check_k4(images):
    """K4 bit-equal to the host conversion over all 2^24 RGB triples and on
    the rendered stack ``images``, one launch a call.  Returns the uploaded
    uint8 RGB of ``images`` on the card (phase 6 times K4 on it)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.ops.gray import rgb_to_gray

    for what, x in (("all 2^24 RGB triples", all_rgb_triples()),
                    (f"the rendered {images.shape} stack", images)):
        before = rgb_to_gray.launches
        got = rgb_to_gray(torch.from_numpy(x).cuda()).cpu().numpy()
        check(rgb_to_gray.launches == before + 1, "K4 counted one launch")
        want = host_gray(x)
        bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        check(bad == 0, f"K4 on {what}: {bad} values differ from the host's")
        log(f"K4: bit-equal to the host conversion on {what}")
    return torch.from_numpy(images).cuda()


def check_k4_shapes(dev):
    """K4 off the main path, bit-equal to the host conversion: N = 1, odd H,
    W = 1, 3 and 641, pixel counts that leave pixels after the last whole
    512-pixel chunk (and fewer than 512 in all), a stack whose first byte
    is not 16-byte aligned (the one-by-one route); and inputs refused before
    any launch: non-contiguous, not uint8, wrongly shaped."""
    import numpy as np
    import torch

    from sfm_tpu_torch.ops.gray import rgb_to_gray

    rng = np.random.default_rng(4)
    shapes = ((1, 480, 640), (2, 37, 201), (3, 7, 5), (1, 5, 1), (2, 9, 3),
              (1, 33, 641), (1, 1, 1), (5, 1, 3))
    for n, h, w in shapes:
        x = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
        got = rgb_to_gray(torch.from_numpy(x).to(dev)).cpu().numpy()
        check(np.array_equal(got, host_gray(x)), f"K4 bit-equal at {(n, h, w)}")
    n, h, w = 2, 48, 64
    buf = torch.from_numpy(rng.integers(0, 256, n * h * w * 3 + 5,
                                        dtype=np.uint8)).to(dev)
    off = buf[5:].view(n, h, w, 3)
    check(off.data_ptr() % 16 == 5, "the offset stack is not 16-byte aligned")
    check(np.array_equal(rgb_to_gray(off).cpu().numpy(),
                         host_gray(off.cpu().numpy())),
          "K4 bit-equal on a stack that is not 16-byte aligned")
    good = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    before = rgb_to_gray.launches
    for what, bad, err in (
            ("non-contiguous", good[:, :, ::2], ValueError),
            ("float32", good.float(), TypeError),
            ("(N, H, W)", good[..., 0].contiguous(), TypeError),
            ("(N, H, W, 4)", torch.zeros((2, 8, 8, 4), dtype=torch.uint8,
                                         device=dev), TypeError)):
        try:
            rgb_to_gray(bad)
        except err:
            pass
        else:
            raise RuntimeError(f"check failed: K4 took a {what} input")
    check(rgb_to_gray.launches == before, "a refused input launched K4")
    log("K4: bit-equal at " + ", ".join("x".join(map(str, s)) for s in shapes)
        + " and on a stack at byte offset 5; non-contiguous, float32 and "
        "wrongly shaped inputs refused before any launch")


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


def limit_centres(h, w, wid, dev):
    """Centres exactly on the four in-bounds limits and one f32 step
    either side of each, the other coordinate mid-image."""
    import torch

    rows = []
    for lim, axis in ((wid + 1.0, 0), (w - wid - 2.0, 0),
                      (wid + 1.0, 1), (h - wid - 2.0, 1)):
        lim = torch.tensor(lim)
        for v in (lim, torch.nextafter(lim, torch.tensor(-1e30)),
                  torch.nextafter(lim, torch.tensor(1e30))):
            rows.append([float(v), h / 2] if axis == 0 else [w / 2, float(v)])
    return torch.tensor(rows, dtype=torch.float32, device=dev)


def check_k2_redesign(gray_bf16, img_f, ctr_f):
    """What K2's one-launch design adds to hold: the kernel's mask equal to
    the plain ``_inbounds`` on the limits and a float step either side;
    M = 1, 7 and 163,843 (a partial last block) bit-equal to the same rows
    of one larger call; wid 0, 2 and 8 on a small
    stack against the plain version; and the guarded and odd-width stacks of
    ``k3_cases`` for K2 itself (finite wherever the centre is: nothing read
    outside the stack)."""
    import torch

    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import _inbounds

    n, h, w = gray_bf16.shape
    dev = gray_bf16.device
    ctr = limit_centres(h, w, WID, dev)
    img = torch.arange(ctr.shape[0], dtype=torch.int32, device=dev) % n
    _, inb = sample_normalized_patches(gray_bf16, img, ctr, WID)
    want = _inbounds(ctr[:, 0], ctr[:, 1], h, w, WID)
    check(torch.equal(inb, want), "K2 mask on the limits equal to _inbounds")
    check(inb.view(4, 3).tolist() == [[True, False, True], [True, True, False]] * 2,
          f"K2 mask on / inside / outside the limits: {inb.view(4, 3).tolist()}")

    g = torch.Generator(device="cpu").manual_seed(4)
    img_r = torch.cat([img_f, torch.randint(0, n, (3,), generator=g,
                                            dtype=torch.int32).to(dev)])
    ctr_r = torch.cat([ctr_f, (torch.rand((3, 2), generator=g)
                               * torch.tensor([w - 1.0, h - 1.0])).to(dev)])
    full, full_inb = sample_normalized_patches(gray_bf16, img_r, ctr_r, WID)
    plain = _sample_plain(gray_bf16, img_r, ctr_r, WID)
    err = float((full.float() - plain.float()).abs().max())
    check(err <= K2_FRAC_ATOL, f"K2 at M = {img_r.numel()}: {err}")
    check(torch.equal(full_inb, _inbounds(ctr_r[:, 0], ctr_r[:, 1], h, w, WID)),
          f"K2 mask at M = {img_r.numel()}")
    for m in (1, 7):
        # the last m rows: another block, lane and store path than in `full`
        got, got_inb = sample_normalized_patches(
            gray_bf16, img_r[-m:].contiguous(), ctr_r[-m:].contiguous(), WID)
        check(torch.equal(got, full[-m:]) and torch.equal(got_inb, full_inb[-m:]),
              f"K2 at M = {m} bit-equal to the same rows of a larger call")

    small = (torch.rand((3, 40, 64), generator=g) * 255).to(dev).to(torch.bfloat16)
    img_s = torch.randint(0, 3, (4099,), generator=g, dtype=torch.int32).to(dev)
    ctr_s = ((torch.rand((4099, 2), generator=g) * torch.tensor([70.0, 46.0]) - 3.0)
             .to(dev).contiguous())
    errs = {}
    for wid in (0, 2, 8):
        got, got_inb = sample_normalized_patches(small, img_s, ctr_s, wid)
        want = _sample_plain(small, img_s, ctr_s, wid)
        check(torch.equal(got_inb, _inbounds(ctr_s[:, 0], ctr_s[:, 1], 40, 64, wid)),
              f"K2 wid {wid}: mask")
        if wid == 0:
            # a one-pixel patch is its own mean: 0 / max(0, 1e-8) = 0
            check(not bool(got.float().any()) and not bool(want.float().any()),
                  "K2 wid 0: zero descriptors")
        errs[wid] = float((got.float() - want.float()).abs().max())
        check(errs[wid] <= K2_FRAC_ATOL, f"K2 wid {wid}: {errs[wid]}")

    for name, gs, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        if name not in ("guarded edges", "odd width"):
            continue
        fin = torch.isfinite(ctr).all(dim=1)
        got, got_inb = sample_normalized_patches(gs, img, ctr, WID)
        want = _sample_plain(gs, img, ctr, WID)
        check(bool(torch.isfinite(got.float()[fin]).all()),
              f"K2 {name}: read outside the stack (NaN)")
        e = float((got.float() - want.float())[fin].abs().max())
        check(e <= K2_FRAC_ATOL, f"K2 {name}: {e} > {K2_FRAC_ATOL}")
        check(torch.equal(got_inb, _inbounds(ctr[:, 0], ctr[:, 1], gs.shape[1],
                                             gs.shape[2], WID)),
              f"K2 {name}: mask")
        errs[name] = e
    torch.cuda.synchronize()
    log("K2: mask equal to _inbounds on the limits and a float step either "
        f"side; M = 1, 7 bit-equal to rows of M = {img_r.numel()} (max abs err "
        f"{err:.3e} to the plain version); max abs err by wid / stack: "
        + json.dumps({str(k): v for k, v in errs.items()}))
    return {"max_abs_err": max(err, *errs.values())}


def k3_cases(gray_bf16, img_f, ctr_f):
    """The inputs K3 is held on, as (name, stack, img, ctr): the TPU tool's
    case (81,920 in-bounds centres on its random 48 x 480 x 640 stack); one
    expansion round's 163,840 fractional centres on the rendered ring; NaN,
    +-inf and huge centres plus samples on the first and last rows and
    columns of the first and last image, on a stack that lies between two
    NaN guard images (a read outside it turns the result NaN); and the same
    edges on an odd-width stack, whose rows are only 2-byte aligned."""
    import torch

    from sfm_tpu_torch.tools import prof_tile

    dev = gray_bf16.device
    yield ("tool case", *prof_tile.case_tensors(81920, dev))
    yield ("expansion round", gray_bf16, img_f, ctr_f)
    inf, nan = float("inf"), float("nan")
    bad = [[nan, 100], [100, nan], [nan, nan], [inf, 100], [-inf, 100],
           [100, inf], [100, -inf], [inf, -inf], [1e10, 100], [100, 1e10],
           [-1e10, -1e10], [3e9, -3e9], [-3e9, 3e9]]
    g = torch.Generator(device="cpu").manual_seed(2)
    for name, (n, h, w) in (("guarded edges", tuple(gray_bf16.shape)),
                            ("odd width", (3, 40, 201))):
        buf = torch.full((n + 2, h, w), nan, dtype=torch.bfloat16, device=dev)
        if name == "guarded edges":
            buf[1:-1] = gray_bf16
        else:
            buf[1:-1] = (torch.rand((n, h, w), generator=g) * 255).to(dev)
        k = 4096
        edge = torch.rand((k, 2), generator=g) * torch.tensor([w - 1.0, 14.0])
        edge[k // 2:, 1] += h - 15.0           # last rows; first rows above
        side = torch.rand((k, 2), generator=g) * torch.tensor([14.0, h - 1.0])
        side[k // 2:, 0] += w - 15.0           # last columns; first before
        ctr = torch.cat([edge, side, torch.tensor(bad)])
        img = torch.cat([
            torch.tensor([0, n - 1, 0, n - 1],
                         dtype=torch.int32).repeat_interleave(k // 2),
            torch.arange(len(bad), dtype=torch.int32) % n])
        yield name, buf[1:-1], img.to(dev), ctr.to(dev).contiguous()


def check_k3(gray_bf16, img_f, ctr_f):
    """K3 against its plain versions and against K2 on ``k3_cases``, at
    S in {8, 32, 128} in all three modes: copy-only bit-equal to the raw
    window; the full modes within K2_FRAC_ATOL of ``_sample_plain`` (one
    bf16 step at the descriptors' unit scale: only the order of the two
    sums differs) and finite wherever the centre is; reports whether the
    full modes are bit-equal to K2, whose arithmetic they share."""
    import torch

    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.gather_tile import (
        _copy_plain,
        sample_normalized_patches_tiled,
    )
    from sfm_tpu_torch.tools.prof_tile import modes

    out = {"max_abs_err": 0.0, "max_ulps": 0.0, "bit_equal_k2": True,
           "launches": 0}
    for name, g, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        fin = torch.isfinite(ctr).all(dim=1)
        want = {True: _sample_plain(g, img, ctr, WID)[fin],
                False: _copy_plain(g, img, ctr, WID)[fin]}
        k2 = sample_normalized_patches(g, img, ctr, WID)[0][fin]
        err = ulps = 0.0
        same = True
        for _, mode, S, kw in modes():
            before = sample_normalized_patches_tiled.launches
            got = sample_normalized_patches_tiled(g, img, ctr, WID, **kw)[fin]
            torch.cuda.synchronize()
            out["launches"] += sample_normalized_patches_tiled.launches - before
            check(bool(torch.isfinite(got.float()).all()),
                  f"K3 {name} S={S} {mode}: read outside the stack (NaN)")
            if not kw["extract"]:
                check(torch.equal(got, want[False]),
                      f"K3 {name} S={S} copy-only: not bit-equal to the window")
                continue
            e = float((got.float() - want[True].float()).abs().max())
            check(e <= K2_FRAC_ATOL, f"K3 {name} S={S} {mode}: {e} > {K2_FRAC_ATOL}")
            err, ulps = max(err, e), max(ulps, bf16_ulps(got, want[True]))
            same = same and torch.equal(got, k2)
        log(f"K3 {name}: {img.numel()} samples ({int((~fin).sum())} non-finite "
            f"centres) on {tuple(g.shape)}, 9 mode/S combinations: copy-only "
            f"bit-equal; full modes max abs err {err:.3e} ({ulps:.2f} bf16 "
            f"ulps) to the plain version, bit-equal to K2: {same}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_ulps"] = max(out["max_ulps"], ulps)
        out["bit_equal_k2"] = out["bit_equal_k2"] and same
    check(out["launches"] == 4 * 9, "K3 launches counted once per call")
    return out


# K3's device kernels by staging route (csrc/gather_tile.cu).
K3_KERNELS = {"tma": "gather_tile_tma_kernel",
              "rows": "gather_tile_rows_kernel"}


def device_kernel_names(fn, want=()):
    """Names of the device kernels one call of ``fn`` launches, under
    torch.profiler (``measure.profiled``).  With ``want``, kernel names
    one of which the call launches, a session that saw none of them lost
    its events and is taken again."""
    from sfm_tpu_torch.tools.measure import kernel_named, profiled

    def accept(_, kernels):
        return not want or any(kernel_named(e.name, base)
                               for e in kernels for base in want)

    _, kernels, _ = profiled(fn, accept, log=log, what="device kernel names")
    return {e.name for e in kernels}


def check_k3_routes(gray_bf16, img_f, ctr_f):
    """The staging route K3 took on each input set of ``k3_cases``, by the
    name of the device kernel one call launches: the tensor-map kernel on
    the three 640-wide stacks, the per-row kernel on the odd-width one, as
    ``tile_route`` (the wrapper's statement of the rule) says.  These calls
    are not among ``check_k3``'s 36.  Returns name -> route."""
    from sfm_tpu_torch.ops.gather_tile import (
        sample_normalized_patches_tiled,
        tile_route,
    )
    from sfm_tpu_torch.tools.measure import kernel_named

    routes = {}
    for name, g, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        want = "rows" if name == "odd width" else "tma"
        check(tile_route(g) == want, f"K3 {name}: tile_route {tile_route(g)}")
        names = device_kernel_names(
            lambda: sample_normalized_patches_tiled(g, img, ctr, WID),
            want=K3_KERNELS.values())
        seen = {route for route, base in K3_KERNELS.items()
                if any(kernel_named(n, base) for n in names)}
        check(seen == {want}, f"K3 {name}: device kernels {sorted(seen)}, "
              f"want {K3_KERNELS[want]}")
        routes[name] = want
    log("K3 staging route by input set (device kernel name): "
        + json.dumps({k: K3_KERNELS[v] for k, v in routes.items()}))
    return routes


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


def host_ms(fn, reps=7):
    """Median milliseconds of ``reps`` calls of ``fn``, each on the host's
    clock from a synced device to the sync after it (for calls whose work
    is mostly on the host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_and_device(fn, calls=50):
    """Where a call's time goes, per call: ``host_us`` to enqueue it (the
    host loop alone, nothing waited for), ``with_device_us`` to the sync
    after the loop, and under torch.profiler (``measure.profiled``) the
    device kernels it launches, whatever their names, and their summed
    device ms.  The calls are identical on identical inputs and so launch
    the same kernels: a session whose count is not a whole number a call
    lost events and is taken again."""
    import torch

    from sfm_tpu_torch.tools.measure import profiled

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def body():
        for _ in range(calls):
            fn()

    _, kern, _ = profiled(
        body, lambda _, kernels: len(kernels) > 0 and len(kernels) % calls == 0,
        log=log, what=f"{calls} identical calls")
    return {"host_us": (t1 - t0) / calls * 1e6,
            "with_device_us": (t2 - t0) / calls * 1e6,
            "launches": len(kern) / calls,
            "device_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3 / calls,
            "kernels": sorted({e.name[:48] for e in kern})}


def run_prof_tile(smi):
    """The tool's sweep through its entry point, as a user runs it, with
    K3's count set to 0 just before; returns (rows, launches)."""
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled
    from sfm_tpu_torch.tools import prof_tile

    sample_normalized_patches_tiled.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = prof_tile.main(["--m", "81920", "--iters", "20"])
    launches = sample_normalized_patches_tiled.launches
    log(f"python3 -m sfm_tpu_torch.tools.prof_tile --m 81920 --iters 20, on {smi}:")
    log(out.getvalue().rstrip())
    check(rc == 0, f"prof_tile exit code {rc}")
    rows = [json.loads(ln.split(": ", 1)[1]) for ln in out.getvalue().splitlines()
            if ln.startswith(("E0", "E1", "E2", "K2"))]
    check(len(rows) == 11, f"prof_tile printed {len(rows)} rows, not 11")
    check(launches > 0, "the tool's sweep launched K3 no time")
    with contextlib.redirect_stdout(out):
        rc = prof_tile.main(["--check"])
    check(rc == 0, "prof_tile --check failed")
    log("python3 -m sfm_tpu_torch.tools.prof_tile --check: CHECK OK")
    return rows, launches


def run_filtered_mvs(images, recon, hold_oracle):
    """MVS at the CLI defaults with the outlier filter, with the filter's
    K2 launches and samples counted inside its timer and, with
    ``hold_oracle``, the device filter's keep mask held to the host oracle
    on the same vis / proj (host seconds, inside the ``filter`` timer)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.mvs import pipeline
    from sfm_tpu_torch.mvs.filter import filter_outliers
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    seen = {}
    real_run, real_dev = pipeline._run_device_filter, pipeline.filter_outliers_device

    def counted_run(*a, **kw):
        before = sample_normalized_patches.launches
        keep = real_run(*a, **kw)
        seen["launches"] = sample_normalized_patches.launches - before
        return keep

    def held_to_oracle(pts, nrm, sco, vis, proj, valid, cell, gw, gh, **kw):
        keep, group, hits = real_dev(pts, nrm, sco, vis, proj, valid, cell,
                                     gw, gh, **kw)
        seen["samples"] = int(vis.shape[0]) * (kw["k_hit"] + 1 if kw["k_hit"]
                                               else vis.shape[1])
        if hold_oracle:
            t0 = time.perf_counter()
            want = filter_outliers(*(x.cpu().numpy() for x in
                                     (pts, nrm, sco, vis, proj)), cell, gw, gh)
            seen["oracle_s"] = time.perf_counter() - t0
            seen["oracle_equal"] = bool(np.array_equal(keep.cpu().numpy(), want))
            seen["incidences"] = int(vis.sum())
        return keep, group, hits

    pipeline._run_device_filter = counted_run
    pipeline.filter_outliers_device = held_to_oracle
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = dense_reconstruction(
            images, recon.calib, recon, MvsConfig(enable_outlier_filter=True),
            scale=1.0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline._run_device_filter = real_run
        pipeline.filter_outliers_device = real_dev
    return dense, wall, seen


def run_killed_and_resumed(images, recon, ckpt_dir, rounds=2):
    """MVS at the CLI defaults saving its state every round, killed after
    ``rounds`` rounds, then resumed from the file."""
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.mvs import pipeline
    from sfm_tpu_torch.utils import checkpoint

    real = pipeline.expansion_round
    calls = {"n": 0}

    def killing_round(*a, **kw):
        calls["n"] += 1
        if calls["n"] > rounds:
            raise KeyboardInterrupt("killed")
        return real(*a, **kw)

    kw = dict(scale=1.0, device="cuda", checkpoint_dir=ckpt_dir, checkpoint_every=1)
    pipeline.expansion_round = killing_round
    try:
        dense_reconstruction(images, recon.calib, recon, MvsConfig(), **kw)
        check(False, "the killed MVS run ran to its end")
    except KeyboardInterrupt:
        pass
    finally:
        pipeline.expansion_round = real
    state = checkpoint.load_mvs_state(ckpt_dir)
    check(state is not None and int(state["counters"][1]) == rounds,
          f"no MVS state of round {rounds} on disk")
    size = os.path.getsize(os.path.join(ckpt_dir, checkpoint.MVS_STATE_FILE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = dense_reconstruction(images, recon.calib, recon, MvsConfig(), **kw)
    torch.cuda.synchronize()
    check(checkpoint.load_mvs_state(ckpt_dir) is None,
          "the finished run left its mid-run state")
    return dense, time.perf_counter() - t0, size


def run_joint_ba(recon, max_cams):
    """Joint BA (f32) on a copy of ``recon``: dense Schur when ``max_cams``
    admits the rig, PCG when it does not."""
    import torch

    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig

    cfg = BaConfig(dtype="float32", refine_cameras=True,
                   dense_schur_max_cams=max_cams)
    bundle_adjust(sparse_copy(recon), cfg, device="cuda")  # warm
    rec = sparse_copy(recon)
    before = rec.rms_reprojection_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, info = bundle_adjust(rec, cfg, device="cuda")
    torch.cuda.synchronize()
    return rec, info, before, time.perf_counter() - t0


def sphere_bounds(world):
    import numpy as np

    r = np.abs(np.linalg.norm(world, axis=1) - 1.0)
    return float(np.median(r)), float(np.percentile(r, 95))


def run_sfm(images, calib, kernels, mesh=None, pair_mode="sequence"):
    import torch

    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig, SfmConfig
    from sfm_tpu_torch.sfm import structure_from_motion

    cfg = PipelineConfig(sfm=SfmConfig(pair_mode=pair_mode),
                         runtime=RuntimeConfig(device="cuda", kernels=kernels))
    # A fresh copy misses the per-process grayscale cache (io.device_gray),
    # so the stage pays its conversion and upload, as a first stage does.
    images = images.copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg, mesh=mesh)
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


def run_ba(recon, mesh=None):
    import torch

    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig

    before = recon.rms_reprojection_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon, info = bundle_adjust(recon, BaConfig(dtype="float32"), mesh=mesh,
                                device="cuda")
    torch.cuda.synchronize()
    return recon, info, before, time.perf_counter() - t0


def run_mvs(images, recon, kernels, mesh=None):
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = dense_reconstruction(images, recon.calib, recon, MvsConfig(),
                                 scale=1.0, mesh=mesh, device="cuda",
                                 kernels=kernels)
    torch.cuda.synchronize()
    return dense, time.perf_counter() - t0


def enqueued_rounds(rounds, total, seeds, cfg, serial=False, backlog_left=0):
    """(rounds enqueued, rounds enqueued and never read) of one fresh MVS
    stage that read ``rounds`` rounds and accepted ``total`` patches from
    ``seeds`` seeds at ``cfg``, by the rule of the host loop
    (``mvs/pipeline.py``, the JAX package's): every chunk of
    ``rounds_per_call`` rounds it read from, whole, plus the next chunk
    where the loop enqueued it ahead of the read that ended the stage.
    That happens only where the stage stopped on a dry round with no
    backlog (not on a budget) and, at that read, no checkpoint was due
    (``serial``), rounds + chunk < max_rounds and total + chunk * cap <
    max_patches, with total then between the seeds and the final total.
    Each enqueued round is one K2 sweep.  Raises where those bounds cannot
    decide it."""
    k = max(cfg.rounds_per_call, 1)
    chunks = -(-rounds // k)
    enqueued = chunks * k
    ended_on_budget = rounds >= cfg.max_rounds or total >= cfg.max_patches
    if serial or ended_on_budget or backlog_left:
        return enqueued, enqueued - rounds
    before = (chunks - 1) * k
    room = cfg.max_patches - k * cfg.round_capacity
    if before + k >= cfg.max_rounds or seeds >= room:
        ahead = 0
    elif total < room:
        ahead = k
    else:
        raise RuntimeError(f"dispatch-ahead undecidable: {seeds} <= total "
                           f"before the last read <= {total}, limit {room}")
    return enqueued + ahead, enqueued + ahead - rounds


def dense_bounds(points, normals):
    import numpy as np

    r = np.abs(np.linalg.norm(points, axis=1) - 1.0)
    outward = float((np.einsum("ij,ij->i", normals, points) > 0).mean())
    return float(np.median(r)), float(np.percentile(r, 90)), outward


def profile_mvs(images, recon, smi):
    """One MVS run under torch.profiler: K2's device time and every
    kernel's, summed, and a table by device and by host time.  A session
    that did not see one K2 kernel for each of the run's K2 launches lost
    events and is taken again (``measure.profiled``)."""
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.tools.measure import kernel_named, profiled

    def body():
        sample_normalized_patches.launches = 0
        dense, wall = run_mvs(images, recon, kernels=None)
        return dense, wall, sample_normalized_patches.launches

    def k2(kernels):
        return [e for e in kernels if kernel_named(e.name, "gather_kernel")]

    (dense, wall, launches), kernels, prof = profiled(
        body, lambda r, kernels: len(k2(kernels)) == r[2] > 0, log=log,
        what="MVS under the profiler")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k2_ms = sum(e.time_range.elapsed_us() for e in k2(kernels)) / 1e3
    ka = prof.key_averages()
    log(f"one MVS stage under the profiler: wall {wall:.4f} s, "
        f"{dense.num_points} points, on {smi}")
    log(ka.table(sort_by="self_cuda_time_total", row_limit=25))
    log(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    log(f"MVS profiled: wall {wall:.4f} s, device kernels busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / 1e3 / wall:.1f} % of the wall), K2 {k2_ms:.3f} ms "
        f"in {launches} kernels")
    return {"wall_s": wall, "busy_ms": busy_ms, "k2_ms": k2_ms}


def check_second_gpu(gray, k2_in):
    """K1 and K2 on cuda:1 while cuda:0 is current, against their plain
    versions there (each wrapper launches on its tensor's device).  Returns
    None, and logs the skip, below two GPUs."""
    import torch

    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response

    if torch.cuda.device_count() < 2:
        log("K1/K2 on a second GPU: skipped (one GPU)")
        return None
    dev = torch.device("cuda", 1)
    g1 = gray.to(dev)
    (_, _), (img_f, ctr_f) = k2_in
    img, ctr = img_f.to(dev), ctr_f.to(dev)
    with torch.cuda.device(0):
        resp = harris_response(g1, 0.04)
        resp_plain = _harris_math(g1, 0.04)
        desc, inb = sample_normalized_patches(g1.to(torch.bfloat16), img, ctr, WID)
        plain = _sample_plain(g1.to(torch.bfloat16), img, ctr, WID)
        torch.cuda.synchronize(dev)
        check(torch.cuda.current_device() == 0, "current device moved")
    check(resp.device == dev and torch.equal(resp, resp_plain),
          "K1 on cuda:1 bit-equal to the plain version")
    err = float((desc.float() - plain.float()).abs().max())
    check(desc.device == dev and err <= K2_FRAC_ATOL, f"K2 on cuda:1: {err}")
    log(f"K1/K2 on cuda:1 with cuda:0 current: K1 bit-equal, K2 max abs err "
        f"{err:.3e}, in-bounds {int(inb.sum())}")
    return {"k2_max_abs_err": err}


def check_k2_sharded(gray_bf16, img_f, ctr_f):
    """K2s against one K2 call (bit-equal) and against the plain version,
    at the MVS round's 163,840 samples and at 163,843 (the pad path), on
    SHARDS virtual shards of cuda:0 and, with two or more GPUs, over all of
    them; one K2 launch per shard.  Times K2s on the virtual shards and
    one K2 call at the round shape."""
    import torch

    from sfm_tpu_torch.ops.gather import (
        _sample_plain,
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.parallel import DataMesh, data_mesh

    n, h, w = gray_bf16.shape
    dev = gray_bf16.device
    g = torch.Generator(device="cpu").manual_seed(1)
    extra_img = torch.randint(0, n, (3,), generator=g, dtype=torch.int32)
    extra_ctr = torch.rand((3, 2), generator=g) * torch.tensor([w - 1.0, h - 1.0])
    ragged = (torch.cat([img_f, extra_img.to(dev)]),
              torch.cat([ctr_f, extra_ctr.to(dev)]).contiguous())
    meshes = [DataMesh([dev] * SHARDS)]
    if torch.cuda.device_count() >= 2:
        meshes.append(data_mesh())
    else:
        log("K2s over every GPU: skipped (one GPU)")
    err = err_plain = 0.0
    for mesh in meshes:
        reps = mesh.replicate(gray_bf16)
        for name, (img, ctr) in (("round", (img_f, ctr_f)), ("ragged", ragged)):
            want, inb_want = sample_normalized_patches(gray_bf16, img, ctr, WID)
            plain = _sample_plain(gray_bf16, img, ctr, WID)
            before = sample_normalized_patches_sharded.launches
            got, inb = sample_normalized_patches_sharded(reps, img, ctr, WID, mesh)
            launched = sample_normalized_patches_sharded.launches - before
            for d in dict.fromkeys(mesh.devices):
                torch.cuda.synchronize(d)
            check(launched == mesh.size, f"K2s launched {launched} times on "
                  f"{mesh.size} shards")
            check(torch.equal(got, want) and torch.equal(inb, inb_want),
                  f"K2s ({name}, {mesh}) bit-equal to one K2 call")
            e = float((got.float() - want.float()).abs().max())
            ep = float((got.float() - plain.float()).abs().max())
            check(ep <= K2_FRAC_ATOL, f"K2s against the plain version: {ep}")
            err, err_plain = max(err, e), max(err_plain, ep)
            log(f"K2s on {mesh}: {img.numel()} samples, bit-equal to one K2 "
                f"call, {launched} launches, max abs err to the plain version "
                f"{ep:.3e}")
    mesh = meshes[0]
    reps = mesh.replicate(gray_bf16)
    t = {
        "ms": cuda_ms(lambda: sample_normalized_patches_sharded(
            reps, img_f, ctr_f, WID, mesh)),
        "single_call_ms": cuda_ms(lambda: sample_normalized_patches(
            gray_bf16, img_f, ctr_f, WID)),
    }
    log(f"K2s at {img_f.numel()} samples on {SHARDS} virtual shards vs one K2 "
        f"call, ms: " + json.dumps({k: round(v, 4) for k, v in t.items()}))
    where = {}
    for what, fn in (
            ("one K2 call", lambda: sample_normalized_patches(
                gray_bf16, img_f, ctr_f, WID)),
            (f"K2s on {SHARDS} virtual shards",
             lambda: sample_normalized_patches_sharded(
                 reps, img_f, ctr_f, WID, mesh))):
        where[what] = host_and_device(fn)
        log(f"attribution, {what} at {img_f.numel()} samples: "
            + json.dumps(where[what]))
    one = where["one K2 call"]
    log(f"one K2 call: {one['launches']} device kernels, host "
        f"{one['host_us']:.1f} us, with the device {one['with_device_us']:.1f} us "
        f"(first design: {PARENT['k2_device_kernels_per_call']} kernels, "
        f"{PARENT['k2_host_us_per_call']} us of host time)")
    check(one["launches"] == 1.0,
          f"a K2 call is {one['launches']} device kernels, not 1")
    return {"max_abs_err": err, "max_abs_err_plain": err_plain,
            "gpus": len(dict.fromkeys(meshes[-1].devices)), **t,
            "one_call": one}


def sparse_copy(r):
    """A SparseReconstruction with its own copy of the world points (BA
    refines them in place)."""
    from sfm_tpu_torch.sfm.pipeline import SparseReconstruction

    return SparseReconstruction(calib=r.calib, world=r.world.copy(),
                                track_offsets=r.track_offsets,
                                track_obs=r.track_obs)


def run_stages_on_mesh(mesh, images, calib, unsharded):
    """SfM, BA and MVS through the library over ``mesh``, each stage on the
    input its unsharded phase (4, 8, 9) had and held to that phase's result
    (``unsharded``); one warm-up run, then the timed run with the launch
    counts set to 0 just before it.  Logs every difference."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.ops.gather import (
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.ops.harris import harris_response

    counted = (harris_response, sample_normalized_patches,
               sample_normalized_patches_sharded)

    def zero_counts():
        for fn in counted:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counted}

    n = mesh.size
    sparse4, dense = unsharded["sparse"], unsharded["dense"]
    info, rms_after = unsharded["ba_info"], unsharded["ba_rms"]
    run_sfm(images, calib, kernels=True, mesh=mesh)
    zero_counts()
    srecon, s_wall = run_sfm(images, calib, kernels=True, mesh=mesh)
    l_sfm = counts()
    same_obs = (srecon.num_observations == sparse4.num_observations
                and np.array_equal(srecon.track_obs, sparse4.track_obs))
    world_diff = (float(np.abs(srecon.world - sparse4.world).max())
                  if same_obs else float("nan"))
    mv = srecon.metrics.values
    med, p95 = sphere_bounds(srecon.world)
    log(f"SfM on {mesh}: {srecon.num_tracks} tracks (unsharded "
        f"{sparse4.num_tracks}), track_obs equal {same_obs}, world max diff "
        f"{world_diff:.3e}, pair reproj {mv['mean_pair_reprojection_error_px']:.4f} "
        f"px, sphere median {med:.2e} p95 {p95:.2e}; wall {s_wall:.4f} s "
        f"(unsharded {unsharded['sfm_s']:.4f} s); launches {l_sfm}; timers "
        + json.dumps({k: round(v, 4) for k, v in srecon.timers.times.items()}))
    check(l_sfm["harris_response"] == n and l_sfm["sample_normalized_patches"] == n,
          f"SfM on {n} shards: one K1 and one K2 launch per shard")
    check(abs(srecon.num_tracks - sparse4.num_tracks) <= 0.005 * sparse4.num_tracks,
          "sharded SfM track count within 0.5 %")
    check(srecon.num_tracks > 500 and mv["mean_pair_reprojection_error_px"] < 0.3
          and med < 0.01 and p95 < 0.05, "sharded SfM gates")

    run_ba(sparse_copy(sparse4), mesh=mesh)
    zero_counts()
    brecon, binfo, _, b_wall = run_ba(sparse_copy(sparse4), mesh=mesh)
    b_rms = brecon.rms_reprojection_error()
    log(f"BA on {mesh}: {binfo['iterations']} iterations (unsharded "
        f"{info['iterations']}), rms after {b_rms:.6f} px (unsharded "
        f"{rms_after:.6f}, diff {abs(b_rms - rms_after):.2e}), final cost "
        f"{binfo['final_cost']:.6g} (unsharded {info['final_cost']:.6g}); wall "
        f"{b_wall:.4f} s (unsharded {unsharded['ba_s']:.4f} s); launches "
        f"{counts()}")
    check(binfo["iterations"] == info["iterations"], "sharded BA iterations")
    check(abs(b_rms - rms_after) <= 1e-4, "sharded BA rms within 1e-4 px")

    run_mvs(images, unsharded["ba_recon"], kernels=None, mesh=mesh)
    zero_counts()
    sdense, sm_wall = run_mvs(images, unsharded["ba_recon"], kernels=None,
                              mesh=mesh)
    l_mvs = counts()
    rounds = sdense.metrics.values["mvs_rounds"]
    med, p90, outward = dense_bounds(sdense.points, sdense.normals)
    log(f"MVS on {mesh}: {sdense.num_seeds} seeds (unsharded {dense.num_seeds}) "
        f"-> {sdense.num_points} points (unsharded {dense.num_points}, diff "
        f"{sdense.num_points - dense.num_points:+d}) in {rounds} rounds; "
        f"|c|-1 median {med:.2e} p90 {p90:.2e}; n.c > 0 share {outward:.4f}; "
        f"wall {sm_wall:.4f} s (unsharded {unsharded['mvs_s']:.4f} s); "
        f"launches {l_mvs}; timers "
        + json.dumps({k: round(v, 4) for k, v in sdense.timers.times.items()}))
    check(sdense.num_seeds == dense.num_seeds, "sharded MVS seeds equal")
    check(abs(sdense.num_points - dense.num_points) <= 0.01 * dense.num_points,
          "sharded MVS dense count within 1 %")
    check(med < 0.02 and p90 < 0.06 and outward > 0.9, "sharded MVS sphere bounds")
    # Every sweep goes through K2s's launch step; seeding's is one shard.
    # A round enqueued ahead and never read sweeps too.
    enq, wasted = enqueued_rounds(rounds, sdense.metrics.values["mvs_num_points"],
                                  sdense.num_seeds, MvsConfig())
    log(f"MVS on {mesh}: {rounds} rounds read, {enq} enqueued ({wasted} wasted)")
    check(l_mvs["sample_normalized_patches_sharded"] == 1 + n * enq
          and l_mvs["sample_normalized_patches"] == 1 + n * enq,
          f"K2 once per shard per expansion sweep (plus the unsharded seeding): "
          f"{l_mvs}, {enq} rounds enqueued, {wasted} wasted")
    check(l_mvs["harris_response"] == 0, "MVS launched K1")
    return {"sfm_s": s_wall, "ba_s": b_wall, "mvs_s": sm_wall,
            "sfm_pair_geometry_s": srecon.timers.times["pair_geometry"],
            "mvs_rounds": rounds, "sfm_launches": l_sfm, "mvs_launches": l_mvs}


def mean_track_length(recon):
    return recon.num_observations / max(recon.num_tracks, 1)


@contextlib.contextmanager
def budget_patched(pairs):
    """A context in which a chunk of the pair program holds ``pairs`` pairs
    (the chunk budget set to that many pairs' working set)."""
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.sfm import pipeline

    per_pair = pipeline.pair_working_bytes(PipelineConfig())
    real = pipeline.chunk_budget_bytes
    pipeline.chunk_budget_bytes = lambda device: pairs * per_pair
    try:
        yield
    finally:
        pipeline.chunk_budget_bytes = real


def sfm_resident_bytes(cfg, n, h, w, n_pairs):
    """What the SfM stage holds besides a chunk of the pair program: the
    gray stack (f32 and its bf16 copy), K1's response, the feature set,
    RANSAC's uniforms (f64) and the pair outputs."""
    k, m = cfg.features.max_corners, cfg.features.max_matches
    d = (2 * cfg.features.desc_wid + 1) ** 2
    return (n * h * w * (4 + 2 + 4) + n * k * (8 + 1 + 4 * d)
            + n_pairs * cfg.ransac.num_hypotheses * 8 * 8
            + n_pairs * (m * 8 * 4 + 4 * 4 + 9 * 4))


def run_allpairs(images, calib, seq4, smi):
    """Phase 18: all-pairs SfM (1,128 pairs on 48 frames) at the CLI
    defaults with the CUDA kernels, K1 / K2 counted from 0 around the stage
    and the peak device memory reset before it; the same stage with every
    pair in one chunk (its peak measured; skipped, with its reason logged,
    where the estimate exceeds the free memory); points-only and joint BA and MVS on its result; and the
    sequential problem forced into >= 3 chunks, held to phase 4's."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig, PipelineConfig
    from sfm_tpu_torch.ops.gather import (
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.ops.harris import harris_response
    from sfm_tpu_torch.sfm import pipeline

    counted = (harris_response, sample_normalized_patches,
               sample_normalized_patches_sharded)

    def zero_counts():
        for fn in counted:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counted}

    dev = torch.device("cuda")
    cfg = PipelineConfig()
    n, h, w = images.shape[:3]
    n_pairs = n * (n - 1) // 2
    per_pair = pipeline.pair_working_bytes(cfg)
    budget = pipeline.chunk_budget_bytes(dev)
    resident = sfm_resident_bytes(cfg, n, h, w, n_pairs)
    out = {"pairs": n_pairs, "per_pair_bytes": per_pair,
           "chunk_budget_bytes": budget, "resident_bytes": resident,
           "pairs_per_chunk": pipeline.pairs_per_chunk(cfg, dev)}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    recon, wall = run_sfm(images, calib, kernels=True, pair_mode="combination")
    out["launches"] = counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    mv = recon.metrics.values
    med, p95 = sphere_bounds(recon.world)
    out.update(sfm_s=wall, chunks=mv["pair_chunks"], tracks=recon.num_tracks,
               observations=recon.num_observations,
               mean_track_length=mean_track_length(recon),
               longest_track=int(recon.track_lengths().max()),
               pair_reproj_px=mv["mean_pair_reprojection_error_px"],
               sphere_median=med, sphere_p95=p95,
               timers={k_: round(v, 4) for k_, v in recon.timers.times.items()})
    log(f"all-pairs SfM (kernels) on {smi}: " + json.dumps(out))
    check(mv["num_pairs"] == n_pairs, f"all-pairs ran {mv['num_pairs']} pairs")
    check(out["launches"]["harris_response"] == 1
          and out["launches"]["sample_normalized_patches"] == 1,
          f"all-pairs SfM launches {out['launches']}: not one K1 and one K2")
    # More pairs link more observations into longer tracks; the track
    # store also drops a track whose new point strays past the merge
    # threshold (the reference's invalidate-on-violation), which wide
    # baselines do more often, so the track count itself may fall.
    check(recon.num_tracks > 500 and recon.num_observations >= seq4.num_observations,
          f"all-pairs: {recon.num_tracks} tracks, {recon.num_observations} "
          f"observations (sequential {seq4.num_observations})")
    check(out["mean_track_length"] > mean_track_length(seq4),
          "all-pairs tracks are not longer than the sequential ones")
    check(mv["mean_pair_reprojection_error_px"] < 0.3, "all-pairs pair reproj")
    check(med < 0.01 and p95 < 0.05, f"all-pairs sphere bounds {med} {p95}")
    check(out["peak_bytes"] <= budget + resident,
          f"all-pairs peak {out['peak_bytes']} > chunk budget {budget} + "
          f"resident {resident}")

    # Where the stage's device time goes, under torch.profiler: a session
    # that did not see the stage's one K1 and one K2 kernel lost events.
    from sfm_tpu_torch.tools.measure import kernel_named, profiled

    def one_each(_, kernels):
        return all(sum(kernel_named(e.name, base) for e in kernels) == 1
                   for base in ("harris_kernel", "gather_kernel"))

    (_, p_wall), kern, _ = profiled(
        lambda: run_sfm(images, calib, kernels=True, pair_mode="combination"),
        one_each, log=log, what="all-pairs SfM under the profiler")
    by_name = {}
    for e in kern:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["profiled"] = {"wall_s": p_wall,
                       "device_busy_ms": sum(by_name.values()),
                       "top_device_ms": [[k_, round(v, 3)] for k_, v in top]}
    log("all-pairs SfM under the profiler: " + json.dumps(out["profiled"]))

    # Every pair in one chunk: the working set the chunking bounds.  Run
    # only where the code's own estimate of it fits the free memory (said
    # on a line of its own when it does not); an out-of-memory error in a
    # run that was judged to fit fails like any other.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    need = per_pair * n_pairs + resident
    free = torch.cuda.mem_get_info(dev)[0]
    if need > free:
        unchunked = {"skipped": f"estimated {need} bytes > {free} free"}
        log(f"all-pairs SfM in one chunk: skipped, its estimated {need} bytes "
            f"({n_pairs} pairs x {per_pair} + {resident} resident) exceed the "
            f"{free} bytes free")
    else:
        with budget_patched(n_pairs):
            one, one_wall = run_sfm(images, calib, kernels=True,
                                    pair_mode="combination")
        same = (one.num_observations == recon.num_observations
                and np.array_equal(one.track_obs, recon.track_obs))
        unchunked = {"sfm_s": one_wall, "chunks": one.metrics.values["pair_chunks"],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "estimated_bytes": need, "free_bytes": free,
                     "tracks": one.num_tracks, "track_obs_equal": same,
                     "pair_geometry_s": one.timers.times["pair_geometry"]}
        check(abs(one.num_tracks - recon.num_tracks) <= 0.005 * recon.num_tracks,
              "one chunk and chunked all-pairs tracks within 0.5 %")
    torch.cuda.empty_cache()
    out["unchunked"] = unchunked
    log(f"all-pairs SfM in one chunk of {n_pairs} pairs: " + json.dumps(unchunked))

    # Points-only BA, then joint BA, on the all-pairs tracks.
    base = sparse_copy(recon)
    brecon, binfo, rms_before, b_wall = run_ba(sparse_copy(recon))
    rms_after = brecon.rms_reprojection_error()
    out["ba"] = {"iterations": binfo["iterations"], "rms_before_px": rms_before,
                 "rms_after_px": rms_after, "wall_s": b_wall}
    log("all-pairs points-only BA: " + json.dumps(out["ba"]))
    check(rms_after < 0.3 and rms_after <= rms_before, "all-pairs BA rms")
    torch.cuda.reset_peak_memory_stats()
    jrec, jinfo, j_before, j_wall = run_joint_ba(base, 256)
    out["joint_ba"] = {
        "camera_solver": jinfo["camera_solver"],
        "decided_by": jinfo["ba_dense_schur_decided_by"],
        "pairs": jinfo["ba_dense_schur_pairs"],
        "pair_bytes": jinfo["ba_dense_schur_pair_bytes"],
        "grid_bytes": jinfo["ba_dense_schur_grid_bytes"],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "iterations": jinfo["iterations"], "rms_before_px": j_before,
        "rms_refined_px": jinfo["rms_reproj_refined_px"],
        "points_only_refined_px": binfo["rms_reproj_refined_px"],
        "wall_s": j_wall, "solve_s": jinfo["timers"]["solve"]}
    log("all-pairs joint BA: " + json.dumps(out["joint_ba"]))
    check(jinfo["camera_solver"] == "dense_schur",
          f"all-pairs joint BA solver {jinfo['camera_solver']}")
    check(jinfo["rms_reproj_refined_px"] <= binfo["rms_reproj_refined_px"] + 1e-4,
          "all-pairs joint optimum above the points-only one")

    # MVS on the points-only result, with the phase-9 gates.
    zero_counts()
    dense, m_wall = run_mvs(images, brecon, kernels=None)
    l_mvs = counts()
    med, p90, outward = dense_bounds(dense.points, dense.normals)
    out["mvs"] = {"seeds": dense.num_seeds, "points": dense.num_points,
                  "rounds": dense.metrics.values["mvs_rounds"], "wall_s": m_wall,
                  "median": med, "p90": p90, "outward": outward,
                  "launches": l_mvs}
    enq, out["mvs"]["wasted_rounds"] = enqueued_rounds(
        out["mvs"]["rounds"], dense.metrics.values["mvs_num_points"],
        dense.num_seeds, MvsConfig())
    log("all-pairs MVS: " + json.dumps(out["mvs"]))
    check(l_mvs["sample_normalized_patches"] == 1 + enq
          and l_mvs["harris_response"] == 0,
          f"all-pairs MVS launches {l_mvs}: not 1 + {enq} rounds enqueued")
    check(dense.num_points > 10000 and med < 0.02 and p90 < 0.06
          and outward > 0.9, "all-pairs MVS dense gates")

    # The sequential problem forced into >= 3 chunks.
    with budget_patched(16):
        srecon, s_wall = run_sfm(images, calib, kernels=True)
    chunks = srecon.metrics.values["pair_chunks"]
    same = np.array_equal(srecon.track_obs, seq4.track_obs)
    out["sequential_chunked"] = {"chunks": chunks, "tracks": srecon.num_tracks,
                                 "phase4_tracks": seq4.num_tracks,
                                 "track_obs_equal": same, "sfm_s": s_wall}
    log("sequential SfM in chunks of 16 pairs: " + json.dumps(out["sequential_chunked"]))
    check(chunks >= 3, f"sequential run in {chunks} chunks")
    check(abs(srecon.num_tracks - seq4.num_tracks) <= 0.005 * seq4.num_tracks,
          "chunked sequential tracks within 0.5 % of phase 4's")
    return out


def run_cli_flags(ds, par, tmp):
    """Phase 19: the CLI with --nonSequence and --profile_dir (plus --debug
    and --plot where matplotlib imports) on phase 10's dataset; the trace
    must name K1's and K2's device kernels."""
    from sfm_tpu_torch.cli import TRACE_FILE
    from sfm_tpu_torch.cli import main as cli_main
    from sfm_tpu_torch.io.ply import read_ply
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.ops.harris import harris_response
    from sfm_tpu_torch.tools.measure import kernel_named

    try:
        import matplotlib  # noqa: F401
        figures = True
    except ImportError:
        figures = False
    out, prof = os.path.join(tmp, "out_flags"), os.path.join(tmp, "prof")
    flags = ["--nonSequence", "--profile_dir", prof]
    if figures:
        flags += ["--debug", "--plot"]
    log(f"CLI flags phase: {' '.join(flags)} (matplotlib "
        f"{'imports' if figures else 'is not installed: --debug, --plot skipped'})")
    harris_response.launches = sample_normalized_patches.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(["-img_p", ds, "-par_p", par, "-t", "png", "--out_dir", out]
                  + flags)
    wall = time.perf_counter() - t0
    launched = {"harris_kernel": harris_response.launches,
                "gather_kernel": sample_normalized_patches.launches}
    check(rc == 0, f"CLI {' '.join(flags)} exit code {rc}")
    sizes = {}
    for name in ("sparse_points", "sparse_points_ba", "initial_patches",
                 "all_patches"):
        sizes[name] = read_ply(os.path.join(out, name + ".ply"))[0].shape[0]
    check(min(sizes.values()) > 0, f"CLI PLY files {sizes}")
    path = os.path.join(prof, TRACE_FILE)
    with open(path) as fh:
        trace = json.load(fh)
    kernels = [e.get("name", "") for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    named = {k: sum(kernel_named(e, k) for e in kernels)
             for k in ("harris_kernel", "gather_kernel")}
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    res = {"wall_s": wall, "ply_points": sizes, "trace_bytes": os.path.getsize(path),
           "trace_events": len(trace["traceEvents"]),
           "device_kernels": len(kernels), "named": named,
           "wrapper_launches": launched, "pngs": pngs}
    log("CLI flags: " + json.dumps(res))
    check(min(launched.values()) >= 1, f"the CLI run launched {launched}")
    check(named["harris_kernel"] >= 1 and named["gather_kernel"] >= 1,
          f"the trace does not name K1 and K2: {named}")
    if figures:
        check({"sparse_before_ba.png", "sparse_after_ba.png", "dense.png"}
              <= set(pngs) and any(p.startswith("debug_epipolar_") for p in pngs),
              f"CLI figures {pngs}")
    return res


# The JAX package's records of the two scale workloads (TPU v5e runs, in
# the repository): their outputs are compared with the port's, never their
# times.
STRESS_RECORD = "STRESS_r05.json"
BA_SCALE_RECORD = "BA_SCALE_r05.txt"
BA_RMS_ATOL = 0.01


def run_stress(smi):
    """Phase 20: the stress ring at 96 x 1280 x 960 through
    ``sfm_tpu_torch.tools.stress_scale``: K1 bit-equal to ``_harris_math``
    on the whole integer gray stack; K2 against its plain version at the
    SfM descriptors' 393,216 integer centres (one bf16 ulp, mask equal to
    ``_inbounds``, one device kernel a call) and at one expansion round's
    centres; SfM, BA and MVS with the launches counted (SfM's gates, the
    pair chunks, peak memory under the chunk budget plus the resident bytes;
    BA's rms; the four gates of the JAX tool's artifact); one warm repeat
    with the same cloud size; the JAX record's outputs beside the port's.
    Returns K1's and K2's numbers at this shape (``kernels``) and K2's
    error at a round's centres."""
    import numpy as np
    import torch

    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response
    from sfm_tpu_torch.ops.ncc import _inbounds
    from sfm_tpu_torch.sfm import pipeline
    from sfm_tpu_torch.tools import stress_scale as st

    n, w, h = 96, 1280, 960
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    images, calib = st.make_scene(n, w, h)
    log(f"stress ring {images.shape} rendered in {time.perf_counter() - t0:.2f} s "
        f"on {os.cpu_count()} threads")
    cfg = st.stress_config(device="cuda")
    torch.cuda.empty_cache()

    gray = device_gray(images, dev)
    check(gray.shape == (n, h, w) and bool((gray == gray.round()).all()),
          "stress gray stack is integer")
    check(torch.equal(harris_response(gray, 0.04), _harris_math(gray, 0.04)),
          f"K1 bit-equal to _harris_math on {tuple(gray.shape)}")
    stack = gray.to(torch.bfloat16)
    img, ctr = st.feature_samples(gray, cfg.features)
    got, inb = sample_normalized_patches(stack, img, ctr, WID)
    want = _sample_plain(stack, img, ctr, WID)
    ulps = bf16_ulps(got, want)
    check(img.numel() == n * cfg.features.max_corners, f"{img.numel()} samples")
    check(ulps <= 1.0, f"K2 at the stress descriptors: {ulps} bf16 ulps > 1")
    check(torch.equal(inb, _inbounds(ctr[:, 0], ctr[:, 1], h, w, WID)),
          "K2 mask at the stress descriptors equal to _inbounds")
    per_call = host_and_device(
        lambda: sample_normalized_patches(stack, img, ctr, WID), calls=10)
    check(per_call["launches"] == 1.0,
          f"a K2 call at the stress descriptors is {per_call['launches']} kernels")
    log(f"K1 bit-equal on {tuple(gray.shape)}; K2 at {img.numel()} integer "
        f"centres: {ulps:.2f} bf16 ulps, mask equal, in-bounds {int(inb.sum())}, "
        f"{per_call['launches']} device kernel a call")
    del got, want, inb
    torch.cuda.empty_cache()

    # A copy of the stack misses the grayscale cache that the checks above
    # filled, so the cold SfM stage pays its conversion and upload.
    fresh = images.copy()
    run = st.run_stages(fresh, calib, cfg, emit=log)
    result = st.result_record(run, n, w, h)
    log("stress RESULT " + json.dumps(result))
    recon, sfm = run["recon"], run["sfm"]
    launches = st.run_launches(run)
    budget = pipeline.chunk_budget_bytes(dev)
    resident = sfm_resident_bytes(cfg, n, h, w, n - 1)
    check(sfm["tracks"] > 500 and sfm["mean_pair_reproj"] < 0.3,
          f"stress SfM: {sfm['tracks']} tracks, {sfm['mean_pair_reproj']} px")
    check(sfm["pair_chunks"] >= 1, "stress SfM pair chunks")
    check(sfm["peak_device_bytes"] <= budget + resident,
          f"stress SfM peak {sfm['peak_device_bytes']} > chunk budget {budget} "
          f"+ resident {resident}")
    check(sfm["launches"] == {"harris_response": 1, "sample_normalized_patches": 1},
          f"stress SfM launches {sfm['launches']}")
    check(run["ba"]["launches"] == {"harris_response": 0,
                                    "sample_normalized_patches": 0},
          "stress BA launched an image kernel")
    check(run["mvs"]["launches"]["sample_normalized_patches"] > 0
          and run["mvs"]["launches"]["harris_response"] == 0,
          f"stress MVS launches {run['mvs']['launches']}")
    ba = run["ba"]
    check(ba["rms_px"] < 0.3 and ba["rms_px"] <= ba["rms_before_px"],
          f"stress BA rms {ba['rms_before_px']} -> {ba['rms_px']}")
    k2_round = check_k2_mvs_round(gray, calib, recon)

    warm = st.run_stages(fresh, calib, cfg, emit=lambda line: None)
    warm_rec = st.warm_record(warm, n)
    log("stress WARM " + json.dumps(warm_rec))
    check(warm_rec["dense_points"] == result["dense_points"],
          "the warm repeat gave another cloud size")
    checks, passed = st.check_gates(result, [result["dense_points"],
                                             warm_rec["dense_points"]])
    log("stress gates (STRESS_r05.json's, less matcher_mfu): " + json.dumps(checks))
    check(passed, f"stress gates failed: {checks}")

    with open(os.path.join(HERE, STRESS_RECORD)) as f:
        record = json.load(f)["cold"]
    keys = ("tracks", "rms_px", "seeds", "dense_points", "rounds",
            "sphere_dist_median", "sphere_dist_p95", "candidates_over_capacity",
            "backlog_remaining")
    log(f"stress outputs, the port on {smi} beside {STRESS_RECORD} (a TPU "
        "v5e run of the JAX package; outputs only, not gates): " + json.dumps(
            {k: {"port": result[k], "jax_record": record[k]} for k in keys}))

    kern = st.kernel_record(images, cfg, launches)
    log("stress kernels: " + json.dumps(kern))
    del gray, stack
    torch.cuda.empty_cache()
    # Phase 25's comparison once on this ring: pipelined against serial.
    schedule = run_schedule(fresh, recon, smi, "stress ring",
                            scales=(st.MVS_SCALE,), chunks=(),
                            want_points={st.MVS_SCALE: result["dense_points"]},
                            mvs_config=cfg.mvs)
    return {"kernels": kern, "k2_round_max_abs_err": k2_round["max_abs_err"],
            "schedule": schedule}


def ba_scale_record():
    """BA_SCALE_r05.txt's solves: label -> (rms px, iterations)."""
    out = {}
    with open(os.path.join(HERE, BA_SCALE_RECORD)) as f:
        for line in f:
            if line.startswith('{"label"'):
                rec = json.loads(line)
                out[rec["label"]] = (rec["rms_px"], rec["iterations"])
    return out


def run_ba_scale(smi):
    """Phase 21: ``sfm_tpu_torch.tools.ba_scale``'s four solves with one
    timed repeat each: every label's final rms within 0.01 px of
    BA_SCALE_r05.txt's (the same problem; iterations printed beside the
    record's, not held: float32 on another chip may stop one iteration
    apart at ftol), dense against PCG below 5e-3, and the 8-virtual-shard
    equality on cuda:0; the dense solve's peak memory."""
    import torch

    from sfm_tpu_torch.tools import ba_scale as bs

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    prob = bs.synth_problem(256, 100_000, 1_000_000, device=dev)
    small = bs.synth_problem(256, bs.SLICE_POINTS, bs.SLICE_OBS, seed=bs.SLICE_SEED,
                             device=dev)
    recs, gate, agree = bs.labelled_solves(prob, small, iters=20, reps=1, emit=log)
    record = ba_scale_record()
    check(set(record) == set(recs), f"labels {sorted(recs)} != {sorted(record)}")
    side = {}
    for label, rec in recs.items():
        rms, iters = record[label]
        side[label] = {"rms_px": rec["rms_px"], "record_rms_px": rms,
                       "iterations": rec["iterations"], "record_iterations": iters,
                       "wall_s": rec["wall_s"]}
        check(abs(rec["rms_px"] - rms) <= BA_RMS_ATOL,
              f"{label}: rms {rec['rms_px']} vs the record's {rms}")
    log(f"BA at scale on {smi}, beside {BA_SCALE_RECORD} (a TPU v5e run; "
        "outputs only): " + json.dumps(side))
    check(agree["agree"], f"dense and PCG differ: {agree}")
    dense_peak = recs["joint_dense_256c_200k"]["peak_device_bytes"]
    log(f"dense solve of the 200k slice: peak {dense_peak} bytes; the port's "
        f"dense gate would choose {gate['ba_dense_schur_decided_by']!r} "
        f"({gate['ba_dense_schur_pairs']} pairs, "
        f"{gate['ba_dense_schur_pair_bytes']} pair bytes, JAX grid bytes "
        f"{gate['ba_dense_schur_grid_bytes']})")
    eq = bs.equality(prob, iters=20, emit=log)
    check(eq["pass"], f"8 virtual shards against one device: {eq}")


def run_quality_parity():
    """Phase 22: ``quality_torch``'s ba_solver_parity on the card: the model
    check within 0.02 px of the reference's rms, the port's joint solve
    <= 1.05x it."""
    import quality_torch

    ref = quality_torch._load_ref()["dino48_sparse"]["internal_rms_px"]
    c = quality_torch.ba_solver_parity(ref, "cuda")
    log("quality_torch ba_solver_parity on the card: " + json.dumps(c))
    check(abs(c["model_check_rms_at_ref_solution"] - c["reference_rms"]) < 0.02,
          "ba_solver_parity: the 12-param model does not reproduce the "
          "reference's rms at its solution")
    check(c["ours_rms"] <= 1.05 * c["reference_rms"] and c["pass"],
          f"ba_solver_parity: {c['ours_rms']} > 1.05 x {c['reference_rms']}")


def stress_entry(stress, name):
    """A kernel's numbers at the stress shape (phase 20), for its entry of
    the ``kernels`` line."""
    k = stress["kernels"][name]
    return {"kernel_only_ms_stress": k["kernel_only_ms"],
            "bound_ms_stress": k["bound_ms"], "launches_stress": k["launches"],
            "shape_stress": k["shape"]}


# --- phase 23: the mesh across processes -------------------------------------
# The ranks are this script again (``chip_smoke.py --rank SPEC``), each a
# process of a torch.distributed group on the card.

RANKS = 2
RANK_TIMEOUT_S = 300
ROUND_M = 32768                              # MVS round_capacity


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_pass(images, calib, mesh):
    """SfM (kernels), points-only BA, joint BA (dense Schur) and MVS at the
    CLI defaults over ``mesh``, each stage between a barrier and a sync;
    returns the outputs (flat numpy), each stage's wall and its K1 / K2 /
    K2s launches in this process."""
    import numpy as np
    import torch

    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig, MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.ops.gather import (
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.ops.harris import harris_response

    counted = (harris_response, sample_normalized_patches,
               sample_normalized_patches_sharded)
    walls, launches = {}, {}

    def stage(name, fn):
        mesh.barrier()
        torch.cuda.synchronize()
        for f in counted:
            f.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {f.__name__: f.launches for f in counted}
        mesh.barrier()
        return result

    sparse, _ = stage("sfm", lambda: run_sfm(images, calib, kernels=True, mesh=mesh))
    ba, ba_info = stage("ba", lambda: bundle_adjust(
        sparse_copy(sparse), BaConfig(dtype="float32"), mesh=mesh, device="cuda"))
    joint, j_info = stage("joint_ba", lambda: bundle_adjust(
        sparse_copy(sparse), BaConfig(dtype="float32", refine_cameras=True,
                                      dense_schur_max_cams=256),
        mesh=mesh, device="cuda"))
    dense = stage("mvs", lambda: dense_reconstruction(
        images, ba.calib, ba, MvsConfig(), scale=1.0, mesh=mesh, device="cuda"))
    out = {
        "sfm/track_offsets": sparse.track_offsets, "sfm/track_obs": sparse.track_obs,
        "sfm/world": sparse.world,
        "sfm/pair_reproj": sparse.metrics.values["mean_pair_reprojection_error_px"],
        "ba/world": ba.world, "ba/iterations": ba_info["iterations"],
        "ba/final_cost": ba_info["final_cost"], "ba/rms": ba.rms_reprojection_error(),
        "joint/cams11": j_info["cams11"], "joint/world": joint.world,
        "joint/iterations": j_info["iterations"],
        "joint/final_cost": j_info["final_cost"],
        "joint/solver": j_info["camera_solver"],
        "joint/rms": j_info["rms_reproj_refined_px"],
        "mvs/num_seeds": dense.num_seeds,
        "mvs/rounds": dense.metrics.values["mvs_rounds"],
    }
    for f in ("points", "colors", "normals", "scores", "refs"):
        out[f"mvs/{f}"] = getattr(dense, f)
    return {k: np.asarray(v) for k, v in out.items()}, walls, launches


def collective_ms(mesh, reps=20):
    """What one ``gather`` and one ``psum`` cost this process: a psum of a
    0-dim tensor (latency) and a gather of this rank's share of an MVS
    round's projections, (32,768 / shards, 48, 2) f32, ms per call."""
    import torch

    def per_call(fn, n):
        fn()
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    one = torch.ones((), device=mesh.lead)
    proj = torch.ones((ROUND_M // mesh.size, N_FRAMES, 2), device=mesh.lead)
    return {"psum_0d_ms": per_call(lambda: mesh.psum([one]), reps),
            "gather_round_proj_ms": per_call(lambda: mesh.gather([proj], ROUND_M),
                                             reps),
            "gather_round_proj_bytes": proj.numel() * proj.element_size()}


def rank_stages(spec):
    """One rank of a stages run: joins the group (spec's size and backend),
    runs
    ``mesh_pass`` once as a warm-up (with deterministic algorithms in
    warn-only mode, listing every op that warns, after a histc, which has
    no deterministic CUDA version, as a probe that they are caught) and once
    timed, times one gather and one psum, and writes its outputs, walls,
    launch counts and those times."""
    import warnings

    import numpy as np
    import torch

    from sfm_tpu_torch.io import Calibration
    from sfm_tpu_torch.parallel import data_mesh
    from sfm_tpu_torch.parallel.distributed import initialize_multihost

    info = initialize_multihost(spec["addr"], spec["world"], spec["rank"],
                                backend=spec["backend"])
    mesh = data_mesh()
    lead = torch.device("cuda", spec["rank"] % torch.cuda.device_count())
    check(mesh.size == spec["world"] and mesh.local_devices == (lead,),
          f"rank mesh {mesh}")
    with np.load(spec["inp"]) as z:
        images = z["images"]
        calib = Calibration.from_numpy(z["K"], z["R"], z["t"],
                                       [str(n) for n in z["names"]])
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.histc(torch.rand(8, device=mesh.lead))
        probe = len(caught)
        mesh_pass(images, calib, mesh)
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0][:160] for w in caught[probe:]})
    nondet.insert(0, f"probe (histc) warnings: {probe}")
    out, walls, launches = mesh_pass(images, calib, mesh)
    walls.update(collective_ms(mesh))
    np.savez(spec["out"], **out, walls=json.dumps(walls),
             launches=json.dumps(launches), info=json.dumps(info),
             nondeterministic=json.dumps(nondet), mesh=repr(mesh))
    return 0


def rank_nccl_one(spec):
    """A one-process NCCL group on the card: the mesh's moves at an MVS
    round's shapes and a points-only BA over it, each equal to the
    single-controller mesh of the same device."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig
    from sfm_tpu_torch.io import Calibration
    from sfm_tpu_torch.parallel import DataMesh, data_mesh
    from sfm_tpu_torch.parallel.distributed import GROUP_TIMEOUT
    from sfm_tpu_torch.parallel.mesh import GroupMesh
    from sfm_tpu_torch.sfm.pipeline import SparseReconstruction

    dist.init_process_group("nccl", init_method=f"tcp://{spec['addr']}",
                            world_size=1, rank=0, timeout=GROUP_TIMEOUT)
    dev = torch.device("cuda", 0)
    mesh, single = data_mesh(), DataMesh([dev])
    check(isinstance(mesh, GroupMesh) and mesh.backend == "nccl"
          and mesh.size == 1, f"one-rank NCCL mesh {mesh}")
    g = torch.Generator(device=dev).manual_seed(0)
    m, v = ROUND_M, 5
    tensors = {
        "bf16 descriptors": torch.randn((m, v, (2 * WID + 1) ** 2), generator=g,
                                        device=dev).to(torch.bfloat16),
        "bool in-bounds": torch.rand((m, v), generator=g, device=dev) < 0.5,
        "f32 projections": torch.randn((m, v, 2), generator=g, device=dev),
        "f64 sums": torch.randn((m, 3), generator=g, device=dev, dtype=torch.float64),
        "int64 ids": torch.randint(0, 2**40, (m,), generator=g, device=dev),
    }
    moved = {}
    for name, x in tensors.items():
        for op in ("gather", "psum"):
            got, want = ((mm.gather(mm.split(x), m) if op == "gather"
                          else mm.psum(mm.split(x))) for mm in (mesh, single))
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"NCCL {op} of the {name} differs from the single-controller mesh")
        moved[name] = x.numel() * x.element_size()
    desc = tensors["bf16 descriptors"]
    parts = mesh.split(desc)
    gather_ms = cuda_ms(lambda: mesh.gather(parts, m))
    with np.load(spec["inp"]) as z:
        calib = Calibration.from_numpy(z["K"], z["R"], z["t"],
                                       [str(n) for n in z["names"]])
        recon = SparseReconstruction(calib=calib, world=z["world"],
                                     track_offsets=z["track_offsets"],
                                     track_obs=z["track_obs"])
    results = []
    for mm in (mesh, single):
        r, info = bundle_adjust(sparse_copy(recon), BaConfig(dtype="float32"),
                                mesh=mm, device="cuda")
        results.append((r.world, info["iterations"], info["final_cost"]))
    (w1, i1, c1), (w0, i0, c0) = results
    check(i1 == i0 and c1 == c0 and np.array_equal(w1, w0),
          "points-only BA over the NCCL group differs from the single-controller mesh")
    log(json.dumps({"nccl_one_rank": {
        "mesh": repr(mesh), "bytes_moved_each": moved,
        "descriptor_gather_ms": gather_ms, "ba_iterations": i1,
        "ba_final_cost": c1, "equal": True}}))
    dist.destroy_process_group()
    return 0


def rank_nccl_two(spec):
    """One of two NCCL processes on cuda:0: ``data_mesh()`` must refuse the
    group with its ValueError (raised out of this process)."""
    import torch.distributed as dist

    from sfm_tpu_torch.parallel import data_mesh
    from sfm_tpu_torch.parallel.distributed import GROUP_TIMEOUT

    dist.init_process_group("nccl", init_method=f"tcp://{spec['addr']}",
                            world_size=spec["world"], rank=spec["rank"],
                            timeout=GROUP_TIMEOUT)
    data_mesh()
    log("data_mesh() accepted two NCCL processes on one GPU")
    return 0


RANK_MODES = {"stages_gloo": rank_stages, "stages_nccl": rank_stages,
              "nccl_one": rank_nccl_one, "nccl_two": rank_nccl_two}


def rank_main(spec_path) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, HERE)
    import torch  # noqa: F401

    import sfm_tpu_torch  # noqa: F401

    rc = RANK_MODES[spec["mode"]](spec)
    check("jax" not in sys.modules, "a rank imported jax")
    return rc


def start_ranks(tmp, mode, n, inp, **extra):
    """Start ``n`` rank processes of ``mode`` on a fresh port; each writes
    its output to ``out{r}.npz`` and its log to ``log{r}.txt`` in ``tmp``.
    Returns [(process, log path, out path)]."""
    addr = f"127.0.0.1:{free_port()}"
    ranks = []
    for r in range(n):
        spec = {"mode": mode, "addr": addr, "rank": r, "inp": inp, "world": n,
                "out": os.path.join(tmp, f"{mode}_out{r}.npz"), **extra}
        path = os.path.join(tmp, f"{mode}_spec{r}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        log_path = os.path.join(tmp, f"{mode}_log{r}.txt")
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", path],
                stdout=logf, stderr=subprocess.STDOUT)
        ranks.append((proc, log_path, spec["out"]))
    return ranks


def wait_ranks(ranks, what):
    """Wait for every rank (killing all of them past RANK_TIMEOUT_S);
    returns [(exit code, log text)]."""
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        for proc, _, _ in ranks:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        for proc, _, _ in ranks:
            proc.kill()
            proc.wait()
        check(False, f"{what}: ranks still running after {RANK_TIMEOUT_S} s")
    done = []
    for proc, log_path, _ in ranks:
        with open(log_path) as f:
            done.append((proc.returncode, f.read()))
    return done


def write_ring(tmp, images, calib, sparse):
    """The ring's images, calibration and a sparse result, as the ranks'
    input file."""
    import numpy as np

    inp = os.path.join(tmp, "ring.npz")
    np.savez(inp, images=images, K=calib.K, R=calib.R, t=calib.t,
             names=np.asarray(calib.names), world=sparse.world,
             track_offsets=sparse.track_offsets, track_obs=sparse.track_obs)
    return inp


def stages_across_processes(tmp, inp, images, calib, world, backend, smi):
    """``mesh_pass`` in ``world`` processes of a ``backend`` group (one
    shard each, on ``data_mesh()``'s GPU of the process), held to each
    other bit for bit and to the single-controller mesh of the same
    devices -- ``world`` virtual shards of cuda:0 on one GPU, else shard i
    on cuda:i -- within phases 11-13's bounds, with the gates of the ring,
    and K1 / K2 launched once per stage and sweep in each process.
    Returns each rank's launch counts."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.parallel import DataMesh

    label = f"{world} {backend} processes"
    t0 = time.perf_counter()
    done = wait_ranks(start_ranks(tmp, f"stages_{backend}", world, inp,
                                  backend=backend), label)
    ranks_wall = time.perf_counter() - t0
    for r, (rc, text) in enumerate(done):
        check(rc == 0, f"{label}: rank {r} exited {rc}:\n{text[-4000:]}")
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"stages_{backend}_out{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    meta = [{k: json.loads(str(o.pop(k))) for k in
             ("walls", "launches", "info", "nondeterministic")} for o in outs]
    log(f"{label}: {[str(o.pop('mesh')) for o in outs]}; "
        f"initialize_multihost {[m['info'] for m in meta]}")
    log(f"{label}: warnings under deterministic algorithms (warm-up pass, "
        f"rank 0): " + json.dumps(meta[0]["nondeterministic"]))
    for r in range(1, world):
        differ = sorted(k for k in outs[0] if not np.array_equal(outs[0][k], outs[r][k]))
        check(set(outs[0]) == set(outs[r]) and not differ,
              f"{label}: ranks 0 and {r} differ in {differ}")
    log(f"{label}: the ranks' {len(outs[0])} outputs bit-identical")

    n_gpu = torch.cuda.device_count()
    devices = [torch.device("cuda", r % n_gpu) for r in range(world)]
    mesh = DataMesh(devices)
    mesh_pass(images, calib, mesh)  # warm
    want, s_walls, s_launches = mesh_pass(images, calib, mesh)
    s_walls.update(collective_ms(mesh))
    got = outs[0]
    bit_equal = {k: bool(np.array_equal(got[k], want[k])) for k in want}
    log(f"{label} against the single-controller {mesh}, bit-equal by output: "
        + json.dumps(bit_equal))
    n_pts, n_pts_s = got["mvs/points"].shape[0], want["mvs/points"].shape[0]
    rms_diff = abs(float(got["ba/rms"]) - float(want["ba/rms"]))
    check(bit_equal["sfm/track_obs"], f"{label}: SfM track_obs differ")
    check(int(got["ba/iterations"]) == int(want["ba/iterations"])
          and rms_diff <= 1e-4, f"{label}: BA iterations or rms (1e-4 px)")
    check(int(got["joint/iterations"]) == int(want["joint/iterations"])
          and str(got["joint/solver"]) == "dense_schur", f"{label}: joint BA")
    check(int(got["mvs/num_seeds"]) == int(want["mvs/num_seeds"])
          and abs(n_pts - n_pts_s) <= 0.01 * n_pts_s,
          f"{label}: MVS seeds equal and points within 1 %")
    n_tracks = int(got["sfm/track_offsets"].shape[0] - 1)
    med, p95 = sphere_bounds(got["sfm/world"])
    check(n_tracks > 500 and float(got["sfm/pair_reproj"]) < 0.3
          and med < 0.01 and p95 < 0.05, f"{label}: SfM gates")
    check(float(got["ba/rms"]) < 0.3, f"{label}: BA rms gate")
    dmed, dp90, outward = dense_bounds(got["mvs/points"], got["mvs/normals"])
    check(n_pts > 10000 and dmed < 0.02 and dp90 < 0.06 and outward > 0.9,
          f"{label}: MVS gates")
    rounds = int(got["mvs/rounds"])
    enq, wasted = enqueued_rounds(rounds, n_pts, int(got["mvs/num_seeds"]),
                                  MvsConfig())
    log(f"{label}: MVS {rounds} rounds read, {enq} enqueued ({wasted} wasted)")
    for r, m in enumerate(meta):
        lc = m["launches"]
        check(lc["sfm"]["harris_response"] == 1
              and lc["sfm"]["sample_normalized_patches"] == 1,
              f"{label}: rank {r}: SfM launched K1 / K2 {lc['sfm']}, not once each")
        check(lc["mvs"]["sample_normalized_patches"] == 1 + enq
              and lc["mvs"]["sample_normalized_patches_sharded"] == 1 + enq
              and lc["mvs"]["harris_response"] == 0,
              f"{label}: rank {r}: MVS launches {lc['mvs']}, not K2 once per "
              f"sweep (seeding + {enq} rounds enqueued, {rounds} read, "
              f"{wasted} wasted)")
        check(lc["ba"]["harris_response"] == lc["ba"]["sample_normalized_patches"]
              == lc["joint_ba"]["sample_normalized_patches"] == 0,
              f"{label}: rank {r}: BA launched an image kernel")
    log(f"{label} outputs: {n_tracks} tracks, BA {int(got['ba/iterations'])} "
        f"iterations rms {float(got['ba/rms']):.6f} px (single-controller "
        f"{float(want['ba/rms']):.6f}), joint BA {int(got['joint/iterations'])} "
        f"iterations rms {float(got['joint/rms']):.6f}, MVS "
        f"{int(got['mvs/num_seeds'])} seeds -> {n_pts} points in {rounds} "
        f"rounds (single-controller {n_pts_s})")
    walls = {f"rank {r}": m["walls"] for r, m in enumerate(meta)}
    walls[f"single controller, {mesh}"] = s_walls
    log(f"{label}: stage walls (s) and one gather / psum (ms), on {smi}: "
        + json.dumps(walls))
    log(f"{label}: launches per rank: " + json.dumps(
        {f"rank {r}": m["launches"] for r, m in enumerate(meta)})
        + "; single controller: " + json.dumps(s_launches))
    log(f"{label}: run wall {ranks_wall:.2f} s")
    return [m["launches"] for m in meta]


def nccl_processes(tmp, inp, images, calib, smi):
    """One process per GPU over NCCL through ``stages_across_processes``
    (two or more GPUs; logs the skip below that)."""
    import torch

    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        log("SfM, BA and MVS in one NCCL process per GPU: skipped (one GPU)")
        return None
    return stages_across_processes(tmp, inp, images, calib, n_gpu, "nccl", smi)


def run_process_mesh(images, calib, sparse4, smi):
    """Phase 23: SfM, points-only and joint BA and MVS at the CLI defaults
    in RANKS gloo processes on cuda:0 (one local shard each), held to each
    other bit for bit and to the single-controller mesh of RANKS virtual
    shards; a one-process NCCL group; two NCCL processes on one GPU
    refused; and, with two or more GPUs, one NCCL process per GPU against
    the single-controller mesh over them.  Returns the gloo ranks' launch
    counts."""
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    inp = write_ring(tmp, images, calib, sparse4)
    per_rank = stages_across_processes(tmp, inp, images, calib, RANKS, "gloo", smi)

    t0 = time.perf_counter()
    ((rc, text),) = wait_ranks(start_ranks(tmp, "nccl_one", 1, inp), "NCCL one rank")
    check(rc == 0, f"one-rank NCCL run exited {rc}:\n{text[-4000:]}")
    log(next(ln for ln in text.splitlines() if ln.startswith('{"nccl_one_rank"'))
        + f" ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    refused = wait_ranks(start_ranks(tmp, "nccl_two", RANKS, inp), "NCCL refusal")
    for r, (rc, text) in enumerate(refused):
        check(rc != 0 and "ValueError: NCCL group places two processes on one GPU"
              in text, f"NCCL rank {r} on cuda:0 was not refused by data_mesh "
              f"(exit {rc}):\n{text[-4000:]}")
    log(f"two NCCL processes on cuda:0: both refused with data_mesh's "
        f"ValueError ({time.perf_counter() - t0:.1f} s)")
    nccl_processes(tmp, inp, images, calib, smi)
    tmp_dir.cleanup()
    log(f"phase 23 wall {time.perf_counter() - t_phase:.2f} s")
    return per_rank


# --- phase 24: the benchmark harness ---------------------------------------

BENCH_TIMEOUT_S = 300


def bench_line(ds, *flags):
    """``bench_torch.py --data ds *flags`` in a process of its own, as a
    user runs it; returns its last line, parsed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "bench_torch.py"), "--data", ds, *flags],
        cwd=HERE, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    check(proc.returncode == 0, f"bench_torch.py {' '.join(flags)} exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"bench_torch.py {' '.join(flags)} ({time.perf_counter() - t0:.1f} s "
        f"with its start): {line}")
    return json.loads(line)


def run_bench(images, ba_recon, tracks4, rms8, seeds9, smi):
    """Phase 24: ``bench_torch.py`` on the ring written in dinoRing's
    layout, once with ``--warm 3`` and once with ``--refine_cameras --warm
    1 --no-kernels``.  Its tracks are phase 4's, its rms phase 8's, its
    dense points those of an in-process MVS at the bench's scale on phase
    8's result, K1 and K2 launch as that pass does, and joint BA does not
    end above points-only.  That MVS seeds as phase 9 does (seeding does
    not read the scale) and its cloud lies on the sphere; its expansion
    accepts a patch only within 0.05 / scale of its parent, 0.005 at scale
    10, about the spacing of neighbouring cells on this ring, so it grows
    the seeds by far less than phase 9's scale 1 (dinoRing's scene is
    smaller).  Returns the first line."""
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.ops.harris import harris_response
    from sfm_tpu_torch.utils import synth

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "sphere_ring")  # not dinoRing: no vs_baseline
        synth.write_middlebury_dataset(
            ds, centers=synth.ring_rig(N_FRAMES), w=WIDTH, h=HEIGHT,
            prefix="dinoR", image_type="png", spheres=(((0.0, 0.0, 0.0), 1.0),),
            seed=0)
        r = bench_line(ds, "--warm", "3")
        j = bench_line(ds, "--refine_cameras", "--warm", "1", "--no-kernels")
        s = bench_line(ds, "--no-defer-fetch", "--no-seed-overlap", "--warm", "3",
                       "--no-kernels")

    harris_response.launches = sample_normalized_patches.launches = 0
    dense = dense_reconstruction(images, ba_recon.calib, ba_recon, MvsConfig(),
                                 scale=10.0, device="cuda")
    torch.cuda.synchronize()
    k2_mvs = sample_normalized_patches.launches
    check(harris_response.launches == 0, "MVS launched K1")
    mv = dense.metrics.values
    enq, wasted = enqueued_rounds(mv["mvs_rounds"], mv["mvs_num_points"],
                                  dense.num_seeds, MvsConfig())
    med, p90, outward = dense_bounds(dense.points, dense.normals)
    log(f"MVS at scale 10 in this process: {dense.num_seeds} seeds -> "
        f"{dense.num_points} points in {mv['mvs_rounds']} rounds, "
        f"{k2_mvs} K2 launches ({enq} rounds enqueued, {wasted} wasted); |c|-1 "
        f"median {med:.2e} p90 {p90:.2e}; n.c > 0 share {outward:.4f}; metrics "
        + dense.metrics.to_json())
    check(k2_mvs == 1 + enq,
          f"scale-10 MVS K2 launches {k2_mvs} != 1 + {enq} rounds enqueued")
    check(dense.num_seeds == seeds9 and dense.num_points >= seeds9,
          f"scale-10 MVS: {dense.num_seeds} seeds (phase 9: {seeds9}), "
          f"{dense.num_points} points")
    check(med < 0.02 and p90 < 0.06 and outward > 0.9,
          f"scale-10 dense cloud on the sphere: median {med} p90 {p90} "
          f"outward {outward}")

    check(r["metric"] == f"sphere_ring {N_FRAMES}-frame SfM+BA+MVS(100k budget) on cuda"
          and r["vs_baseline"] is None, f"bench metric {r['metric']!r}")
    check(len(r["wall_samples_s"]) == 3 and r["wall_s"] == min(r["wall_samples_s"]),
          "bench warm samples")
    check(r["tracks"] == tracks4, f"bench tracks {r['tracks']} != phase 4's {tracks4}")
    check(abs(r["rms_reproj_px"] - rms8) <= 1e-6,
          f"bench rms {r['rms_reproj_px']} px vs phase 8's {rms8}")
    check(r["dense_points"] == dense.num_points,
          f"bench dense points {r['dense_points']} != {dense.num_points} in process")
    kern = r["kernels"]
    k1, k2 = kern["harris_response"], kern["sample_normalized_patches"]
    check(k1["launches"] == 1, f"bench K1 launches {k1['launches']} != 1")
    check(k2["launches"] == 1 + k2_mvs,
          f"bench K2 launches {k2['launches']} != 1 + {k2_mvs} (SfM + MVS)")
    for name, k in (("K1", k1), ("K2", k2)):
        check(k["kernel_only_ms"] and k["kernel_only_ms"] > 0 and k["bound_ms"] > 0,
              f"bench {name}: kernel-only ms and bound")
    check(j["refine_cameras"] is True and j["tracks"] == tracks4
          and "kernels" not in j, "bench --refine_cameras line")
    check(r["overlap"] == {"ba_defer_fetch": True, "seed_fetch": True}
          and s["overlap"] == {"ba_defer_fetch": False, "seed_fetch": False},
          f"bench overlap keys {r['overlap']} / {s['overlap']}")
    check(all(s[k] == r[k] for k in ("tracks", "rms_reproj_px",
                                     "rms_reproj_refined_px", "dense_points")),
          "bench --no-defer-fetch --no-seed-overlap changed an output")
    check(j["rms_reproj_refined_px"] <= r["rms_reproj_refined_px"],
          f"joint BA rms {j['rms_reproj_refined_px']} above points-only "
          f"{r['rms_reproj_refined_px']}")
    log(f"bench on {smi}: " + json.dumps({
        "cold_s": r["cold_s"], "wall_s": r["wall_s"],
        "wall_median_s": r["wall_median_s"],
        "cold_attribution": r["cold_attribution"], "timers": r["timers"],
        "cold_timers": r["cold_timers"],
        "joint_wall_s": j["wall_s"],
        "no_overlap_wall_s": s["wall_s"],
        "no_overlap_wall_median_s": s["wall_median_s"],
        "no_overlap_wall_samples_s": s["wall_samples_s"],
        "wall_samples_s": r["wall_samples_s"],
        "no_overlap_timers": s["timers"],
        "mvs_wasted_rounds_scale10": wasted,
        "joint_rms_refined_px": j["rms_reproj_refined_px"],
        "dense_points_scale10": dense.num_points,
        "mvs_rounds_scale10": dense.metrics.values["mvs_rounds"]}))
    log(f"phase 24 wall {time.perf_counter() - t_phase:.2f} s")
    return r


# --- phase 25: the MVS schedule ---------------------------------------------

SCHEDULE_SAMPLES = 3  # timed runs of each pipelined schedule (median)
# The ring's dense clouds at the MVS defaults, by scale (phases 9 and 24 of
# every run since they were first measured).
RING_POINTS = {1.0: 118_279, 10.0: 8_494}


def check_round_sync(images, recon):
    """One ``expansion_round`` at the MVS defaults under
    ``torch.cuda.set_sync_debug_mode("error")`` on the seeded frontier,
    a chunk of two rounds, then at ``round_capacity`` 2048 (below the
    seeds) the frontier split with a backlog, a round, the backlog merge
    and a round: none may call a synchronizing CUDA function.  Each
    payload is held to the same call outside the mode."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MvsConfig
    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.mvs.cells import make_occupancy
    from sfm_tpu_torch.mvs.expand import expansion_round
    from sfm_tpu_torch.mvs.pipeline import _merge_backlog, _split_frontier
    from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches

    dev = torch.device("cuda")
    n, h, w = images.shape[:3]
    cfg = MvsConfig()
    gray = device_gray(images, dev).to(torch.bfloat16)
    cal = recon.calib
    K, R, t, C = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (cal.K, cal.R, cal.t, cal.centers))
    tid, ref_obs, oth = build_seed_candidates(recon.track_offsets, recon.track_obs)
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tid, ref_obs, oth)]
    occ = make_occupancy(n, h, w, cfg.cell_size, dev)
    seeds, occ, _ = seed_patches(gray, K, R, t, C, *ints, recon.num_tracks, occ,
                                 cfg, cfg.visible_lower_bound)
    keys = ("c", "n", "vis", "proj", "valid")

    def step(fr, occ, cap, k=1):
        return expansion_round(gray, K, R, t, C, occ, *(fr[x] for x in keys),
                               cfg, cfg.visible_lower_bound, cap, 1.0,
                               rounds_per_call=k)

    def calls():
        fr, _ = _split_frontier(seeds, cfg.round_capacity)
        one = step(fr, occ, cfg.round_capacity)[2]
        two = step(fr, occ, cfg.round_capacity, k=2)[2]
        fr, bl = _split_frontier(seeds, 2048)
        acc, occ2, first = step(fr, occ, 2048)
        fr, bl = _merge_backlog(acc, bl, 2048)
        merged = step(fr, occ2, 2048)[2]
        return {"round": one, "chunk_of_2": two, "backlog_round_1": first,
                "backlog_merged_round": merged, "backlog_left": bl["valid"].sum()}

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = calls()
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(got[k], want[k])) for k in got}
    check(all(same.values()), f"rounds under sync debug mode differ: {same}")
    out = {"seeds": int(seeds["valid"].sum()),
           "backlog_after_merge": int(got["backlog_left"]),
           "accepted": {k: int(v[..., -1, 6].sum()) for k, v in got.items()
                        if k != "backlog_left"}}
    check(out["backlog_after_merge"] > 0, "the backlog case kept no backlog")
    log("sync check: expansion_round, a chunk of 2, the backlog split and "
        "merge under set_sync_debug_mode('error'): no synchronizing call; "
        + json.dumps(out))
    return out


def schedule_run(images, recon, cfg, scale, serial=False, blocking=False,
                 profile=False):
    """One MVS stage at ``cfg`` and ``scale`` on the card, K2's counts set
    to 0 just before it.  ``serial``: the JAX condition rules
    dispatch-ahead out, a checkpoint due every chunk (its saves timed).
    ``blocking``: each payload copy is waited for when it is enqueued, so
    the host waits for every chunk before it enqueues the next (the
    schedule's walls without its overlap, and without checkpoint saves).
    Returns (dense, wall, K2 launches, save seconds, (device busy ms, host
    ms waiting on payload events) under torch.profiler with ``profile``,
    else None)."""
    import torch

    from sfm_tpu_torch.mvs import dense_reconstruction, pipeline
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.tools.measure import kernel_named, profiled
    from sfm_tpu_torch.utils import checkpoint

    class BlockingCopy(pipeline._HostCopy):
        def __init__(self, t):
            super().__init__(t)
            self.numpy()

    real_save, saves = checkpoint.save_mvs_state, [0.0]

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        real_save(*a, **kw)
        saves[0] += time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as ck, contextlib.ExitStack() as stack:
        kw = {}
        if serial:
            kw = dict(checkpoint_dir=ck, checkpoint_every=max(cfg.rounds_per_call, 1))
            checkpoint.save_mvs_state = timed_save
            stack.callback(setattr, checkpoint, "save_mvs_state", real_save)
        if blocking:
            stack.callback(setattr, pipeline, "_HostCopy", pipeline._HostCopy)
            pipeline._HostCopy = BlockingCopy

        def run():
            torch.cuda.synchronize()
            sample_normalized_patches.launches = 0
            t0 = time.perf_counter()
            dense = dense_reconstruction(images, recon.calib, recon, cfg,
                                         scale=scale, device="cuda", **kw)
            torch.cuda.synchronize()
            return dense, time.perf_counter() - t0, sample_normalized_patches.launches

        if not profile:
            dense, wall, launches = run()
            return dense, wall, launches, saves[0], None
        # A session that did not see one K2 kernel for each K2 launch lost
        # events and is taken again.
        (dense, wall, launches), kernels, prof = profiled(
            run, lambda r, kernels: r[2] == sum(
                kernel_named(e.name, "gather_kernel") for e in kernels),
            log=log, what="MVS schedule under the profiler")
    busy = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            sum(e.time_range.elapsed_us() for e in prof.events()
                if e.name == "cudaEventSynchronize") / 1e3)
    return dense, wall, launches, saves[0], busy


def run_schedule(images, recon, smi, label, scales=(1.0, 10.0), chunks=(2, 4),
                 want_points=None, mvs_config=None):
    """Phase 25 on one scene: at each scale the default (pipelined) MVS
    against the serial loop (``overlap_seed_fetch`` off, a checkpoint
    every round), and ``rounds_per_call`` k against the same k serial (a
    checkpoint every k rounds): points, colours, normals, scores and refs
    bit-identical, K2's launches those of the dispatch-ahead rule
    (``enqueued_rounds``, the seed sweep plus one a round enqueued).  The
    serial loop's wall is mostly its saves; the walls compared are the
    pipelined run's and the blocking one's (``schedule_run``), each the
    median of ``SCHEDULE_SAMPLES``, with the device busy share of one more
    run of each under torch.profiler.  ``want_points`` holds the expected
    point count per scale; ``mvs_config`` the MVS configuration (default the
    CLI's) whose ``rounds_per_call`` is varied.  ``payload_wait_ms`` is the host's time in
    ``cudaEventSynchronize`` (waiting for payload copies) in that run."""
    import dataclasses
    import statistics

    import numpy as np

    from sfm_tpu_torch.config import MvsConfig

    rows = {}
    for scale in scales:
        base = None
        for k in (1, *chunks):
            cfg = dataclasses.replace(mvs_config or MvsConfig(), rounds_per_call=k)
            ser_cfg = dataclasses.replace(cfg, overlap_seed_fetch=False)
            walls, b_walls = [], []
            for _ in range(SCHEDULE_SAMPLES):
                dense, wall, launches, _, _ = schedule_run(images, recon, cfg, scale)
                walls.append(wall)
                b_walls.append(schedule_run(images, recon, cfg, scale,
                                            blocking=True)[1])
            busy_wall, (busy, wait) = schedule_run(images, recon, cfg, scale,
                                                   profile=True)[1::3]
            b_busy_wall, (b_busy, b_wait) = schedule_run(
                images, recon, cfg, scale, blocking=True, profile=True)[1::3]
            serial, s_wall, s_launches, s_saves, _ = schedule_run(
                images, recon, ser_cfg, scale, serial=True)
            same = {f: bool(np.array_equal(getattr(dense, f), getattr(serial, f)))
                    for f in ("points", "colors", "normals", "scores", "refs")}
            mv = dense.metrics.values
            rounds = mv["mvs_rounds"]
            enq, wasted = enqueued_rounds(rounds, mv["mvs_num_points"],
                                          dense.num_seeds, cfg,
                                          backlog_left=mv.get("mvs_backlog_remaining", 0))
            s_enq, s_wasted = enqueued_rounds(
                rounds, mv["mvs_num_points"], dense.num_seeds, ser_cfg, serial=True)
            row = {
                "points": dense.num_points, "seeds": dense.num_seeds,
                "rounds": rounds, "bit_identical_to_serial": same,
                "k2_launches": launches, "rounds_enqueued": enq,
                "wasted_rounds": wasted, "serial_k2_launches": s_launches,
                "serial_wasted_rounds": s_wasted,
                "wall_s": statistics.median(walls), "wall_samples_s": walls,
                "busy_ms": busy, "busy_share": busy / 1e3 / busy_wall,
                "payload_wait_ms": wait,
                "blocking_wall_s": statistics.median(b_walls),
                "blocking_wall_samples_s": b_walls,
                "blocking_busy_ms": b_busy,
                "blocking_busy_share": b_busy / 1e3 / b_busy_wall,
                "blocking_payload_wait_ms": b_wait,
                "serial_wall_s": s_wall, "serial_saves_s": s_saves,
            }
            key = f"{label} scale {scale:g} rounds_per_call {k}"
            rows[key] = row
            log(f"MVS schedule, {key}, on {smi}: " + json.dumps(row))
            check(all(same.values()), f"{key}: not bit-identical to the serial "
                  f"loop: {same}")
            check(serial.metrics.values["mvs_rounds"] == rounds,
                  f"{key}: serial rounds differ")
            check(launches == 1 + enq,
                  f"{key}: K2 launches {launches} != 1 seed sweep + {enq} rounds "
                  f"enqueued ({rounds} read, {wasted} wasted)")
            check(s_launches == 1 + s_enq,
                  f"{key}: serial K2 launches {s_launches} != 1 + {s_enq} "
                  f"({s_wasted} wasted)")
            if base is None:
                base = dense
                if want_points:
                    check(dense.num_points == want_points[scale],
                          f"{key}: {dense.num_points} points, not "
                          f"{want_points[scale]}")
            elif not mv.get("mvs_backlog_rounds"):
                # Without a backlog a chunk of rounds is the rounds one by one.
                check(all(np.array_equal(getattr(dense, f), getattr(base, f))
                          for f in ("points", "refs")),
                      f"{key}: with no backlog the cloud is rounds_per_call 1's")
    return rows


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; chip_smoke needs a "
              "CUDA device", file=sys.stderr)
        return 1
    try:
        import PIL  # noqa: F401  (the CLI reads and writes PNGs with it)
    except ImportError:
        print("error: Pillow is not installed; the CLI phases need it",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import sfm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: sfm_tpu_torch not importable next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 1
    from sfm_tpu_torch.ops.gather import (
        _sample_plain,
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.ops.gray import rgb_to_gray
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response
    from sfm_tpu_torch.tools.measure import (
        gather_bound, gray_bound, harris_bound, kernel_only_ms,
    )
    from sfm_tpu_torch.utils import build

    import numpy as np

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
    rgb = check_k4(images)
    check_k4_shapes(gray.device)
    k1 = check_k1(gray)
    k1_shapes = check_k1_shapes(gray.device)
    gray_bf16 = gray.to(torch.bfloat16)
    k2_in = k2_inputs(gray, k1["corners"])
    k2 = check_k2(gray_bf16, k2_in)
    k2["redesign"] = check_k2_redesign(gray_bf16, *k2_in[1])["max_abs_err"]

    # --- 4. the SfM stage ---------------------------------------------------
    run_sfm(images, calib, kernels=True)  # warm: allocator, cuBLAS, sort
    harris_response.launches = 0
    sample_normalized_patches.launches = 0
    rgb_to_gray.launches = 0
    recon, wall = run_sfm(images, calib, kernels=True)
    launches = {"rgb_to_gray": rgb_to_gray.launches,
                "harris_response": harris_response.launches,
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
    check(launches["rgb_to_gray"] == 1 and mv["gray_route"] == "kernel",
          f"SfM's gray: {launches['rgb_to_gray']} K4 launches, route "
          f"{mv['gray_route']}")
    rgb_to_gray.launches = 0
    plain_sfm, plain_wall_sfm = run_sfm(images, calib, kernels=False)
    check(rgb_to_gray.launches == 0
          and plain_sfm.metrics.values["gray_route"] == "host",
          "SfM with kernels=False converted on the card")
    log(f"SfM (plain versions on the card): {plain_sfm.num_tracks} tracks, wall "
        f"{plain_wall_sfm:.4f} s; timers "
        + json.dumps({k: round(v, 4) for k, v in plain_sfm.timers.times.items()}))
    check(abs(plain_sfm.num_tracks - recon.num_tracks) <= 0.1 * plain_sfm.num_tracks,
          "kernel and plain SfM track counts within 10%")

    # --- 5. the CLI on the scene written as a Middlebury dataset ------------
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
        "k4": cuda_ms(lambda: rgb_to_gray(rgb)),
        "k4_plain": host_ms(lambda: gray_tensor(images, "cuda")),
        "k1": cuda_ms(lambda: harris_response(gray, 0.04)),
        "k1_plain": cuda_ms(lambda: _harris_math(gray, 0.04)),
        "k2_int": cuda_ms(lambda: sample_normalized_patches(gray_bf16, img_i, ctr_i, WID)),
        "k2_int_plain": cuda_ms(lambda: _sample_plain(gray_bf16, img_i, ctr_i, WID)),
        "k2_frac": cuda_ms(lambda: sample_normalized_patches(gray_bf16, img_f, ctr_f, WID)),
        "k2_frac_plain": cuda_ms(lambda: _sample_plain(gray_bf16, img_f, ctr_f, WID)),
    }
    log(f"kernel times, ms per call, median of 20 windows of 10 calls (k4_plain: "
        f"the host route's wall, median of 7), on {smi}: "
        + json.dumps({k: round(v, 4) for k, v in t.items()}))
    k4_calls = host_and_device(lambda: rgb_to_gray(rgb))
    check(k4_calls["launches"] == 1, f"a K4 call is {k4_calls['launches']} "
          f"device kernels ({k4_calls['kernels']})")
    log("K4 call: " + json.dumps(k4_calls))

    # --- 7. K2 at one expansion round's centres, and non-finite ones -------
    k2_round = check_k2_mvs_round(gray, calib, recon)

    # --- 8. points-only bundle adjustment on the phase-4 sparse result ------
    sparse4 = sparse_copy(recon)  # phase 12's BA input
    warm = sparse_copy(recon)
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
    from sfm_tpu_torch.config import MvsConfig

    first, first_wall = run_mvs(images, recon, kernels=None)  # warm
    harris_response.launches = 0
    sample_normalized_patches.launches = 0
    sample_normalized_patches_sharded.launches = 0
    rgb_to_gray.launches = 0
    dense, mvs_wall = run_mvs(images, recon, kernels=None)
    launches_mvs = sample_normalized_patches.launches
    check(harris_response.launches == 0, "MVS launched K1")
    check(rgb_to_gray.launches == 0, "MVS launched K4 (its gray is cached)")
    check(sample_normalized_patches_sharded.launches == launches_mvs,
          "an MVS sweep bypassed K2s's launch step (a mesh of one shard)")
    mv = dense.metrics.values
    enq9, wasted9 = enqueued_rounds(mv["mvs_rounds"], mv["mvs_num_points"],
                                    dense.num_seeds, MvsConfig())
    log(f"launches in the timed MVS run: sample_normalized_patches {launches_mvs} "
        f"(seeding + {enq9} rounds enqueued: {mv['mvs_rounds']} read, {wasted9} "
        "wasted)")
    check(launches_mvs > 0, "sample_normalized_patches not launched on the MVS path")
    check(launches_mvs == 1 + enq9,
          f"MVS K2 launches {launches_mvs} != 1 + {enq9} rounds enqueued")
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
    # (phase 13 runs the CLI on the same dataset)
    tmp_cli = tempfile.TemporaryDirectory()
    tmp = tmp_cli.name
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

    # --- 11. K2s, and K1/K2 on a second GPU --------------------------------
    k2s = check_k2_sharded(gray_bf16, img_f, ctr_f)
    check_second_gpu(gray, k2_in)

    # --- 12. SfM, BA and MVS on a 4-shard mesh of the card ----------------
    from sfm_tpu_torch.parallel import DataMesh, data_mesh

    unsharded = {"sparse": sparse4, "ba_info": info, "ba_rms": rms_after,
                 "ba_recon": recon, "dense": dense, "sfm_s": wall,
                 "ba_s": ba_wall, "mvs_s": mvs_wall}
    sh = run_stages_on_mesh(DataMesh([torch.device("cuda", 0)] * SHARDS),
                            images, calib, unsharded)
    n_gpu = torch.cuda.device_count()
    walls = {f"{SHARDS} virtual shards": sh}
    for k in sorted({2, n_gpu}) if n_gpu >= 2 else ():
        walls[f"{k} GPUs"] = run_stages_on_mesh(data_mesh(num_devices=k), images,
                                                calib, unsharded)
    if n_gpu < 2:
        log("SfM, BA and MVS over 2 or more GPUs: skipped (one GPU)")

    # --- 13. the CLI with --mesh_devices 4 on phase 10's dataset -------------
    from sfm_tpu_torch.cli import run_mesh
    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig

    cli_mesh = run_mesh(PipelineConfig(
        runtime=RuntimeConfig(mesh_shape=SHARDS, device="cuda")))
    out = os.path.join(tmp_cli.name, "out_mesh")
    t0 = time.perf_counter()
    rc = cli_main(["-img_p", ds, "-par_p", par, "-t", "png",
                   "--mesh_devices", str(SHARDS), "--out_dir", out])
    mesh_cli_wall = time.perf_counter() - t0
    check(rc == 0, f"CLI --mesh_devices exit code {rc}")
    clouds = {name: read_ply(os.path.join(out, name + ".ply"))[0]
              for name in ("sparse_points", "sparse_points_ba",
                           "initial_patches", "all_patches")}
    med_c, p95_c = sphere_bounds(clouds["sparse_points"].astype("float64"))
    dpts = clouds["all_patches"].astype("float64")
    dmed, dp90, _ = dense_bounds(dpts, dpts)
    log(f"CLI --mesh_devices {SHARDS} (a mesh of {cli_mesh.size} device(s) "
        f"here) in {mesh_cli_wall:.2f} s: "
        + ", ".join(f"{k} {v.shape[0]}" for k, v in clouds.items())
        + f"; sparse median {med_c:.2e} p95 {p95_c:.2e}; dense median "
        f"{dmed:.2e} p90 {dp90:.2e}")
    check(clouds["sparse_points"].shape[0] > 500 and med_c < 0.01
          and p95_c < 0.05, "CLI --mesh_devices sparse cloud on the sphere")
    check(clouds["sparse_points_ba"].shape == clouds["sparse_points"].shape,
          "CLI --mesh_devices BA cloud")
    check(dpts.shape[0] > 10000 and dmed < 0.02 and dp90 < 0.06,
          "CLI --mesh_devices dense cloud on the sphere")

    # --- 14. K3 against its plain versions and K2; the tool's sweep ----------
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled
    from sfm_tpu_torch.tools import prof_tile

    k3 = check_k3(gray_bf16, img_f, ctr_f)
    k3_routes = check_k3_routes(gray_bf16, img_f, ctr_f)
    tile_rows, k3_launches = run_prof_tile(smi)
    tg, ti, tc = prof_tile.case_tensors(81920, torch.device("cuda"))
    # The same images three columns wider (643: the per-row route), which
    # the same windows read: the same descriptors.
    tg_rows = torch.zeros((*tg.shape[:2], tg.shape[2] + 3), dtype=tg.dtype,
                          device=tg.device)
    tg_rows[:, :, :tg.shape[2]] = tg
    k3_default = lambda: sample_normalized_patches_tiled(tg, ti, tc, WID)  # noqa: E731
    k2_same = lambda: sample_normalized_patches(tg, ti, tc, WID)  # noqa: E731
    k3_rows = lambda: sample_normalized_patches_tiled(tg_rows, ti, tc, WID)  # noqa: E731
    check(torch.equal(k3_rows(), k3_default()), "K3's two routes differ")
    k3_t = {
        "ms": cuda_ms(k3_default),
        "plain_ms": cuda_ms(lambda: _sample_plain(tg, ti, tc, WID)),
        "k2_same_inputs_ms": cuda_ms(k2_same),
        "kernel_only_ms": kernel_only_ms(k3_default, K3_KERNELS["tma"]),
        "kernel_only_ms_rows_route": kernel_only_ms(k3_rows, K3_KERNELS["rows"]),
        "k2_kernel_only_ms": kernel_only_ms(k2_same, "gather_kernel"),
    }
    k3_modes = {f"{r['mode']}_S{r['S']}": r["time_s"] * 1e3 for r in tile_rows
                if r["S"] is not None}
    k3_modes_kernel_only = {
        f"{mode}_S{S}": kernel_only_ms(
            lambda kw=kw: sample_normalized_patches_tiled(tg, ti, tc, WID, **kw),
            K3_KERNELS["tma"])
        for _, mode, S, kw in prof_tile.modes()}
    log(f"K3 at 81,920 samples (S 32, double-buffered) on {smi}, ms: "
        + json.dumps({k: round(v, 5) for k, v in k3_t.items()}))
    log("K3 kernel-only device ms by mode: "
        + json.dumps({k: round(v, 5) for k, v in k3_modes_kernel_only.items()}))
    kernel_only = {
        "k4": kernel_only_ms(lambda: rgb_to_gray(rgb), "gray_kernel"),
        "k1": kernel_only_ms(lambda: harris_response(gray, 0.04), "harris_kernel"),
        "k2_int": kernel_only_ms(lambda: sample_normalized_patches(
            gray_bf16, img_i, ctr_i, WID), "gather_kernel"),
        "k2_frac": kernel_only_ms(lambda: sample_normalized_patches(
            gray_bf16, img_f, ctr_f, WID), "gather_kernel"),
    }
    log("K4 / K1 / K2 kernel-only device ms: "
        + json.dumps({k: round(v, 5) for k, v in kernel_only.items()})
        + "; first designs: " + json.dumps(PARENT))

    # --- 15. MVS with the outlier filter at the CLI defaults ----------------
    f_first, _, seen = run_filtered_mvs(images, recon, hold_oracle=True)
    check(seen["oracle_equal"], "device filter keep mask != the host oracle's")
    sample_normalized_patches.launches = 0
    sample_normalized_patches_sharded.launches = 0
    fdense, f_wall, f_seen = run_filtered_mvs(images, recon, hold_oracle=False)
    fm = fdense.metrics.values
    med, p90, outward = dense_bounds(fdense.points, fdense.normals)
    log(f"MVS with the outlier filter: {fm['mvs_num_points']} points, "
        f"mvs_filtered_out {fm['mvs_filtered_out']}, "
        f"{fm['mvs_num_points_filtered']} kept ({fdense.num_seeds} seeds), "
        f"largest cell group {fm['mvs_filter_max_cell_group']}; the filter's "
        f"sweep: {f_seen['launches']} K2 launch(es), {f_seen['samples']} samples "
        f"({seen['incidences']} visible hits); keep mask equal to the host "
        f"oracle's (oracle {seen['oracle_s']:.2f} s on the host); |c|-1 median "
        f"{med:.2e} p90 {p90:.2e}; n.c > 0 share {outward:.4f}; wall "
        f"{f_wall:.4f} s (unfiltered {mvs_wall:.4f} s); timers "
        + json.dumps({k: round(v, 4) for k, v in fdense.timers.times.items()}))
    check(f_seen["launches"] == 1, "the filter's sweep is one K2 launch")
    check(sample_normalized_patches.launches == launches_mvs + 1
          and sample_normalized_patches_sharded.launches == launches_mvs + 1,
          "filtered MVS: the unfiltered run's K2 launches plus the filter's")
    check(fm["mvs_num_points"] == dense.num_points, "filter changed the rounds")
    check(fdense.num_points == fm["mvs_num_points"] - fm["mvs_filtered_out"],
          "filtered count")
    check(fdense.num_points > 10000 and med < 0.02 and p90 < 0.06
          and outward > 0.9, "filtered cloud on the sphere")
    check(np.array_equal(fdense.points, f_first.points),
          "two filtered runs differ")

    # --- 16. kill and resume; the CLI's stage files --------------------------
    with tempfile.TemporaryDirectory() as ck:
        resumed, r_wall, state_bytes = run_killed_and_resumed(images, recon, ck)
    same = all(np.array_equal(getattr(resumed, f), getattr(dense, f))
               for f in ("points", "colors", "normals", "scores", "refs"))
    log(f"MVS killed after 2 rounds and resumed (round "
        f"{resumed.metrics.values['mvs_resumed_at_round']}): "
        f"{resumed.num_points} points, bit-identical to the uninterrupted "
        f"run: {same}; state file {state_bytes / 1e6:.1f} MB; resumed run "
        f"wall {r_wall:.4f} s (uninterrupted, no saves {mvs_wall:.4f} s)")
    check(same and resumed.num_seeds == dense.num_seeds,
          "resumed cloud differs from the uninterrupted one")
    ck = os.path.join(tmp_cli.name, "ckpt")
    outs = [os.path.join(tmp_cli.name, f"out_ck{i}") for i in (0, 1)]
    base = ["-img_p", ds, "-par_p", par, "-t", "png", "--checkpoint_dir", ck]
    t0 = time.perf_counter()
    rc = cli_main(base + ["--out_dir", outs[0]])
    ck_wall = time.perf_counter() - t0
    check(rc == 0, f"CLI --checkpoint_dir exit code {rc}")
    check(sorted(os.listdir(ck)) == ["ba.npz", "sfm.npz"],
          f"checkpoint files {os.listdir(ck)}")
    t0 = time.perf_counter()
    rc = cli_main(base + ["--out_dir", outs[1], "--stages", "mvs"])
    mvs_only_wall = time.perf_counter() - t0
    check(rc == 0, f"CLI --stages mvs exit code {rc}")
    a, b = (read_ply(os.path.join(o, "all_patches.ply")) for o in outs)
    check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
          "--stages mvs from the files gave another cloud")
    dmed, dp90, _ = dense_bounds(a[0].astype("float64"), a[0].astype("float64"))
    check(a[0].shape[0] > 10000 and dmed < 0.02 and dp90 < 0.06,
          "CLI --checkpoint_dir dense cloud on the sphere")
    log(f"CLI --checkpoint_dir in {ck_wall:.2f} s (sfm.npz, ba.npz), then "
        f"--stages mvs alone from the files in {mvs_only_wall:.2f} s: "
        f"{b[0].shape[0]} dense points, the same cloud")

    # --- 17. joint bundle adjustment, both camera solvers --------------------
    joint = {}
    for solver, max_cams in (("dense_schur", 256), ("pcg", 0)):
        jrec, jinfo, j_before, j_wall = run_joint_ba(sparse4, max_cams)
        check(jinfo["camera_solver"] == solver, f"solver {jinfo['camera_solver']}")
        med, p95 = sphere_bounds(jrec.world)
        joint[solver] = {
            "iterations": jinfo["iterations"], "final_cost": jinfo["final_cost"],
            "rms_before_px": j_before,
            "rms_refined_px": jinfo["rms_reproj_refined_px"],
            "rms_vs_calibration_px": jrec.rms_reprojection_error(),
            "sphere_median": med, "sphere_p95": p95, "wall_s": j_wall,
            "solve_s": jinfo["timers"]["solve"]}
        log(f"joint BA (f32, {solver}): " + json.dumps(joint[solver]))
        check(jinfo["iterations"] >= 1 and jinfo["cams11"].shape == (N_FRAMES, 12),
              "joint BA ran")
        check(jinfo["rms_reproj_refined_px"] < j_before,
              "joint BA did not lower the rms")
        check(jinfo["rms_reproj_refined_px"] <= info["rms_reproj_refined_px"] + 1e-4,
              "joint optimum above the points-only one")
        check(med < 0.01 and p95 < 0.05, f"joint BA sphere bounds {med} {p95}")
    gap = abs(joint["dense_schur"]["rms_refined_px"] - joint["pcg"]["rms_refined_px"])
    log(f"joint BA: dense and PCG refined rms differ by {gap:.2e} px")
    check(gap <= 1e-3, f"dense and PCG rms differ by {gap} px > 1e-3")
    # --- 18. all-pairs SfM, BA and MVS; the sequential run in chunks -------
    allpairs = run_allpairs(images, calib, sparse4, smi)

    # --- 19. the CLI with --nonSequence, --profile_dir (--debug, --plot) ----
    run_cli_flags(ds, par, tmp_cli.name)
    tmp_cli.cleanup()

    # --- 20. the stress ring at 96 x 1280 x 960 ------------------------------
    t0 = time.perf_counter()
    stress = run_stress(smi)
    log(f"phase 20 (stress ring) wall {time.perf_counter() - t0:.2f} s")

    # --- 21. bundle adjustment at 1M observations ----------------------------
    t0 = time.perf_counter()
    run_ba_scale(smi)
    log(f"phase 21 (BA at scale) wall {time.perf_counter() - t0:.2f} s")

    # --- 22. the quality harness's solver parity on the card -----------------
    t0 = time.perf_counter()
    run_quality_parity()
    log(f"phase 22 (ba_solver_parity) wall {time.perf_counter() - t0:.2f} s")

    # --- 23. SfM, BA and MVS in two processes; NCCL -------------------------
    per_rank = run_process_mesh(images, calib, sparse4, smi)

    # --- 24. bench_torch.py on the ring in dinoRing's layout -----------------
    bench = run_bench(images, recon, sparse4.num_tracks, rms_after,
                      dense.num_seeds, smi)

    # --- 25. the MVS schedule: no host read in a round; pipelined, chunked ----
    t0 = time.perf_counter()
    check_round_sync(images, recon)
    schedule = run_schedule(images, recon, smi, "ring", want_points=RING_POINTS)
    log(f"phase 25 (MVS schedule) wall {time.perf_counter() - t0:.2f} s")

    log(f"stage walls at {SHARDS} virtual shards on {smi}: " + json.dumps({
        "sfm_s": sh["sfm_s"], "ba_s": sh["ba_s"], "mvs_s": sh["mvs_s"],
        "sfm_unsharded_s": wall, "ba_unsharded_s": ba_wall,
        "mvs_unsharded_s": mvs_wall, "mvs_rounds": sh["mvs_rounds"],
        "k2_launches_sfm": sh["sfm_launches"]["sample_normalized_patches"],
        "k2_launches_mvs": sh["mvs_launches"]["sample_normalized_patches"],
        "k2s_launches_mvs": sh["mvs_launches"]["sample_normalized_patches_sharded"],
    }))
    log(f"stage walls by mesh on {smi}: " + json.dumps({
        name: {k: w[k] for k in ("sfm_s", "ba_s", "mvs_s", "sfm_pair_geometry_s")}
        for name, w in walls.items()}))

    n_px = gray.numel()
    kernels = [
        {"name": "rgb_to_gray", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/gray.cu",
         "replaces": "sfm_tpu_torch/io/images.py:gray_tensor (host)",
         "launches": launches["rgb_to_gray"],
         "device_kernels_per_call": k4_calls["launches"],
         "max_abs_err": 0.0, "ms": t["k4"], "plain_ms": t["k4_plain"],
         **gray_bound(n_px), "library_ms": None,
         "kernel_only_ms": kernel_only["k4"], "shape": list(rgb.shape)},
        {"name": "harris_response", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/harris.cu",
         "replaces": "sfm_tpu/ops/harris.py:79",
         "launches": launches["harris_response"],
         "launches_allpairs": allpairs["launches"]["harris_response"],
         "launches_per_rank_sfm": [lc["sfm"]["harris_response"] for lc in per_rank],
         "launches_bench": bench["kernels"]["harris_response"]["launches"],
         "max_abs_err": k1["max_abs_err"], "ms": t["k1"], "plain_ms": t["k1_plain"],
         # f32 in, f32 out; ~55 operations per pixel (two Sobels, three
         # products, three 3x3 box sums, det - k trace^2).
         **harris_bound(n_px), "library_ms": None,
         "kernel_only_ms": kernel_only["k1"],
         "nonint_rel_err": k1_shapes["nonint_rel_err"],
         "shape": list(gray.shape),
         **stress_entry(stress, "harris_response")},
        {"name": "sample_normalized_patches", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/gather.cu",
         "replaces": "sfm_tpu/ops/gather.py:112",
         "launches": launches["sample_normalized_patches"],
         "launches_allpairs": allpairs["launches"]["sample_normalized_patches"],
         "launches_allpairs_mvs": allpairs["mvs"]["launches"]["sample_normalized_patches"],
         "launches_per_rank_sfm": [lc["sfm"]["sample_normalized_patches"]
                                   for lc in per_rank],
         "launches_per_rank_mvs": [lc["mvs"]["sample_normalized_patches"]
                                   for lc in per_rank],
         "launches_bench": bench["kernels"]["sample_normalized_patches"]["launches"],
         "max_abs_err": max(k2.values()), "ms": t["k2_int"],
         "plain_ms": t["k2_int_plain"], **gather_bound(gray_bf16.numel(), img_i.numel()),
         "library_ms": None, "kernel_only_ms": kernel_only["k2_int"],
         "device_kernels_per_call": k2s["one_call"]["launches"],
         "host_us_per_call": k2s["one_call"]["host_us"],
         "samples": img_i.numel(),
         "ms_fractional": t["k2_frac"], "plain_ms_fractional": t["k2_frac_plain"],
         "bound_ms_fractional": gather_bound(gray_bf16.numel(), img_f.numel())["bound_ms"],
         "kernel_only_ms_fractional": kernel_only["k2_frac"],
         "samples_fractional": img_f.numel(),
         "launches_mvs": launches_mvs,
         "wasted_rounds_mvs": wasted9,
         "launches_mvs_schedule": {k: v["k2_launches"] for k, v in schedule.items()},
         "wasted_rounds_mvs_schedule": {k: v["wasted_rounds"]
                                        for k, v in schedule.items()},
         "launches_filter": f_seen["launches"],
         "samples_filter": f_seen["samples"],
         "mvs_share": prof["k2_ms"] / 1e3 / prof["wall_s"],
         "max_abs_err_mvs_round": k2_round["max_abs_err"],
         **stress_entry(stress, "sample_normalized_patches"),
         "samples_stress": stress["kernels"]["sample_normalized_patches"]["samples"],
         "max_abs_err_mvs_round_stress": stress["k2_round_max_abs_err"]},
        {"name": "sample_normalized_patches_sharded", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/gather.cu",
         "replaces": "sfm_tpu/ops/gather.py:264",
         "shards": SHARDS,
         "launches": sh["mvs_launches"]["sample_normalized_patches_sharded"],
         "launches_per_rank_mvs": [lc["mvs"]["sample_normalized_patches_sharded"]
                                   for lc in per_rank],
         "max_abs_err": k2s["max_abs_err"],
         "max_abs_err_plain": k2s["max_abs_err_plain"],
         "ms": k2s["ms"], "single_call_ms": k2s["single_call_ms"],
         "plain_ms": t["k2_frac_plain"], **gather_bound(gray_bf16.numel(), img_f.numel()),
         "library_ms": None, "samples": img_f.numel()},
        {"name": "sample_normalized_patches_tiled", "route": "cuda",
         "source": "sfm_tpu_torch/csrc/gather_tile.cu",
         "replaces": "tools/prof_tile.py:207",
         "launches": k3_launches,
         "max_abs_err": k3["max_abs_err"], "bit_equal_k2": k3["bit_equal_k2"],
         "ms": k3_t["ms"], "plain_ms": k3_t["plain_ms"],
         **gather_bound(tg.numel(), ti.numel()), "library_ms": None,
         "kernel_only_ms": k3_t["kernel_only_ms"],
         "kernel_only_ms_rows_route": k3_t["kernel_only_ms_rows_route"],
         "staging_routes": k3_routes,
         "k2_same_inputs_ms": k3_t["k2_same_inputs_ms"],
         "k2_same_inputs_kernel_only_ms": k3_t["k2_kernel_only_ms"],
         "samples": ti.numel(), "ms_by_mode": k3_modes,
         "kernel_only_ms_by_mode": k3_modes_kernel_only},
    ]
    log(f"chip_smoke wall {time.perf_counter() - t_start:.2f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
