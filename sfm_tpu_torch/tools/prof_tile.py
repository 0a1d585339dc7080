"""Tile-resident gather experiments on the GPU.

Counterpart of ``tools/prof_tile.py``: the same case (``build_case``: the
same seed, shapes and centre ranges), swept through kernel K3
(``ops/gather_tile.py``) in the tool's three experiments, beside K2 and the
plain version on the same inputs:

  E0  the plain PyTorch version (gather + bilinear + normalise);
  E1  copy only: S windows staged per step, written out unchanged;
  E2  full kernel: staging + extraction + normalisation, single- and
      double-buffered;
  K2  ``sample_normalized_patches`` (windows read straight from global
      memory), the kernel the pipeline runs.

The TPU tool's E3-E5 timed three ways of making Mosaic shift rows and lanes;
they compute E2's values and have one counterpart here (see
``ops/gather_tile.py``).

Run on a machine with an NVIDIA GPU:

    python3 -m sfm_tpu_torch.tools.prof_tile [--check] [--m 81920] [--iters 20]

Each row is one JSON line: ``device``, ``m``, ``S``, the mode, ``time_s`` (seconds per
call: CUDA events around ``iters`` back-to-back calls, median of 5 such
windows), ``us_per_sample`` and ``gb_per_s`` (the bytes the function must
move -- the stack once, the operands once, the output once -- over the
time).  ``--check`` holds every mode against its plain version instead and
exits 1 on a mismatch.  ``--device cpu`` runs the plain versions only (host
clock), and says so: those rows measure no kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
from sfm_tpu_torch.ops.gather_tile import (
    _copy_plain,
    sample_normalized_patches_tiled,
)

S_SWEEP = (8, 32, 128)
CHECK_ATOL = 2e-2  # bf16 patch + bf16 descriptor rounding, as the TPU tool's check


def build_case(m, n_img=48, h=480, w=640, wid=5, seed=0):
    """The TPU tool's case, in numpy: gray (n, h, w) f32 in [0, 255),
    img_idx (m,) i32, centres (m, 2) f32 with the whole patch in bounds."""
    rng = np.random.default_rng(seed)
    gray = (rng.random((n_img, h, w)) * 255).astype(np.float32)
    img_idx = rng.integers(0, n_img, m).astype(np.int32)
    xs = rng.uniform(wid + 1, w - wid - 2, m).astype(np.float32)
    ys = rng.uniform(wid + 1, h - wid - 2, m).astype(np.float32)
    return gray, img_idx, np.stack([xs, ys], axis=1)


def case_tensors(m, device, **kw):
    gray, img_idx, ctr = build_case(m, **kw)
    return (torch.from_numpy(gray).to(device).to(torch.bfloat16),
            torch.from_numpy(img_idx).to(device),
            torch.from_numpy(ctr).to(device))


def modes(S_values=S_SWEEP):
    """(label, mode name, S, wrapper keywords) of every K3 row, in the
    tool's order."""
    rows = [("E1 copy-only", "copy", S,
             dict(samples_per_block=S, extract=False, double_buffer=True))
            for S in S_values]
    for S in S_values:
        for double in (False, True):
            rows.append(("E2 full", "double" if double else "single", S,
                         dict(samples_per_block=S, extract=True,
                              double_buffer=double)))
    return rows


def moved_bytes(gray, m, wid):
    """Bytes the function must move: the stack read once (every sample's
    window lies in it; at most the windows themselves), the operands read
    once, the output written once."""
    side = 2 * wid + 1
    windows = m * (side + 1) ** 2 * 2
    return min(gray.numel() * 2, windows) + m * 12 + m * side * side * 2


def time_call(fn, iters, device):
    """Seconds per call: median of 5 windows of ``iters`` back-to-back
    calls, CUDA events on a GPU, the host clock on the CPU."""
    for _ in range(3):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) / iters)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        times.append(a.elapsed_time(b) / 1e3 / iters)
    return statistics.median(times)


def row(label, mode, S, t, m, nbytes, device):
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"experiment": label, "device": name, "m": m, "S": S, "mode": mode,
            "time_s": round(t, 9), "us_per_sample": round(t / m * 1e6, 6),
            "gb_per_s": round(nbytes / t / 1e9, 3)}


def sweep(m, iters, device, wid=5, S_values=S_SWEEP, emit=print):
    """Time E0, E1, E2 and K2 at ``m`` samples; one JSON line each through
    ``emit``; returns the rows."""
    gray, img, ctr = case_tensors(m, device, wid=wid)
    nbytes = moved_bytes(gray, m, wid)
    rows = []

    def add(label, mode, S, fn):
        r = row(label, mode, S, time_call(fn, iters, device), m, nbytes, device)
        rows.append(r)
        emit(f"{label}: " + json.dumps(r))

    add("E0 plain", "plain", None, lambda: _sample_plain(gray, img, ctr, wid))
    if device.type != "cuda":
        emit("device cpu: plain versions only, no kernel was run or timed")
        add("E1 copy-only", "plain-copy", None,
            lambda: _copy_plain(gray, img, ctr, wid))
        return rows
    for label, mode, S, kw in modes(S_values):
        add(label, mode, S,
            lambda kw=kw: sample_normalized_patches_tiled(gray, img, ctr, wid, **kw))
    add("K2 direct", "k2", None,
        lambda: sample_normalized_patches(gray, img, ctr, wid))
    return rows


def check(device, m=4096, n_img=8, wid=5, S_values=S_SWEEP, emit=print):
    """Every mode against its plain version: copy-only bit-equal, the full
    modes within CHECK_ATOL.  Returns True when all agree."""
    gray, img, ctr = case_tensors(m, device, n_img=n_img, wid=wid)
    want = {True: _sample_plain(gray, img, ctr, wid).float(),
            False: _copy_plain(gray, img, ctr, wid).float()}
    if device.type != "cuda":
        emit("device cpu: the wrapper runs the plain versions, no kernel "
             "was checked")
    ok = True
    for label, mode, S, kw in modes(S_values):
        got = sample_normalized_patches_tiled(gray, img, ctr, wid, **kw).float()
        err = float((got - want[kw["extract"]]).abs().max())
        good = err == 0.0 if not kw["extract"] else err < CHECK_ATOL
        ok = ok and good
        emit(f"check {label} S={S} {mode}: max|diff| = {err:.3e} "
             f"{'ok' if good else 'MISMATCH'}")
    emit("CHECK OK" if ok else "CHECK FAILED")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--m", type=int, default=81920)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("error: no CUDA device (use --device cpu for the plain "
                  "versions)", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}")
    if args.check:
        return 0 if check(device) else 1
    sweep(args.m, args.iters, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
