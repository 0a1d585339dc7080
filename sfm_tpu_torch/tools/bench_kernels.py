"""Time kernels K1, K2 and K3 alone, one version of the sources against
another.

Run on a machine with an NVIDIA GPU:

    python3 -m sfm_tpu_torch.tools.bench_kernels [--csrc DIR ...] [--calls 20]
        [--host-calls 2000] [--only SUBSTRING ...]

Each ``--csrc DIR`` is a directory of kernel sources with this package's
entry points (``sfm_tpu_torch/csrc`` itself when none is given; an earlier
commit's ``csrc`` unpacked somewhere, or a copy with one part of a kernel
taken out, to see what that part costs).  Every directory is built into
its own library and bound as its own declarations say (K2's in-bounds
output is passed where the entry point takes it).  The kernels are launched
straight through the C entry points, without the wrappers, at the main
path's shapes:

  K1  48 x 480 x 640 f32, integer gray;
  K2  49,152 integer centres (the SfM stage), 163,840 fractional centres
      (an MVS round), 81,920 in-bounds fractional centres, on the bf16
      stack, wid 5; and on the tile tool's own case (``prof_tile.build_case``:
      81,920 in-bounds centres on its random 48 x 480 x 640 stack);
  K3  the tile tool's case at S 8, 32 and 128 in its three modes (copy-only,
      single- and double-buffered), and at S 32 copy-only and double-buffered
      on the same images three columns wider (643, an odd pitch: K3's
      per-row route where the sources have two; the same windows, so the
      same outputs).

``--only`` keeps the cases whose name contains one of its arguments.

The versions are timed in turns (a, b, ..., b, a) inside one process, on
one card.  Per version and case one JSON line: the median over the turns of
the kernel's device time per launch under torch.profiler (ms), and a
checksum of each output, so versions that should agree bit for bit can be
seen to.  The first line names the card and its power limit.

Last, where ``--host-calls`` is not 0, the host's share of a K2 call: the
microseconds to enqueue one call of the C entry point of each version, and
of this package's wrapper (``ops.gather.sample_normalized_patches``), in a
loop at 1,024 samples, where the device never holds the host up.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from sfm_tpu_torch.tools import prof_tile
from sfm_tpu_torch.utils import build

WID = 5
ENTRY = {"k1": "harris_response_f32", "k2": "sample_normalized_patches_bf16",
         "k3": "sample_normalized_patches_tiled_bf16"}


def cases(device):
    """The inputs: name -> (kernel, tensors...)."""
    rng = np.random.default_rng(0)
    n, h, w = 48, 480, 640
    gray = torch.from_numpy(np.rint(rng.random((n, h, w)) * 255)
                            .astype(np.float32)).to(device)
    stack = gray.to(torch.bfloat16)

    def samples(m, lo, hi_x, hi_y, integer=False):
        img = rng.integers(0, n, m).astype(np.int32)
        ctr = np.stack([rng.uniform(lo, hi_x, m), rng.uniform(lo, hi_y, m)], 1)
        if integer:
            ctr = np.floor(ctr)
        return (torch.from_numpy(img).to(device),
                torch.from_numpy(ctr.astype(np.float32)).to(device))

    out = {
        "k1_48x480x640": ("k1", gray),
        "k2_49152_integer": ("k2", stack, *samples(
            49152, WID + 1, w - WID - 2, h - WID - 2, integer=True)),
        "k2_163840_fractional": ("k2", stack, *samples(163840, -3.0, w + 3.0,
                                                       h + 3.0)),
        "k2_81920_inbounds": ("k2", stack, *samples(
            81920, WID + 1, w - WID - 2, h - WID - 2)),
    }
    tool = prof_tile.case_tensors(81920, device)
    out["k2_81920_tool_case"] = ("k2", *tool)
    for _, mode, S, kw in prof_tile.modes():
        out[f"k3_81920_S{S}_{mode}"] = ("k3", *tool, S, kw["double_buffer"],
                                        kw["extract"])
    wider = torch.zeros((n, h, w + 3), dtype=tool[0].dtype, device=device)
    wider[:, :, :w] = tool[0]
    for mode, double, extract in (("copy", True, False), ("double", True, True)):
        out[f"k3_81920_S32_{mode}_643_wide"] = (
            "k3", wider, *tool[1:], 32, double, extract)
    return out


def load(csrc_dir):
    """``csrc_dir`` built into its own library and bound as its own
    declarations say (an earlier version's entry points may take other
    arguments than this package's table holds); and the build's output."""
    path = build.build_kernels(csrc_dir)
    lib = ctypes.CDLL(path)
    for name, argtypes in build.declared_entry_points(csrc_dir).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with open(path[:-3] + ".log") as f:
        return lib, f.read()


def launcher(lib, case):
    """(launch(), outputs, kernel-name part) for one case on one library."""
    kind, first, *rest = case
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "k1":
        n, h, w = first.shape
        out = torch.empty_like(first)

        def launch():
            return lib.harris_response_f32(first.data_ptr(), out.data_ptr(),
                                           n, h, w, ctypes.c_float(0.04), stream)

        return launch, [out], "harris_kernel"
    if kind == "k3":
        img, ctr, S, double, extract = rest
        n, h, w = first.shape
        m = img.shape[0]
        out = torch.empty((m, (2 * WID + 1) ** 2), dtype=torch.bfloat16,
                          device=first.device)
        args = [first.data_ptr(), img.data_ptr(), ctr.data_ptr(), out.data_ptr(),
                m, n, h, w, WID, S, int(double), int(extract), stream]

        def launch():
            return lib.sample_normalized_patches_tiled_bf16(*args)

        # every version's K3 kernels are named gather_tile_*
        return launch, [out], "gather_tile_"
    img, ctr = rest
    n, h, w = first.shape
    m = img.shape[0]
    out = torch.empty((m, (2 * WID + 1) ** 2), dtype=torch.bfloat16,
                      device=first.device)
    outs = [out]
    args = [first.data_ptr(), img.data_ptr(), ctr.data_ptr(), out.data_ptr()]
    if len(lib.sample_normalized_patches_bf16.argtypes) == 11:
        inb = torch.empty((m,), dtype=torch.bool, device=first.device)
        outs.append(inb)
        args.append(inb.data_ptr())
    args += [m, n, h, w, WID, stream]

    def launch():
        return lib.sample_normalized_patches_bf16(*args)

    return launch, outs, "gather_kernel"


def kernel_ms(launch, name_part, calls):
    """Device ms per launch of the kernels named ``*name_part*``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    seen, us = [], []
    marker = torch.empty(1024, device="cuda")
    for _ in range(5):  # a profiler window now and then loses its events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the first events of a session are the ones it may lose
            for _ in range(10):
                marker.fill_(0.0)
            torch.cuda.synchronize()
            for _ in range(calls):
                err = launch()
                if err:
                    raise RuntimeError(f"launch failed (cudaError {err})")
            torch.cuda.synchronize()
        seen = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        us = [e.time_range.elapsed_us() for e in seen if name_part in e.name]
        if calls // 2 <= len(us) <= calls:
            break
    else:
        raise RuntimeError(
            f"{name_part}: {len(us)} kernels seen in {calls} calls; on the "
            f"device: {sorted({e.name for e in seen})}")
    return sum(us) / 1e3 / len(us)


def host_us(fn, calls):
    """Host microseconds to enqueue one call of ``fn`` (nothing is waited
    for inside the loop)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", action="append", default=None)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--host-calls", type=int, default=2000)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: bench_kernels needs a CUDA device", file=sys.stderr)
        return 1
    dirs = args.csrc or [build.CSRC_DIR]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {}
    for d in dirs:
        libs[d], build_log = load(d)
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {d}: {line.strip()}", flush=True)
    turns = dirs + dirs[::-1] if len(dirs) > 1 else dirs * 2
    inputs = cases(torch.device("cuda"))
    for name, case in inputs.items():
        if args.only is not None and not any(o in name for o in args.only):
            continue
        times = {d: [] for d in dirs}
        sums = {}
        entry = ENTRY[case[0]]
        for d in turns:
            if entry not in build.declared_entry_points(d):
                continue  # this directory holds the other kernel only
            launch, outs, part = launcher(libs[d], case)
            times[d].append(kernel_ms(launch, part, args.calls))
            sums[d] = [hashlib.sha1(o.view(torch.uint8).cpu().numpy().tobytes())
                       .hexdigest()[:12] for o in outs]
        for d in dirs:
            if not times[d]:
                continue
            print(json.dumps({"case": name, "csrc": d,
                              "kernel_only_ms": statistics.median(times[d]),
                              "turns_ms": times[d], "sha1": sums[d]}),
                  flush=True)
    if args.host_calls:
        from sfm_tpu_torch.ops.gather import sample_normalized_patches

        kind, stack, img, ctr = inputs["k2_81920_inbounds"]
        small = (kind, stack, img[:1024].contiguous(), ctr[:1024].contiguous())
        entry = "sample_normalized_patches_bf16"
        raw = {d: [] for d in dirs if entry in build.declared_entry_points(d)}
        wrapper = []
        for d in turns:
            if d in raw:
                raw[d].append(host_us(launcher(libs[d], small)[0],
                                      args.host_calls))
            wrapper.append(host_us(
                lambda: sample_normalized_patches(stack, small[2], small[3],
                                                  WID), args.host_calls))
        for d, us in raw.items():
            print(json.dumps({"case": "k2_host_1024", "csrc": d,
                              "entry_point_us": statistics.median(us),
                              "turns_us": us}), flush=True)
        print(json.dumps({"case": "k2_host_1024", "csrc": build.CSRC_DIR,
                          "wrapper_us": statistics.median(wrapper),
                          "turns_us": wrapper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
