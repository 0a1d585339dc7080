"""One run of one cell: set-up, the measured window, the traced passes,
the reference and the comparison, and the result line.

The window is a closed loop with one client: reconstructions back to back
for ``seconds``, each handed a fresh host copy of a scene made before its
clock starts, so the program's per-process caches keyed on the input array
miss as they do for a new dataset.  A run renders the cell's ``scenes``
scenes (one rig, a fixed texture each) and its passes take them in turn,
in an order drawn from the seed, so that every seed's run does the same
mix of work; the seed also draws the RANSAC hypotheses.
"""

from __future__ import annotations

import gc
import itertools
import random
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import sfmref
from benchkit import judge, program, scene, trace
from benchkit.catalog import Catalog
from benchkit.roofline import profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_tpu")
JUDGED_PASSES = 3    # window passes judged against the reference
PROFILED_PASSES = 2  # passes in the traced run's profiler session


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is jax's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""

    frames: int
    shapes: dict
    setup_s: float = 0.0
    first_recon_s: float = 0.0
    passes: list = field(default_factory=list)   # the window's passes
    window_wall_s: float = 0.0
    peak_window_bytes: int | None = None
    profile: dict | None = None


def _reservoir(rng, kept, k, seen, item):
    """Keep a uniform sample of ``k`` of the items seen so far."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(seen)
        if j < k:
            kept[j] = item


def ransac_uniforms(n_pairs: int, hypotheses: int, seed: int):
    """The RANSAC draws of a run, as the program makes them from
    ``RuntimeConfig.seed``: (pairs, hypotheses * 8) float64 uniforms from
    a CPU ``torch.Generator`` seeded with the run's seed."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n_pairs, hypotheses * 8), generator=gen,
                      dtype=torch.float64)


def n_pairs(n: int, mode: str) -> int:
    return n - 1 if mode == "sequence" else n * (n - 1) // 2


def run_cell(root: str, cell: str, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, log=print):
    """Run ``cell`` once and return the result line's dict."""
    catalog = Catalog(root)
    entry, job, config = catalog.cell(cell)
    readers = [(m, catalog.reader(m))
               for m in catalog.metrics_for(cell, trace_on)]
    device = torch.device(device)
    on_card = device.type == "cuda"
    sc = config["scene"]
    feats = config["pipeline"]["features"]
    run = RunData(frames=sc["frames"], shapes={
        "frames": sc["frames"], "height": sc["height"], "width": sc["width"],
        "max_corners": feats["max_corners"], "desc_wid": feats["desc_wid"]})

    # --- Set-up: libraries, context, scenes, first reconstruction, then a
    # warm-up pass on each other scene.
    program.load_libraries(device)
    if on_card:
        torch.zeros(1, device=device).sum().item()
    scenes, K, R, t = scene.render_set(sc, job["scenes"], device)
    calib = program.calibration(K, R, t)
    pconfig = program.pipeline_config(config, job, device, seed)
    order = random.Random(seed).sample(range(len(scenes)), len(scenes))
    turn = itertools.count()

    def next_input():
        """(scene index, a fresh copy of that scene) of the next pass."""
        i = order[next(turn) % len(order)]
        return i, program.fresh_copy(scenes[i])

    def one(spans=False, given=None):
        i, img = next_input() if given is None else given
        rec = program.run_pass(img, calib, pconfig, job, device, spans)
        rec["scene"] = i
        return rec

    t0 = time.perf_counter()
    one()
    run.first_recon_s = time.perf_counter() - t0
    for _ in range(len(scenes) - 1):
        one()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    w0 = time.perf_counter()
    run.setup_s = w0 - t_start

    # --- The window.
    rng = random.Random(seed)
    judged, seen = [], 0
    profile_at = w0 + 0.4 * seconds if trace_on else None
    w_end = w0
    while time.perf_counter() - w0 < seconds:
        if profile_at is not None and time.perf_counter() >= profile_at:
            profile_at = None
            recs = _profile(one, next_input, PROFILED_PASSES, run, log)
        else:
            recs = [one()]
        w_end = time.perf_counter()
        for rec in recs:
            seen += 1
            _reservoir(rng, judged, JUDGED_PASSES, seen,
                       (rec["scene"], rec.pop("out")))
            run.passes.append(rec)
    run.window_wall_s = w_end - w0
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    peak = max(p for p in (setup_peak, run.peak_window_bytes) if p is not None) \
        if on_card else 0

    walls = sorted(p["wall"] for p in run.passes)
    log(f"window: {len(walls)} reconstructions in {run.window_wall_s:.4f} s; "
        f"wall median {statistics.median(walls):.6f} s, "
        f"p90 {float(np.percentile(walls, 90)):.6f} s, "
        f"min {walls[0]:.6f} s, max {walls[-1]:.6f} s; "
        f"first {run.first_recon_s:.6f} s; set-up {run.setup_s:.4f} s")

    # --- The reference, once the program's state is freed.
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    uniforms = ransac_uniforms(n_pairs(sc["frames"], job["pair_mode"]),
                               config["pipeline"]["ransac"]["num_hypotheses"],
                               seed)
    numbers = judge.worst([
        judge_passes([o for j, o in judged if j == i], scenes[i], (K, R, t),
                     config["pipeline"], job, uniforms, device)
        for i in sorted({j for j, _ in judged})])
    correct, checks = judge.verdict(numbers, job.get("limits", {}))
    log(f"reference and comparison: {time.perf_counter() - r0:.3f} s over "
        f"{len(judged)} of {seen} passes drawn from the seed; "
        + ", ".join(f"{k} {v}" for k, v in numbers.items()))

    metrics = {}
    for m, mod in readers:
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": seen,
              "failed": 0 if correct else len(judged),
              "metrics": metrics, "device": dev}
    if trace_on and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = checks
    return result


def judge_passes(outs, images, cams, params, job, uniforms, device,
                 reference_sfm=None):
    """The worst of each number over the passes ``outs`` against the
    reference: its SfM from the images, its BA and MVS from each pass's
    tracks (worked out once for passes with the same tracks)."""
    if reference_sfm is None:
        reference_sfm = sfmref.sparse_stage(images, *cams, params, job,
                                            uniforms, device)
    later = {}
    readings = []
    for out in outs:
        key = judge.tracks_digest(out)
        if key not in later:
            later[key] = judge.reference_next(images, cams, out, params, job,
                                              device)
        readings.append(judge.compare(out, reference_sfm, later[key], cams,
                                      device))
    return judge.worst(readings)


def _profile(one, next_input, n: int, run: RunData, log):
    """``n`` passes under the profiler, retaken where the profiler lost
    events: a session is accepted when it holds one device K1 and K2 for
    each launch the program's counters counted in it."""

    def body():
        given = [next_input() for _ in range(n)]
        k1, k2 = program.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = [one(spans=True, given=g) for g in given]
        wall = time.perf_counter() - t0
        k1b, k2b = program.launch_counts()
        return recs, wall, k1b - k1, k2b - k2

    def accept(result, events):
        _, _, dk1, dk2 = result
        kernels = [e.name for e in events]
        return (sum(trace.kernel_named(x, "harris_kernel") for x in kernels)
                == dk1 and
                sum(trace.kernel_named(x, "gather_kernel") for x in kernels)
                == dk2)

    (recs, wall, _, _), body_events, all_events = profiled(
        body, accept, log=log, what=f"{n} profiled passes")
    run.profile = trace.summarize(body_events, all_events, wall, n)
    return recs
