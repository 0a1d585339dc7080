"""Device time from a profiler session of a few passes: busy time, kernels
by name, the idle gaps and the host span each fell in, and the timings of
the kernels whose rooflines the per-layer metrics read."""

from __future__ import annotations

from benchkit.roofline import kernel_named

STAGE_PREFIX = "bench."


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_span_at(cpu_events, t_us):
    """'stage:innermost host event' around the instant ``t_us``: the
    benchmark's stage span (``bench.sfm`` ...) and the shortest other host
    event covering it ('python' where none does)."""
    stage, inner, inner_len = "outside", "python", None
    for e in cpu_events:
        s, end = e.time_range.start, e.time_range.end
        if not s <= t_us <= end:
            continue
        if e.name.startswith(STAGE_PREFIX):
            stage = e.name[len(STAGE_PREFIX):]
        elif inner_len is None or end - s < inner_len:
            inner, inner_len = e.name, end - s
    return f"{stage}:{inner}"


def summarize(body_events, all_events, wall_s: float, passes: int) -> dict:
    """What the readers need of one accepted session of ``passes`` passes
    that took ``wall_s`` on the host clock.

    ``busy_s``: the union of the device events' intervals; ``kernels``:
    device kernels (not copies or fills) as (name, start_us, dur_us) in
    time order; ``device_ops``: the ten kernels and copies with the most
    device time, [name, seconds]; ``idle_gaps``: the ten longest gaps
    between device events, [host span at the gap, seconds]."""
    import torch

    # The stage spans appear on the device's timeline too, as annotations.
    body_events = [e for e in body_events
                   if not e.name.startswith(STAGE_PREFIX)]
    spans = [(e.time_range.start, e.time_range.end) for e in body_events]
    merged = _union(spans)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for e in body_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    cpu = [e for e in all_events
           if e.device_type == torch.autograd.DeviceType.CPU]
    idle = [[_host_span_at(cpu, 0.5 * (s + e)), g / 1e6] for g, s, e in gaps]
    kernels = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                     for e in body_events if _is_kernel(e.name))
    return {
        "passes": passes,
        "window_s": wall_s,
        "busy_s": busy_us / 1e6,
        "kernels": [(n, s, d) for s, n, d in kernels],
        "device_ops": [[n[:160], us / 1e6] for n, us in device_ops],
        "idle_gaps": idle,
    }


def k1_times_us(profile: dict):
    """Device time of each K1 launch of the session, us."""
    return [d for n, _, d in profile["kernels"]
            if kernel_named(n, "harris_kernel")]


def k2_sfm_times_us(profile: dict):
    """Device time of each K2 launch made inside SfM: in a pass SfM's
    features stage launches K1 and then K2 on the descriptors, before any
    other K2 of the pass, so it is the first K2 after each K1."""
    out, after_k1 = [], False
    for n, _, d in profile["kernels"]:
        if kernel_named(n, "harris_kernel"):
            after_k1 = True
        elif after_k1 and kernel_named(n, "gather_kernel"):
            out.append(d)
            after_k1 = False
    return out
