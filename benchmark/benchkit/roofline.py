"""What a kernel call could take at best on the card, and the profiler
session that reads what it took.

A frozen copy of ``sfm_tpu_torch/tools/measure.py`` at commit bfc7f14:
``bound``, ``harris_bound``, ``gather_bound`` and ``kernel_named`` letter
for letter, with the published peaks of one NVIDIA H100 SXM; ``profiled``
keeps its marker kernels and its retake of a session that lost its
events, and returns the session's events for the benchmark's readers.
The byte and operation counts come from a call's shapes, never from the
program, so they count the same work whatever implements it.
"""

from __future__ import annotations

import re
import time

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound(nbytes, flops):
    """The least time the card could take, ms, and what bounds it: the
    larger of bytes over the memory rate and operations over the peak."""
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def harris_bound(n_px):
    """K1 over ``n_px`` pixels: f32 in, f32 out; ~55 operations a pixel
    (two Sobels, three products, three 3x3 box sums, det - k trace^2)."""
    return bound(2 * 4 * n_px, 55 * n_px)


def gather_bound(stack_elems, m, wid=5):
    """K2 / K3 on ``m`` samples of a bf16 stack of ``stack_elems`` values:
    the stack read once, or only the windows the samples touch where those
    are fewer bytes; 12 bytes of operands and the (2 wid + 1)^2 bf16 output
    per sample; ~8 operations per interpolated value and ~6 per normalised
    one."""
    side, win = 2 * wid + 1, 2 * wid + 2
    nbytes = (min(stack_elems * 2, m * win * win * 2) + m * 12
              + m * side * side * 2)
    return bound(nbytes, m * side * side * 14)


def kernel_named(name, base):
    """Whether a device kernel's name is ``base``'s and not another
    kernel's that contains it, such as PyTorch's
    ``vectorized_gather_kernel``."""
    return re.search(rf"\b{base}\b", name) is not None


MARKERS = 10


def profiled(body, accept, sessions=8, log=print, what="profiler session"):
    """Run ``body()`` under torch.profiler and return (its result, the
    device events it caused, every event of the session) from the first
    session in which ``accept(result, device_events)`` holds.  A session
    opens with ten marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``) and a sync and ends in a sync, so its device events
    apart from the markers are the body's, told apart by name.  The
    profiler now and then loses a session's events, all of them at times:
    a session without its ten markers, or that fails ``accept``, is logged
    and taken again after a pause that doubles each time, up to
    ``sessions``.  Raises RuntimeError when none holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pause = 0.01
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKERS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            result = body()
            torch.cuda.synchronize()
        events = list(prof.events())
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        body_events = [e for e in device
                       if not kernel_named(e.name, "spin_kernel")]
        markers = len(device) - len(body_events)
        if markers == MARKERS and accept(result, body_events):
            return result, body_events, events
        log(f"{what}: session {attempt} of {sessions} not accepted "
            f"({markers} of {MARKERS} markers and {len(body_events)} other "
            f"device events seen); again")
        time.sleep(pause)
        pause *= 2
    raise RuntimeError(f"{what}: no profiler session of {sessions} accepted")
