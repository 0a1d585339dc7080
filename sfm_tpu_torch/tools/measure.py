"""What a kernel call could take at best on the card, and what it took.

``bound`` is the least time an NVIDIA H100 SXM could spend on a call: the
larger of the bytes it must move over the memory rate and its operations
over the float32 peak (none of the kernels uses the tensor cores).
``harris_bound``, ``gray_bound`` and ``gather_bound`` count those bytes and
operations for K1 (``ops/harris.py``), K4 (``ops/gray.py``) and K2 / K3
(``ops/gather.py``, ``ops/gather_tile.py``) from the shapes of a call.  ``kernel_only_ms``
reads a kernel's own device time under torch.profiler, through
``profiled``, which takes a session again where the profiler lost its
events.  ``tools/stress_scale.py`` reports with these and the card tests
(``tests/test_torch_*_cuda.py``) count kernels with them, so both count
alike.
"""

from __future__ import annotations

import re

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


def gray_bound(n_px):
    """K4 (``ops/gray.py``) over ``n_px`` pixels: 3 bytes of uint8 RGB in,
    a float32 out; five operations a pixel (three products, two sums)."""
    return bound(7 * n_px, 5 * n_px)


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
    """Whether a device kernel's name is ``base``'s (K1 ``harris_kernel``,
    K2 ``gather_kernel``, K3 ``gather_tile_tma_kernel`` or
    ``gather_tile_rows_kernel``) and not another kernel's that contains
    it, such as PyTorch's ``vectorized_gather_kernel``."""
    return re.search(rf"\b{base}\b", name) is not None


def profiled(body, accept, sessions=8, log=print, what="profiler session"):
    """Run ``body()`` under torch.profiler and return (its result, the
    device kernels it launched, the profile) from the first session in
    which ``accept(result, kernels)`` holds.  A session opens with ten
    marker kernels (``torch.cuda._sleep``'s ``spin_kernel``, which nothing
    else launches) and a sync, and ends in a sync, so its device events
    apart from the markers are the body's, told apart by name and not by
    timestamp.  The profiler now and then loses a session's events, all
    of them at times: a session that fails ``accept`` is logged and taken
    again after a pause that doubles each time (10 ms first), up to
    ``sessions``.  Raises RuntimeError, naming the device kernels the last
    session saw, when none holds."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    pause = 0.01
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            result = body()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device if not kernel_named(e.name, "spin_kernel")]
        if accept(result, kernels):
            return result, kernels, prof
        log(f"{what}: session {attempt} of {sessions} not accepted "
            f"({len(device) - len(kernels)} of 10 markers and {len(kernels)} "
            f"other device kernels seen); again")
        time.sleep(pause)
        pause *= 2
    raise RuntimeError(f"check failed: {what}: no profiler session of "
                       f"{sessions} accepted; the last saw "
                       f"{sorted({e.name[:80] for e in kernels})}")


def kernel_only_ms(fn, name_part, calls=20, log=print):
    """Device time per call of the kernels named ``name_part`` when ``fn``
    runs, under torch.profiler: the kernel alone, apart from the other
    launches of its wrapper.  A session that sees fewer than half the
    calls' kernels, or more, is taken again (``profiled``)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            fn()

    def named(kernels):
        return [e for e in kernels if kernel_named(e.name, name_part)]

    _, kernels, _ = profiled(
        body, lambda _, kernels: calls // 2 <= len(named(kernels)) <= calls,
        log=log, what=f"{name_part} x {calls}")
    us = [e.time_range.elapsed_us() for e in named(kernels)]
    return sum(us) / 1e3 / len(us)
