"""What a kernel call could take at best on the card, and what it took.

``bound`` is the least time an NVIDIA H100 SXM could spend on a call: the
larger of the bytes it must move over the memory rate and its operations
over the float32 peak (none of the kernels uses the tensor cores).
``harris_bound`` and ``gather_bound`` count those bytes and operations for
K1 (``ops/harris.py``) and K2 / K3 (``ops/gather.py``,
``ops/gather_tile.py``) from the shapes of a call.  ``kernel_only_ms``
reads a kernel's own device time under torch.profiler.  ``chip_smoke.py``
and ``tools/stress_scale.py`` report with these, so both count alike.
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


def kernel_only_ms(fn, name_part, calls=20, log=print):
    """Device time per call of the kernels named ``name_part`` when ``fn``
    runs, under torch.profiler: the kernel alone, apart from the other
    launches of its wrapper.  Raises RuntimeError when three profiler
    sessions each lose more than half of the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marker = torch.empty(1024, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                marker.fill_(0.0)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel_named(e.name, name_part)]
        # The profiler may lose the first events of a session (hence the
        # fills that open it), now and then all of them: average those
        # seen, or profile again.
        if calls // 2 <= len(us) <= calls:
            return sum(us) / 1e3 / len(us)
        log(f"{name_part}: {len(us)} kernels seen in {calls} calls; again")
    raise RuntimeError(f"check failed: {name_part}: {len(us)} kernels seen "
                       f"in {calls} calls")
