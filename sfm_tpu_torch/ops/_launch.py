"""Shared checks for the kernel wrappers (ops/harris.py, ops/gather.py).

A wrapper takes its plain PyTorch version only for a tensor on the CPU; a
CUDA tensor launches the kernel or raises.  Any other device raises.  A
kernel launches on its tensor's device (``launch_on``), whichever device
the calling thread has current.
"""

from __future__ import annotations

import contextlib

import torch


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU inputs, False for CUDA inputs (all on one device)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA inputs must be contiguous")
    return False


def check_launch(name: str, err: int) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


@contextlib.contextmanager
def launch_on(t: torch.Tensor):
    """Make ``t``'s device current for a launch and yield that device's
    current stream (a C entry point launches with ``<<<..., stream>>>`` on
    the thread's current device, so both have to be ``t``'s)."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream().cuda_stream


def use_kernel(t: torch.Tensor, kernels) -> bool:
    """Resolve a ``kernels`` switch (None / True / False) for tensor ``t``:
    None follows the device; True on a non-CUDA tensor is an error."""
    return use_kernel_on(t.device, kernels)


def use_kernel_on(device, kernels) -> bool:
    """``use_kernel`` for tensors on ``device``, before any exists."""
    device = torch.device(device)
    if kernels is None:
        return device.type == "cuda"
    if kernels and device.type != "cuda":
        raise ValueError(f"kernels=True needs CUDA tensors, got {device}")
    return bool(kernels)
