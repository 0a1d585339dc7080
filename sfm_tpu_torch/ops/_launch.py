"""Shared checks for the kernel wrappers (ops/harris.py, ops/gather.py).

A wrapper takes its plain PyTorch version only for a tensor on the CPU; a
CUDA tensor launches the kernel or raises.  Any other device raises.
"""

from __future__ import annotations

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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def use_kernel(t: torch.Tensor, kernels) -> bool:
    """Resolve a ``kernels`` switch (None / True / False) for tensor ``t``:
    None follows the device; True on a non-CUDA tensor is an error."""
    if kernels is None:
        return t.is_cuda
    if kernels and not t.is_cuda:
        raise ValueError(f"kernels=True needs CUDA tensors, got {t.device}")
    return bool(kernels)
