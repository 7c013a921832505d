"""Explicit device handling.

Every entry point of the port takes a ``device``; nothing here picks one on
the caller's behalf. A kernel wrapper asks :func:`kernel_route` which way to
go for the tensors it was handed: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors, and an error for anything else.
"""

from __future__ import annotations

import torch

__all__ = ["kernel_route"]


def kernel_route(*tensors: torch.Tensor) -> str:
    """``"cuda"`` when every tensor lies on one CUDA device, ``"plain"``
    when every tensor lies on the CPU. Mixed devices or any other device
    type raise: there is no fallback from one route to the other."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel route for device {dev}")
