"""Explicit device handling.

Every entry point of the port takes a ``device``; nothing here picks one on
the caller's behalf. A kernel wrapper asks :func:`kernel_route` which way to
go for the tensors it was handed: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors, and an error for anything else.
:func:`require_device` turns an app's ``--device`` into a device, refusing
``cuda`` where there is no card.
"""

from __future__ import annotations

import torch

__all__ = ["kernel_route", "require_device"]


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


def require_device(name: str | torch.device) -> torch.device:
    """``name`` as a ``torch.device``; a CUDA device without a usable card
    raises (the caller asked for the card, so nothing runs elsewhere)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is false")
    return dev
