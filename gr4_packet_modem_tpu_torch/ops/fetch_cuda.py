"""K2: region fetch on the card (``csrc/fetch.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions``:
copy ``D`` windows ``x[s : s + R]`` of the I and Q planes into ``[D, R]``.
Batched callers flatten a ``[C, T]`` bank into one ``[C*T]`` plane and add
``c * T`` to each channel's (channel-clipped) starts. :func:`fetch_regions`
launches the kernel for CUDA tensors and runs :func:`fetch_regions_plain`
for CPU tensors. Starts are clamped to ``[0, T - R]`` on both routes.
"""

from __future__ import annotations

import torch

from ..utils.device import kernel_route
from . import _build

__all__ = ["fetch_regions", "fetch_regions_plain"]


def fetch_regions_plain(
    xr: torch.Tensor, xi: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows as rows of the planes' sliding-window views."""
    s = starts.clamp(0, xr.shape[0] - region_len)
    return xr.unfold(0, region_len, 1)[s], xi.unfold(0, region_len, 1)[s]


def fetch_regions(
    xr: torch.Tensor, xi: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch ``[D, region_len]`` I/Q planes at ``starts`` (int64 ``[D]``)
    from float32 planes ``xr``/``xi`` ``[T]``. The copy is bit-exact."""
    route = kernel_route(xr, xi, starts)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise ValueError("sample planes must be float32")
    if xr.ndim != 1 or xr.shape != xi.shape:
        raise ValueError(f"planes must be 1-D and alike, got {tuple(xr.shape)}, {tuple(xi.shape)}")
    if starts.dtype != torch.int64 or starts.ndim != 1:
        raise ValueError(f"starts must be int64 [D], got {starts.dtype} {tuple(starts.shape)}")
    t = xr.shape[0]
    if not 0 < region_len <= t:
        raise ValueError(f"region_len {region_len} outside (0, {t}]")
    if route == "plain":
        return fetch_regions_plain(xr, xi, starts, region_len)
    for x in (xr, xi, starts):
        if not x.is_contiguous():
            raise ValueError("fetch_regions needs contiguous tensors")
    d = starts.shape[0]
    outr = xr.new_empty(d, region_len)
    outi = xr.new_empty(d, region_len)
    if d == 0:
        return outr, outi
    _build.launch(
        "fetch", "pm_fetch_regions", xr.device,
        xr.data_ptr(), xi.data_ptr(), starts.data_ptr(), outr.data_ptr(),
        outi.data_ptr(), t, region_len, d, _build.stream_of(xr),
    )
    return outr, outi
