"""K2 and K2b: region fetch on the card (``csrc/fetch.cu``).

Counterparts of ``gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions``
and ``fetch_rows``: copy ``D`` windows ``x[s : s + R]`` of the I and Q planes
(K2) or of one plane (K2b) into ``[D, R]``. Batched callers flatten a
``[C, T]`` bank into one ``[C*T]`` plane and add ``c * T`` to each channel's
(channel-clipped) starts. Each wrapper launches the kernel for CUDA tensors
and runs its plain version for CPU tensors. Starts are clamped to
``[0, T - R]`` on both routes.
"""

from __future__ import annotations

import torch

from ..utils.device import kernel_route
from . import _build

__all__ = ["fetch_regions", "fetch_regions_plain", "fetch_rows", "fetch_rows_plain"]


def fetch_regions_plain(
    xr: torch.Tensor, xi: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows as rows of the planes' sliding-window views."""
    return fetch_rows_plain(xr, starts, region_len), fetch_rows_plain(xi, starts, region_len)


def fetch_rows_plain(x: torch.Tensor, starts: torch.Tensor, region_len: int) -> torch.Tensor:
    """Windows as rows of the plane's sliding-window view."""
    s = starts.clamp(0, x.shape[0] - region_len)
    return x.unfold(0, region_len, 1)[s]


def _check(planes: tuple[torch.Tensor, ...], starts: torch.Tensor, region_len: int) -> None:
    for x in planes:
        if x.dtype != torch.float32:
            raise ValueError("sample planes must be float32")
        if x.ndim != 1 or x.shape != planes[0].shape:
            raise ValueError(f"planes must be 1-D and alike, got {[tuple(p.shape) for p in planes]}")
    if starts.dtype != torch.int64 or starts.ndim != 1:
        raise ValueError(f"starts must be int64 [D], got {starts.dtype} {tuple(starts.shape)}")
    t = planes[0].shape[0]
    if not 0 < region_len <= t:
        raise ValueError(f"region_len {region_len} outside (0, {t}]")


def fetch_regions(
    xr: torch.Tensor, xi: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch ``[D, region_len]`` I/Q planes at ``starts`` (int64 ``[D]``)
    from float32 planes ``xr``/``xi`` ``[T]``. The copy is bit-exact."""
    route = kernel_route(xr, xi, starts)
    _check((xr, xi), starts, region_len)
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
        outi.data_ptr(), xr.shape[0], region_len, d, _build.stream_of(xr),
    )
    return outr, outi


def fetch_rows(x: torch.Tensor, starts: torch.Tensor, region_len: int) -> torch.Tensor:
    """Fetch ``[D, region_len]`` windows at ``starts`` (int64 ``[D]``) from
    one float32 plane ``x`` ``[T]``. The copy is bit-exact."""
    route = kernel_route(x, starts)
    _check((x,), starts, region_len)
    if route == "plain":
        return fetch_rows_plain(x, starts, region_len)
    if not (x.is_contiguous() and starts.is_contiguous()):
        raise ValueError("fetch_rows needs contiguous tensors")
    d = starts.shape[0]
    out = x.new_empty(d, region_len)
    if d == 0:
        return out
    _build.launch(
        "fetch_rows", "pm_fetch_rows", x.device,
        x.data_ptr(), starts.data_ptr(), out.data_ptr(), x.shape[0],
        region_len, d, _build.stream_of(x),
    )
    return out
