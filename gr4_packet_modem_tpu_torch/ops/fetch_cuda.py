"""K2 and K2b: region fetch on the card (``csrc/fetch.cu``).

Counterparts of ``gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions``
and ``fetch_rows``. K2 copies ``D`` windows ``x[s : s + R]`` of a complex64
sample bank, read as it lies, into ``[D, R]`` I and Q planes; K2b copies
``D`` windows of one float32 plane into ``[D, R]``. Batched callers flatten
a contiguous ``[C, T]`` bank into ``[C*T]`` and add ``c * T`` to each
channel's (channel-clipped) starts. Each wrapper launches the kernel for
CUDA tensors and runs its plain version for CPU tensors. Starts are clamped
to ``[0, T - R]`` on both routes.
"""

from __future__ import annotations

import torch

from ..utils.device import kernel_route
from . import _build

__all__ = [
    "RUN", "THREADS", "fetch_plan", "fetch_regions", "fetch_regions_plain",
    "fetch_rows", "fetch_rows_plain", "rows_plan",
]

THREADS = 256  # threads a block, both kernels (csrc/fetch.cu: kThreads)
RUN = 4  # consecutive output samples a K2 item copies (csrc/fetch.cu: kRun)


def fetch_plan(region_len: int, d: int) -> dict:
    """K2's thread plan for ``d`` windows of ``region_len`` samples.

    The work is flat over the ``elements`` = ``d * region_len`` samples of
    the output in ``items`` of ``RUN``: item ``i`` copies output samples
    ``RUN * i`` on, which start at column ``RUN * i % region_len`` of row
    ``RUN * i // region_len``. Thread ``t`` of block ``b`` copies items
    ``b * threads + t``, then every ``blocks * threads`` on. An item that
    lies in one row loads its run as two float4 where the run's first
    sample is 16-byte aligned, else sample by sample as float2; an item
    that runs into the next row loads sample by sample from each row's
    window. Every item is stored as one float4 a plane but the output's
    last when ``tail`` (``elements % RUN``) is not 0, which is stored
    sample by sample."""
    elements = d * region_len
    if region_len <= 0 or d < 0 or elements >= 2**31:
        raise ValueError(f"fetch kernel: region_len {region_len}, d {d}")
    items = -(-elements // RUN)
    return {
        "threads": THREADS, "run": RUN, "elements": elements, "items": items,
        "blocks": max(1, -(-items // THREADS)), "tail": elements % RUN,
    }


def rows_plan(region_len: int, d: int) -> dict:
    """K2b's thread plan: one thread an output element of the flat
    ``[d, region_len]`` output, ``blocks`` of ``threads``."""
    items = d * region_len
    if region_len <= 0 or d < 0 or items >= 2**31:
        raise ValueError(f"fetch_rows kernel: region_len {region_len}, d {d}")
    return {"threads": THREADS, "items": items, "blocks": max(1, -(-items // THREADS))}


def fetch_regions_plain(
    x: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows as rows of the bank's sliding-window view, split into the
    I and Q planes."""
    s = starts.clamp(0, x.shape[0] - region_len)
    w = torch.view_as_real(x).unfold(0, region_len, 1)[s]  # [D, 2, R]
    w = w.transpose(0, 1).contiguous()
    return w[0], w[1]


def fetch_rows_plain(x: torch.Tensor, starts: torch.Tensor, region_len: int) -> torch.Tensor:
    """Windows as rows of the plane's sliding-window view."""
    s = starts.clamp(0, x.shape[0] - region_len)
    return x.unfold(0, region_len, 1)[s]


def _check(x: torch.Tensor, dtype: torch.dtype, starts: torch.Tensor, region_len: int) -> None:
    if x.dtype != dtype or x.ndim != 1:
        raise ValueError(f"samples must be {dtype} [T], got {x.dtype} {tuple(x.shape)}")
    if starts.dtype != torch.int64 or starts.ndim != 1:
        raise ValueError(f"starts must be int64 [D], got {starts.dtype} {tuple(starts.shape)}")
    t = x.shape[0]
    if not 0 < region_len <= t:
        raise ValueError(f"region_len {region_len} outside (0, {t}]")


def fetch_regions(
    x: torch.Tensor, starts: torch.Tensor, region_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch ``[D, region_len]`` I and Q planes at ``starts`` (int64
    ``[D]``) from the contiguous complex64 bank ``x`` ``[T]``. The copy is
    bit-exact. A non-contiguous ``x`` is refused, never copied."""
    route = kernel_route(x, starts)
    _check(x, torch.complex64, starts, region_len)
    if not x.is_contiguous():
        raise ValueError("fetch_regions needs a contiguous bank")
    if route == "plain":
        return fetch_regions_plain(x, starts, region_len)
    if not starts.is_contiguous():
        raise ValueError("fetch_regions needs contiguous starts")
    d = starts.shape[0]
    outr = x.new_empty(d, region_len, dtype=torch.float32)
    outi = x.new_empty(d, region_len, dtype=torch.float32)
    if d == 0:
        return outr, outi
    _build.launch(
        "fetch", "pm_fetch_regions", x.device,
        x.data_ptr(), starts.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        x.shape[0], region_len, d, fetch_plan(region_len, d)["blocks"], _build.stream_of(x),
    )
    return outr, outi


def fetch_rows(x: torch.Tensor, starts: torch.Tensor, region_len: int) -> torch.Tensor:
    """Fetch ``[D, region_len]`` windows at ``starts`` (int64 ``[D]``) from
    one float32 plane ``x`` ``[T]``. The copy is bit-exact."""
    route = kernel_route(x, starts)
    _check(x, torch.float32, starts, region_len)
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
        region_len, d, rows_plan(region_len, d)["blocks"], _build.stream_of(x),
    )
    return out
