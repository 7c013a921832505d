"""K3: the per-detection matched filter on the card (``csrc/matched.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/matched_pallas.py::
matched_filter_pallas``: filter each detection's region with its own
time-reversed taps and decimate by ``sps``,
``out[d, s] = sum_k z[d, sps*s + k] * taps[d, k]``, reading zeros past the
region's end. :func:`matched_filter` launches the kernel for CUDA tensors
and runs :func:`matched_filter_plain` for CPU tensors.

The kernel sums each output over the phases ``p < sps`` and, within a
phase, over ``q`` (tap ``k = sps*q + p``); ``tests/test_torch_kernel_models.py``
holds a numpy model of that order against the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import kernel_route
from . import _build

__all__ = ["matched_filter", "matched_filter_plain"]


def matched_filter_plain(
    zr: torch.Tensor, zi: torch.Tensor, taps: torch.Tensor, sps: int,
    num_syms: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorised counterpart of ``matched_filter_reference``: the windows
    as a strided view of the zero-extended regions, then one product and
    sum per output."""
    k = taps.shape[1]
    need = sps * (num_syms - 1) + k

    def one(z):
        if z.shape[1] < need:
            z = F.pad(z, (0, need - z.shape[1]))
        win = z.unfold(1, k, sps)[:, :num_syms]  # [D, S, K]
        return (win * taps[:, None, :]).sum(-1)

    return one(zr), one(zi)


def matched_filter(
    zr: torch.Tensor, zi: torch.Tensor, taps: torch.Tensor, sps: int,
    num_syms: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter+decimate: ``zr``/``zi`` float32 ``[D, R]``, ``taps`` float32
    ``[D, K]`` (time-reversed). Returns float32 ``[D, num_syms]`` planes."""
    route = kernel_route(zr, zi, taps)
    for name, t in (("zr", zr), ("zi", zi), ("taps", taps)):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name} must be a float32 matrix, got {t.dtype} {tuple(t.shape)}")
    d, r = zr.shape
    if zi.shape != zr.shape or taps.shape[0] != d:
        raise ValueError(f"shapes disagree: {tuple(zr.shape)}, {tuple(zi.shape)}, {tuple(taps.shape)}")
    if sps < 1 or num_syms < 1:
        raise ValueError(f"sps={sps} and num_syms={num_syms} must be positive")
    if route == "plain":
        return matched_filter_plain(zr, zi, taps, sps, num_syms)
    for t in (zr, zi, taps):
        if not t.is_contiguous():
            raise ValueError("matched_filter needs contiguous tensors")
    if d * -(-num_syms // 9) > 2**31 - 1:
        raise ValueError(f"D={d} x num_syms={num_syms} exceeds the kernel's grid")
    outr = zr.new_empty(d, num_syms)
    outi = zr.new_empty(d, num_syms)
    if d == 0:
        return outr, outi
    _build.launch(
        "matched", "pm_matched_filter", zr.device,
        zr.data_ptr(), zi.data_ptr(), taps.data_ptr(), outr.data_ptr(),
        outi.data_ptr(), r, taps.shape[1], int(sps), int(num_syms), d,
        _build.stream_of(zr),
    )
    return outr, outi
