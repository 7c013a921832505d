"""K4: the Costas loop on the card (``csrc/costas.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/costas_pallas.py::
costas_track_pallas``: loop-exact tracking with the receiver's positional
schedule (PILOT below symbol 64, QPSK at header bandwidth below 192, QPSK
at payload bandwidth after), starting at packet symbol ``offset``.
:func:`costas_track` launches the kernel for CUDA tensors and runs
:func:`costas_track_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils.device import kernel_route
from . import _build
from .costas import costas_run, costas_segments

__all__ = ["costas_track", "costas_track_plain"]


def costas_track_plain(
    symbols: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recursion as ``costas_run`` over the positional schedule."""
    const_ids, k1, k2 = costas_segments(
        symbols.shape[-1], symbols.device, offset=offset
    )
    return costas_run(symbols, phase0, freq0, const_ids, k1, k2)


def costas_track(
    symbols: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor,
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track ``symbols`` complex64 ``[B, S]`` from loop state ``phase0``,
    ``freq0`` float32 ``[B]``. Returns ``(corrected [B, S], phase_end [B],
    freq_end [B])``, ``corrected`` contiguous on both routes."""
    route = kernel_route(symbols, phase0, freq0)
    if symbols.dtype != torch.complex64 or symbols.ndim != 2:
        raise ValueError(f"symbols must be complex64 [B, S], got {symbols.dtype} {tuple(symbols.shape)}")
    b, s = symbols.shape
    for name, t in (("phase0", phase0), ("freq0", freq0)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be float32 [{b}], got {t.dtype} {tuple(t.shape)}")
    if route == "plain":
        return costas_track_plain(symbols, phase0, freq0, offset)
    for t in (symbols, phase0, freq0):
        if not t.is_contiguous():
            raise ValueError("costas_track needs contiguous tensors")
    out = torch.empty_like(symbols)
    ph_end = torch.empty_like(phase0)
    fr_end = torch.empty_like(freq0)
    if b == 0:
        return out, ph_end, fr_end
    _build.launch(
        "costas", "pm_costas_track", symbols.device,
        symbols.data_ptr(), out.data_ptr(), phase0.data_ptr(),
        freq0.data_ptr(), ph_end.data_ptr(), fr_end.data_ptr(),
        b, s, int(offset), _build.stream_of(symbols),
    )
    return out, ph_end, fr_end
