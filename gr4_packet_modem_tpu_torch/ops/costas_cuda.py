"""K4: the Costas loop on the card (``csrc/costas.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/costas_pallas.py::
costas_track_pallas``: loop-exact tracking with the receiver's positional
schedule (PILOT below symbol 64, QPSK at header bandwidth below 192, QPSK
at payload bandwidth after), starting at packet symbol ``offset``.
:func:`costas_track` launches the kernel for CUDA tensors and runs
:func:`costas_track_plain` for CPU tensors.

An optional row mask ``active`` (bool ``[B]``; the receiver passes the
detections' valid flags) leaves rows out: an inactive row's output is
zeros and its end state its start state. A slot with no detection comes
scaled by about 1e9, and its loop would run away into cosf's slow range
reduction, holding up its whole warp (``csrc/costas.cu``); nothing reads
such a row. The kernel reads the mask on the card. Always-on counters:
``rx.costas.rows`` (``utils/trace.py``), the rows handed to
:func:`costas_track`, counted from shapes; and the rows it skipped, which
the kernel adds on the card (a replayed CUDA graph adds them too) and the
CPU route on the host, read by :func:`skipped_rows`.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..utils.device import kernel_route
from ..utils.trace import count
from . import _build
from .costas import costas_run, costas_segments

__all__ = ["costas_track", "costas_track_plain", "skipped_rows"]


def costas_track_plain(
    symbols: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor,
    offset: int = 0, active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recursion as ``costas_run`` over the positional schedule; rows
    where ``active`` is False then give zeros and ``(phase0, freq0)``."""
    const_ids, k1, k2 = costas_segments(
        symbols.shape[-1], symbols.device, offset=offset
    )
    out, ph, fr = costas_run(symbols, phase0, freq0, const_ids, k1, k2)
    if active is None:
        return out, ph, fr
    return (torch.where(active[:, None], out, torch.zeros_like(out)),
            torch.where(active, ph, phase0), torch.where(active, fr, freq0))


@lru_cache(maxsize=None)  # kept: captured CUDA graphs add to this tensor by address
def _skip_counter(device: torch.device) -> torch.Tensor:
    """The int64 count of rows skipped on ``device``, made on first use."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("costas_track: call it once outside a CUDA graph capture first "
                           "(its skip counter is made then)")
    return torch.zeros((), dtype=torch.int64, device=device)


def _device_key(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def skipped_rows(device: str | torch.device) -> int:
    """Rows :func:`costas_track` has left out on ``device`` since the
    process started (one synchronising read: not for a step's path)."""
    return int(_skip_counter(_device_key(device)).item())


def costas_track(
    symbols: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor,
    offset: int = 0, active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track ``symbols`` complex64 ``[B, S]`` from loop state ``phase0``,
    ``freq0`` float32 ``[B]``, the rows where ``active`` (bool ``[B]``, or
    None: every row) is True. Returns ``(corrected [B, S], phase_end [B],
    freq_end [B])``, ``corrected`` contiguous on both routes; an inactive
    row gives zeros and ``(phase0, freq0)``."""
    tensors = (symbols, phase0, freq0) + (() if active is None else (active,))
    route = kernel_route(*tensors)
    if symbols.dtype != torch.complex64 or symbols.ndim != 2:
        raise ValueError(f"symbols must be complex64 [B, S], got {symbols.dtype} {tuple(symbols.shape)}")
    b, s = symbols.shape
    for name, t, dt in (("phase0", phase0, torch.float32), ("freq0", freq0, torch.float32),
                        ("active", active, torch.bool)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != (b,)):
            raise ValueError(f"{name} must be {dt} [{b}], got {t.dtype} {tuple(t.shape)}")
    count("rx.costas.rows", b)
    if route == "plain":
        if active is not None:
            _skip_counter(symbols.device).add_((~active).sum())
        return costas_track_plain(symbols, phase0, freq0, offset, active)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("costas_track needs contiguous tensors")
    out = torch.empty_like(symbols)
    ph_end = torch.empty_like(phase0)
    fr_end = torch.empty_like(freq0)
    if b == 0:
        return out, ph_end, fr_end
    mask, skipped = (None, None) if active is None else (
        active.data_ptr(), _skip_counter(symbols.device).data_ptr())
    _build.launch(
        "costas", "pm_costas_track", symbols.device,
        symbols.data_ptr(), out.data_ptr(), phase0.data_ptr(),
        freq0.data_ptr(), ph_end.data_ptr(), fr_end.data_ptr(), mask, skipped,
        b, s, int(offset), _build.stream_of(symbols),
    )
    return out, ph_end, fr_end
