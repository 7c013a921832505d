"""K1: the fused correlator on the card (``csrc/correlate.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/acquire_pallas.py::
fused_best_power`` with the same public layout: the overlap-save frames come
as two ``[FPAD, S]`` views per I/Q plane (the frame bodies ``a`` and the
one-stride-shifted view ``b`` whose first ``N - S`` samples are each frame's
lookahead), the replica spectra as ``[nb, N]`` planes in natural order, and
the result is ``(best_pow f32 [FPAD, N], best_bin int32 [FPAD, N])`` with
``best_pow = max_b |ifft(fft(frame) * R_b)|^2`` and ``best_bin`` its first
argmax. Only ``[:frames, :S]`` is the linear correlation; the rest is
circular wrap and zero-extended frames. One CUDA kernel serves both of the
TPU kernel's layouts (narrow and wide give the same planes).

:func:`fused_best_power` launches the kernel for CUDA tensors and runs
:func:`fused_best_power_plain` (the same reduction written with
``torch.fft``) for CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.device import kernel_route
from . import _build

__all__ = ["fused_best_power", "fused_best_power_plain", "KERNEL_FFT_SIZES"]

# the kernel's radix-2 transforms in shared memory: three N-point complex
# buffers must fit one block's 227 KB
KERNEL_FFT_SIZES = (2048, 4096, 8192)


def _check(ar, ai, br, bi, rfr, rfi, fft_size: int, block_frames: int) -> None:
    """The TPU function's checks (acquire_pallas.py:342-347) and the
    layout's."""
    planes = (ar, ai, br, bi)
    for t in (*planes, rfr, rfi):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"inputs must be float32 matrices, got {t.dtype} {tuple(t.shape)}")
    if any(t.shape != ar.shape for t in planes) or rfr.shape != rfi.shape:
        raise ValueError("the four frame views must be alike, and the two replica planes")
    fpad, s = ar.shape
    n = fft_size
    if rfr.shape[1] != n:
        raise ValueError(f"replica spectra are [nb, {rfr.shape[1]}], fft_size is {n}")
    if fpad % block_frames:
        raise ValueError(f"FPAD={fpad} must be a multiple of {block_frames}")
    if not 0 < n - s <= s:
        raise ValueError(f"stride {s} must satisfy N-S <= S (N={n})")


def fused_best_power_plain(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames assembled from the views, one forward FFT per frame, one
    inverse FFT per (frame, bin), power, max and first argmax over bins."""
    s = ar.shape[1]
    frames = torch.complex(
        torch.cat([ar, br[:, : fft_size - s]], dim=1),
        torch.cat([ai, bi[:, : fft_size - s]], dim=1),
    )
    spec = torch.fft.fft(frames, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :] * torch.complex(rfr, rfi)[None], dim=-1)
    power = corr.real**2 + corr.imag**2  # [FPAD, nb, N]
    best_pow, best_bin = power.max(dim=1)
    return best_pow, best_bin.to(torch.int32)


@lru_cache(maxsize=8)
def _tables(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(twiddles, bit_reversal)`` for the kernel: the twiddles of every
    radix-2 stage, exp(-2 pi i p / (2h)) at ``[h + p]`` for h = 1 .. N/2
    and p < h, computed in float64 as complex64 ``[N]``; and the N-point
    bit-reversal permutation (int64 ``[N]``)."""
    tw = np.zeros(n, np.complex128)
    h = 1
    while h < n:
        tw[h : 2 * h] = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        h *= 2
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for k in range(bits):
        rev |= ((idx >> k) & 1) << (bits - 1 - k)
    return (
        torch.from_numpy(tw.astype(np.complex64)).to(device),
        torch.from_numpy(rev).to(device),
    )


def fused_best_power(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int, block_frames: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-bin correlation power per sample over all frequency bins.

    ``ar``/``ai``/``br``/``bi``: float32 ``[FPAD, S]`` frame bodies and
    shifted views (FPAD a multiple of ``block_frames``, ``N - S <= S``);
    ``rfr``/``rfi``: float32 ``[nb, N]`` conj replica spectra. Returns
    ``(best_pow float32 [FPAD, N], best_bin int32 [FPAD, N])``."""
    route = kernel_route(ar, ai, br, bi, rfr, rfi)
    _check(ar, ai, br, bi, rfr, rfi, fft_size, block_frames)
    if route == "plain":
        return fused_best_power_plain(ar, ai, br, bi, rfr, rfi, fft_size)
    if fft_size not in KERNEL_FFT_SIZES:
        raise ValueError(f"the CUDA correlator takes fft_size in {KERNEL_FFT_SIZES}, got {fft_size}")
    for t in (ar, ai, br, bi):
        if not t.is_contiguous():
            raise ValueError("fused_best_power needs contiguous frame views")
    fpad, s = ar.shape
    nb = rfr.shape[0]
    tw, rev = _tables(fft_size, ar.device)
    # replica spectra interleaved and in the bit-reversed order of the
    # kernel's forward transform
    rf = torch.stack([rfr, rfi], dim=-1)[:, rev].contiguous()
    best_pow = ar.new_empty(fpad, fft_size)
    best_bin = torch.empty(fpad, fft_size, dtype=torch.int32, device=ar.device)
    if fpad == 0:
        return best_pow, best_bin
    _build.launch(
        "correlate", "pm_correlate", ar.device,
        ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
        rf.data_ptr(), tw.data_ptr(), best_pow.data_ptr(), best_bin.data_ptr(),
        fpad, s, nb, fft_size.bit_length() - 1, _build.stream_of(ar),
    )
    return best_pow, best_bin
