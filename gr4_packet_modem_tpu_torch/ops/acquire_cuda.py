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

__all__ = ["fused_best_power", "fused_best_power_plain", "replica_table", "KERNEL_FFT_SIZES"]

# the kernel's transform sizes: 16 points a thread, N / 16 threads a frame
# (at most 512), two exchange buffers and the spectrum (3N points) in shared
# memory
KERNEL_FFT_SIZES = (2048, 4096, 8192)
# the kernel keeps each sample's best bin in one byte
MAX_BINS = 256


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


# The kernel's transform (csrc/correlate.cu): a thread holds 16 complex
# points in registers; each pass runs radix-R butterflies on them (16 / R per
# thread), with one exchange through shared memory between passes.
_RADICES = {2048: (16, 16, 8), 4096: (16, 16, 16), 8192: (16, 16, 16, 2)}
POINTS = 16
# bases of each pass's twiddles: W_L^(e*m) for these e; the kernel builds the
# other powers as products of at most three of them
TWIDDLE_BASES = (1, 2, 4, 8)


def kernel_passes(n: int) -> list[tuple[int, int, int]]:
    """``(R, L, M)`` of each pass of the kernel's decimation-in-frequency
    transform: radix ``R`` on in-place sub-sequences of length ``L``, whose
    butterflies take the points ``M = L / R`` apart."""
    out, length = [], n
    for r in _RADICES[n]:
        out.append((r, length, length // r))
        length //= r
    return out


def kernel_positions(n: int, p: int) -> np.ndarray:
    """Position in the transform's in-place array of the point that thread
    ``t`` holds in register ``j`` during pass ``p``: int64 ``[16, N/16]``.
    Thread t runs butterflies ``beta = t + (N/16) u`` for ``u < 16/R``;
    register ``j = u R + r`` holds its point ``r``, at
    ``(beta // M) L + r M + beta % M``."""
    r_, length, m_ = kernel_passes(n)[p]
    t = np.arange(n // POINTS)
    rows = []
    for u in range(POINTS // r_):
        beta = t + (n // POINTS) * u
        for r in range(r_):
            rows.append((beta // m_) * length + r * m_ + beta % m_)
    return np.array(rows, dtype=np.int64)


@lru_cache(maxsize=8)
def kernel_plan(n: int) -> dict:
    """The kernel's host tables, in numpy: ``twiddles``, complex64, for each
    pass with ``M > 1`` the bases ``W_L^(e m)``, ``e`` in ``TWIDDLE_BASES``,
    ``m < M``, as ``[4, M]`` rows, computed in float64 and concatenated in
    pass order (``offsets`` gives each pass's start); and ``freq_of``,
    int64 ``[16, N/16]``: the frequency whose spectrum value thread ``t``
    holds in register ``j`` after the forward transform (the last pass's
    positions, mixed-radix digit-reversed)."""
    passes = kernel_passes(n)
    parts, offsets, off = [], [], 0
    for _, length, m_ in passes:
        offsets.append(off)
        if m_ > 1:
            e = np.array(TWIDDLE_BASES)[:, None] * np.arange(m_)[None, :]
            parts.append(np.exp(-2j * np.pi * e / length).ravel())
            off += len(TWIDDLE_BASES) * m_
    pos = kernel_positions(n, len(passes) - 1)
    freq = np.zeros_like(pos)
    rem, scale = pos.copy(), 1
    for r_, length, m_ in passes:
        freq += (rem // m_) * scale
        rem %= m_
        scale *= r_
    return {
        "twiddles": np.concatenate(parts).astype(np.complex64),
        "offsets": offsets,
        "freq_of": freq,
    }


@lru_cache(maxsize=8)
def _tables(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``kernel_plan(n)``'s twiddle bases (complex64) and register-order
    frequency map (int64 ``[16 * N/16]``, register-major) on ``device``."""
    plan = kernel_plan(n)
    return (
        torch.from_numpy(plan["twiddles"]).to(device),
        torch.from_numpy(plan["freq_of"].ravel()).to(device),
    )


def replica_table(rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int) -> torch.Tensor:
    """The replica spectra as the kernel reads them: float32 ``[nb, N, 2]``,
    interleaved, in the register order the kernel's forward transform
    leaves, ``rf[b, j, t] = R_b[freq_of[j, t]]``, times the inverse
    transform's 1/N (a power of two: exact). A caller that keeps its
    replicas builds this once and passes it to :func:`fused_best_power`."""
    _, freq_of = _tables(fft_size, rfr.device)
    return (torch.stack([rfr, rfi], dim=-1)[:, freq_of] * (1.0 / fft_size)).contiguous()


def fused_best_power(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int, block_frames: int = 16,
    *, table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-bin correlation power per sample over all frequency bins.

    ``ar``/``ai``/``br``/``bi``: float32 ``[FPAD, S]`` frame bodies and
    shifted views (``N - S <= S``); ``rfr``/``rfi``: float32 ``[nb, N]``
    conj replica spectra; ``table``: ``replica_table(rfr, rfi, fft_size)``
    where the caller keeps it, else the kernel route builds it. FPAD must
    be a multiple of ``block_frames`` only to mirror the TPU function's
    checks: the CUDA kernel runs one frame a block. Returns
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
    if not 0 < nb <= MAX_BINS:
        raise ValueError(f"the CUDA correlator takes 1 to {MAX_BINS} bins, got {nb}")
    tw, _ = _tables(fft_size, ar.device)
    rf = replica_table(rfr, rfi, fft_size) if table is None else table
    if (rf.shape != (nb, fft_size, 2) or rf.dtype != torch.float32 or not rf.is_contiguous()
            or rf.device != ar.device):
        raise ValueError(f"table must be contiguous float32 [{nb}, {fft_size}, 2] on {ar.device}, "
                         f"got {rf.dtype} {tuple(rf.shape)} on {rf.device}")
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
