"""Decision-directed Costas carrier recovery, batched over packets.

Port of ``gr4_packet_modem_tpu/ops/costas.py``. The loop's schedule is a
fixed function of symbol position (PILOT over the wiped-off syncword, QPSK
at header bandwidth, QPSK at payload bandwidth), so a batch of packets runs
as one recursion over the symbol index with the batch vectorised.
:func:`costas_run` is that recursion as a Python loop over symbols: it is
the plain version of the CUDA kernel in ``ops/costas_cuda.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import constants as C

__all__ = [
    "costas_coefficients", "costas_gains", "costas_segments", "costas_run",
    "PI", "TWO_PI",
]

# float32 pi and 2*pi as Python floats: comparisons and wraps then use the
# same values as the float32 reference whatever precision torch picks
PI = float(np.float32(np.pi))
TWO_PI = float(2 * np.float32(np.pi))

HDR_END = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192


@lru_cache(maxsize=32)
def costas_coefficients(loop_bandwidth: float, qpsk: bool) -> tuple[float, float]:
    """Closed-form K1/K2 from the loop bandwidth B_L*T
    (costas_loop.hpp:67-87). ``qpsk`` divides by the sqrt(2) discriminant
    gain."""
    bw = float(loop_bandwidth)
    bw2, bw3, bw4 = bw * bw, bw**3, bw**4
    s = np.cbrt(
        36.0 * bw2
        + np.sqrt(3.0) * np.sqrt(432.0 * bw4 + 848.0 * bw3 + 624.0 * bw2 + 204.0 * bw + 25.0)
        + 36.0 * bw
        + 9.0
    )
    z = (
        -(-12.0 * bw - 6.0) / (3.0 * np.cbrt(6.0) * (2.0 * bw + 1.0) * s)
        + (np.cbrt(2.0) * s) / (np.cbrt(9.0) * (2.0 * bw + 1.0))
        - 1.0
    )
    k1 = 1.0 - z * z
    k2 = (1.0 - z) * (1.0 - z)
    gain = np.sqrt(2.0) if qpsk else 1.0
    return float(k1 / gain), float(k2 / gain)


def costas_gains() -> tuple[float, ...]:
    """``(k1a, k2a, k1b, k2b, k1c, k2c)``: the gains of the syncword,
    header and payload segments of the receiver's schedule."""
    return (
        *costas_coefficients(C.SYNCWORD_COSTAS_BW, False),
        *costas_coefficients(C.HEADER_COSTAS_BW, True),
        *costas_coefficients(C.PAYLOAD_COSTAS_BW, True),
    )


def costas_segments(
    num_symbols: int, device: str | torch.device, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-symbol ``(constellation id, k1, k2)`` schedule ``[S]`` of a packet
    starting at its syncword: 64 PILOT @ bw 0.02, 128 QPSK @ bw 0.01,
    payload QPSK @ bw 0.005. ``offset`` shifts the symbol index (192 for the
    payload pass)."""
    s = torch.arange(num_symbols, device=device) + offset
    k1a, k2a, k1b, k2b, k1c, k2c = costas_gains()
    const = torch.where(
        s < C.SYNCWORD_LEN,
        int(C.Constellation.PILOT),
        int(C.Constellation.QPSK),
    ).to(torch.int32)

    def piecewise(a, b, c):
        out = torch.full((num_symbols,), float(np.float32(c)), device=device)
        out = torch.where(s < HDR_END, float(np.float32(b)), out)
        return torch.where(s < C.SYNCWORD_LEN, float(np.float32(a)), out)

    return const, piecewise(k1a, k1b, k1c), piecewise(k2a, k2b, k2c)


def costas_run(
    symbols: torch.Tensor,
    phase0: torch.Tensor,
    freq0: torch.Tensor,
    const_ids: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the Costas loop over a batch of packets.

    symbols: complex64 ``[B, S]``; phase0/freq0: float32 ``[B]`` initial
    loop state. const_ids/k1/k2: ``[S]`` per-symbol schedule shared by the
    batch. Returns ``(corrected [B, S] contiguous, phase_end [B],
    freq_end [B])``.
    """
    sym_re, sym_im = symbols.real, symbols.imag
    ids = const_ids.tolist()
    g1s = k1.to(torch.float32).tolist()
    g2s = k2.to(torch.float32).tolist()
    phase = phase0.to(torch.float32)
    freq = freq0.to(torch.float32)
    out_re = torch.empty(symbols.shape, dtype=torch.float32, device=symbols.device)
    out_im = torch.empty_like(out_re)
    for s in range(sym_re.shape[1]):
        xr, xi = sym_re[:, s], sym_im[:, s]
        c, sn = torch.cos(phase), torch.sin(phase)
        zr = xr * c + xi * sn
        zi = xi * c - xr * sn
        if ids[s] == int(C.Constellation.PILOT):
            e = zi
        elif ids[s] == int(C.Constellation.BPSK):
            e = zr * zi
        else:
            e = torch.where(zr > 0, zi, -zi) + torch.where(zi > 0, -zr, zr)
        freq = freq + g2s[s] * e
        phase = phase + g1s[s] * e + freq
        phase = torch.where(phase >= PI, phase - TWO_PI, phase)
        phase = torch.where(phase < -PI, phase + TWO_PI, phase)
        out_re[:, s] = zr
        out_im[:, s] = zi
    return torch.complex(out_re, out_im), phase, freq
