"""Work counted from shapes, and the card's published peaks: the least
time a layer could take, for the roofline shares.

The counts follow the algorithm, not an implementation, so a redesigned
kernel is held to the same work. An FFT of N points is counted at the
split-radix count, 4 N log2 N - 6 N + 8 real operations; each input byte
is read once and each output byte written once.
"""

from __future__ import annotations

import math

PEAK_F32_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3


def least_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over bandwidth and operations over float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


def fft_ops(n: int) -> float:
    return 4 * n * math.log2(n) - 6 * n + 8


def correlation_ops(frames: int, n: int, bins: int) -> float:
    """Overlap-save correlation of ``frames`` frames against ``bins``
    replicas: one forward FFT a frame, a complex product (6), power (3) and
    best-bin max (1) a point and bin, and one inverse FFT a frame and bin."""
    return frames * ((1 + bins) * fft_ops(n) + bins * n * 10)


def acquire_work(channels: int, samples: int, n: int, sync_len: int, bins: int,
                 slots: int) -> tuple[float, float]:
    """(bytes, operations) of acquiring a bank ``[channels, samples]``
    complex64: the frames overlap-save needs (stride ``n - sync_len + 1``),
    the bank read once, and each slot's detection written once (index and
    seven float32 estimates and a flag)."""
    stride = n - sync_len + 1
    frames = channels * ((samples - n) // stride + 1)
    nbytes = channels * samples * 8 + channels * slots * (8 + 7 * 4 + 1)
    return nbytes, correlation_ops(frames, n, bins)


def costas_bytes(rows: int, symbols: int) -> float:
    """Bytes of the Costas loop over ``[rows, symbols]`` complex64: the
    symbols read and the corrected symbols written once, the loop state
    (phase, frequency) read and written once a row."""
    return 2 * rows * symbols * 8 + 4 * rows * 4
