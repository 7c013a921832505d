"""FIR filter design utilities.

The benchmark's frozen copy of the port's ``utils/firdes.py``; the golden
taps are read from ``h100_bench/reference/data/`` (a copy of the port's
``data/``; ``h100_bench/tests/test_bench_frozen.py`` holds both equal).

The modem's pulse-shaping / matched-filter taps are a *protocol constant*:
TX and RX (and interop with the reference waveform) require the exact
root-raised-cosine taps of the reference designer
(blocks/include/gnuradio-4.0/packet-modem/firdes.hpp:30-78, itself GR3's
``gr::filter::firdes::root_raised_cosine``) post-processed per
packet_transmitter_rrc_taps.hpp:8-28 (TX) and packet_receiver.hpp:60-110
(RX polyphase bank). The production tap vectors therefore ship as golden
data (``data/rrc_taps_golden.npz``, like the LDPC alist) and are loaded
bit-exactly; :func:`root_raised_cosine` below is an independently written
closed-form designer (the textbook RRC impulse response, not the
reference's algebraic rearrangement) used for non-default geometries and
cross-checked against the golden vectors in tests/test_ops.py.

All functions here run on the host and return numpy arrays.
"""

from __future__ import annotations

from functools import lru_cache
from importlib import resources

import numpy as np

__all__ = [
    "root_raised_cosine",
    "tx_rrc_taps",
    "rx_rrc_taps",
    "rx_pfb_taps",
    "polyphase",
]


@lru_cache(maxsize=1)
def _golden():
    with resources.files("h100_bench.reference").joinpath("data").joinpath(
        "rrc_taps_golden.npz"
    ).open("rb") as f:
        d = np.load(f)
        return {k: d[k] for k in d.files}


def root_raised_cosine(
    gain: float,
    sampling_freq: float,
    symbol_rate: float,
    alpha: float,
    ntaps: int,
    dtype=np.float32,
) -> np.ndarray:
    """Root-raised-cosine taps via the textbook impulse response

        h(t) = [sin(pi t (1-a)) + 4 a t cos(pi t (1+a))]
               / [pi t (1 - (4 a t)^2)]

    with t in symbol units, evaluated in float64 with the two removable
    singularities (t = 0 and |4 a t| = 1) replaced by their limits, then
    normalized so the tap sum equals ``gain``. ``ntaps`` is forced odd
    (``ntaps |= 1``). Numerically equivalent (to f32 precision) to the
    reference designer — the default-geometry vectors used by the modem are
    pinned bit-exactly as golden data instead of recomputed.
    """
    ntaps = int(ntaps) | 1
    a = float(alpha)
    spb = sampling_freq / symbol_rate  # samples per symbol
    t = (np.arange(ntaps, dtype=np.float64) - ntaps // 2) / spb
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.sin(np.pi * t * (1.0 - a)) + 4.0 * a * t * np.cos(
            np.pi * t * (1.0 + a)
        )
        den = np.pi * t * (1.0 - (4.0 * a * t) ** 2)
        h = num / den
    # t = 0 limit
    h = np.where(t == 0.0, 1.0 + a * (4.0 / np.pi - 1.0), h)
    # |4 a t| = 1 limit (L'Hopital at the spectrum corner)
    if a > 0.0:
        corner = np.isclose(np.abs(4.0 * a * t), 1.0, rtol=0, atol=1e-9)
        tc = 1.0 / (4.0 * a)
        hc = (a / np.sqrt(2.0)) * (
            (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * a))
            + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * a))
        )
        # in symbol units h is symmetric; the corner value is the same at +-tc
        h = np.where(corner, hc / (tc * 0 + 1.0), h)
    h = h / h.sum() * gain
    return h.astype(dtype)


def tx_rrc_taps(samples_per_symbol: int = 4) -> np.ndarray:
    """TX pulse-shaping RRC taps with DAC-range power scaling: RRC with
    11-symbol span, alpha 0.35, scaled so the worst-case polyphase |sum|
    reaches 0.9 of DAC full scale (packet_transmitter_rrc_taps.hpp:8-28).
    The default sps=4 vector is the golden protocol constant."""
    sps = int(samples_per_symbol)
    if sps == 4:
        return _golden()["tx_rrc_sps4"].copy()
    taps = root_raised_cosine(1.0, float(sps), 1.0, 0.35, sps * 11)
    arms = taps.astype(np.float32)
    sum_abs_max = max(
        np.abs(arms[j::sps]).sum(dtype=np.float32) for j in range(sps)
    )
    return (arms * (np.float32(0.9) / sum_abs_max)).astype(np.float32)


def rx_rrc_taps(samples_per_symbol: int = 4) -> tuple[np.ndarray, float]:
    """RX reference RRC taps normalized to unit L2 norm, plus the
    pre-normalization norm (packet_receiver.hpp:60-74; the norm scales the
    PFB bank gain). The default sps=4 vector is the golden constant."""
    sps = int(samples_per_symbol)
    if sps == 4:
        g = _golden()
        return g["rx_rrc_sps4"].copy(), float(g["rx_rrc_sps4_norm"])
    taps = root_raised_cosine(1.0, float(sps), 1.0, 0.35, sps * 11)
    norm = np.float32(np.sqrt(np.sum(taps.astype(np.float32) ** 2)))
    return (taps / norm).astype(np.float32), float(norm)


def rx_pfb_taps(samples_per_symbol: int = 4, num_arms: int = 32) -> np.ndarray:
    """Polyphase matched-filter bank taps for the symbol filter
    (packet_receiver.hpp:96-110): an RRC designed at ``num_arms * sps`` rate
    with gain ``num_arms / ||rrc||``, the odd trailing tap dropped so the
    bank has exactly ``num_arms`` arms of ``sps * 11`` taps each. Arm ``j``
    is ``taps[j::num_arms]``. The default (4, 32) vector is the golden
    constant."""
    sps = int(samples_per_symbol)
    if sps == 4 and num_arms == 32:
        return _golden()["rx_pfb_sps4_arms32"].copy()
    _, norm = rx_rrc_taps(sps)
    taps = root_raised_cosine(
        float(num_arms) / norm,
        float(num_arms * sps),
        1.0,
        0.35,
        num_arms * sps * 11,
    ).astype(np.float32)
    return taps[:-1]  # drop the extra odd tap


def polyphase(taps: np.ndarray, num_branches: int) -> np.ndarray:
    """Organize ``taps`` into a zero-padded polyphase matrix.

    Returns an array of shape ``[num_branches, ceil(len(taps)/num_branches)]``
    where row ``j`` holds ``taps[j::num_branches]`` (newest-first inner-product
    convention is up to the caller). Missing entries are zero.
    """
    taps = np.asarray(taps)
    arm_len = -(-taps.size // num_branches)
    out = np.zeros((num_branches, arm_len), dtype=taps.dtype)
    for j in range(num_branches):
        arm = taps[j::num_branches]
        out[j, : arm.size] = arm
    return out
