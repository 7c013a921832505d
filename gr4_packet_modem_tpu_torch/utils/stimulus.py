"""Bench stimulus: burst-mode samples of one packet, in numpy.

The sequential per-packet transmitter that the receiver's checks are fed
with (``chip_smoke.py`` and the scripts that import its stimulus): the
parts of ``tests/reference_impl.py`` that build a burst, kept here so that
the port runs without the JAX package. It is a bench stimulus, one packet
at a time with explicit loops, not a transmitter API.
``tests/test_torch_standalone.py`` holds it bit for bit against
``tests/reference_impl.py``.
:func:`costas_symbols` is the Costas loop's input for the K4 checks.
"""

from __future__ import annotations

import zlib
from functools import lru_cache
from importlib import resources

import numpy as np

from . import constants as C
from .firdes import tx_rrc_taps
from .lfsr import additive_scrambler_keystream, glfsr_bits

__all__ = [
    "ldpc_encode_bytes", "frame_bytes", "data_symbols", "burst_symbols",
    "interp_fir", "burst_ramps", "burst_samples", "costas_symbols",
]


@lru_cache(maxsize=1)
def _generator() -> np.ndarray:
    with resources.files("gr4_packet_modem_tpu_torch.data").joinpath(
        "header_ldpc_generator.npy"
    ).open("rb") as f:
        return np.load(f)


def ldpc_encode_bytes(header4: np.ndarray) -> np.ndarray:
    """(128,32) LDPC + x2 repetition, per header_fec_encoder.hpp:93-115."""
    gen = _generator()
    info = (
        (int(header4[0]) << 24)
        | (int(header4[1]) << 16)
        | (int(header4[2]) << 8)
        | int(header4[3])
    )
    out = list(header4)
    for k in range(12):
        pb = 0
        for j in range(8):
            row = int(gen[8 * k + j])
            pb = (pb << 1) | (bin(info & row).count("1") & 1)
        out.append(pb)
    return np.array(out + out, dtype=np.uint8)


def frame_bytes(payload: np.ndarray, packet_type: int = 0) -> np.ndarray:
    """Coded header || payload || CRC-32 bytes for one packet."""
    header = C.format_header(len(payload), packet_type)
    coded = ldpc_encode_bytes(header)
    crc = zlib.crc32(np.asarray(payload, np.uint8).tobytes())
    crc_bytes = np.array(
        [(crc >> 24) & 0xFF, (crc >> 16) & 0xFF, (crc >> 8) & 0xFF, crc & 0xFF],
        dtype=np.uint8,
    )
    return np.concatenate([coded, np.asarray(payload, np.uint8), crc_bytes])


def data_symbols(payload: np.ndarray, packet_type: int = 0) -> np.ndarray:
    """Scrambled QPSK data symbols of one packet."""
    bits = np.unpackbits(frame_bytes(payload, packet_type))
    bits = bits ^ additive_scrambler_keystream(bits.size)
    idx = bits.reshape(-1, 2) @ np.array([2, 1])
    return np.asarray(C.QPSK_CONSTELLATION)[idx]


def burst_symbols(payload: np.ndarray, packet_index: int, packet_type: int = 0):
    """Full burst-mode symbol vector: sync || data || ramp-down || flush."""
    sync = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
    data = data_symbols(payload, packet_type)
    nbits = C.RAMP_DOWN_BITS
    all_ramp = glfsr_bits(nbits * (packet_index + 1))
    ramp_bits = all_ramp[nbits * packet_index : nbits * (packet_index + 1)]
    ridx = ramp_bits.reshape(-1, 2) @ np.array([2, 1])
    ramp = np.asarray(C.QPSK_CONSTELLATION)[ridx]
    flush = np.zeros(C.RRC_FLUSH_SYMBOLS, np.complex64)
    return np.concatenate([sync, data, ramp, flush])


def interp_fir(symbols: np.ndarray, taps: np.ndarray, interp: int) -> np.ndarray:
    """Per-item interpolating FIR with zero initial history
    (interpolating_fir_filter.hpp:90-99)."""
    arm_len = -(-taps.size // interp)
    tp = np.zeros((interp, arm_len), dtype=np.float32)
    for j in range(interp):
        arm = taps[j::interp]
        tp[j, : arm.size] = arm
    hist = np.zeros(arm_len, dtype=np.complex64)
    out = np.zeros(symbols.size * interp, dtype=np.complex64)
    for s, x in enumerate(symbols):
        hist = np.roll(hist, 1)
        hist[0] = x
        for j in range(interp):
            out[s * interp + j] = np.dot(tp[j], hist)
    return out


def burst_ramps(sps: int = 4):
    """The burst's leading and trailing amplitude ramps."""
    ramp_samples = C.BURST_RAMP_SYMBOLS * sps
    offset = 4 * sps
    lead = np.sin(
        np.arange(1, offset + ramp_samples + 1)
        / (offset + ramp_samples)
        * 0.5
        * np.pi
    ).astype(np.float32)
    tr_len = C.RRC_FLUSH_SYMBOLS * sps - offset + ramp_samples
    trail = np.sin(np.arange(1, tr_len + 1) / tr_len * 0.5 * np.pi).astype(
        np.float32
    )[::-1].copy()
    return lead, trail


def burst_samples(payload: np.ndarray, packet_index: int, sps: int = 4,
                  packet_type: int = 0) -> np.ndarray:
    """Complete burst-mode TX of one packet: shaped RRC samples."""
    syms = burst_symbols(payload, packet_index, packet_type)
    samples = interp_fir(syms, tx_rrc_taps(sps), sps)
    lead, trail = burst_ramps(sps)
    samples[: lead.size] *= lead
    samples[-trail.size :] *= trail
    return samples


def costas_symbols(b: int, s: int, offset: int, seed: int):
    """Input of the Costas loop in the regime the receiver runs it in: ``b``
    packets of ``s`` QPSK symbols from packet symbol ``offset`` on (the
    syncword's, below symbol 64, wiped off to pure pilot), a small phase
    offset and residual CFO per packet, noise at 0.05 a component. Returns
    ``(symbols complex64 [b, s], phase0 float32 [b], freq0 float32 [b])``."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (b, s))
    clean = np.exp(1j * (np.pi / 4 + bits * np.pi / 2))
    clean[:, : max(0, C.SYNCWORD_LEN - offset)] = 1.0
    cfo = 2e-4 * rng.standard_normal((b, 1))
    sym = clean * np.exp(1j * (0.05 * rng.standard_normal((b, 1)) + cfo * np.arange(s)))
    sym = sym + 0.05 * (rng.standard_normal((b, s)) + 1j * rng.standard_normal((b, s)))
    phase0 = rng.uniform(-0.1, 0.1, b).astype(np.float32)
    return sym.astype(np.complex64), phase0, np.zeros(b, np.float32)
