"""Protocol constants of the packet modem waveform.

The benchmark's frozen copy of the port's ``utils/constants.py``
(``h100_bench/tests/test_bench_frozen.py`` holds it equal), so that the
yardstick does not move when the program does.

These are data facts of the air interface (CCSDS-derived), matching the
reference implementation so that the two modems interoperate:

- 64-bit CCSDS syncword (packet_transmitter_pdu.hpp:158-174 /
  packet_receiver.hpp:45-59)
- QPSK / BPSK constellations (packet_transmitter_pdu.hpp:131-134, 179)
- CCSDS 131.0-B-5 17-bit additive scrambler parameters
  (packet_transmitter_pdu.hpp:118-122)
- header format: u16 BE payload length, u8 type, u8 spare 0x55
  (header_formatter.hpp:110-113)
- CRC-32 parameters (crc_append.hpp defaults)
- framing geometry: 4-byte header -> (128,32) LDPC + x2 repetition -> 32 coded
  bytes; 9 ramp-down symbols + 11 RRC flush symbols in burst mode
  (packet_transmitter_pdu.hpp:209-216, 249)
"""

from __future__ import annotations

import enum

import numpy as np

# 64-bit CCSDS syncword, one bit per entry, transmitted first-entry-first.
SYNCWORD = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1,
     0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1,
     0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0,
     1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0],
    dtype=np.uint8,
)
SYNCWORD_LEN = 64

# BPSK: bit 0 -> +1, bit 1 -> -1.
BPSK_CONSTELLATION = np.array([1.0 + 0.0j, -1.0 + 0.0j], dtype=np.complex64)

# QPSK (Gray-ish map of the reference): symbol index from 2 MSB-first bits,
# I encodes the first bit, Q the second; bit 0 -> +a, bit 1 -> -a.
_A = np.float32(np.sqrt(2.0) / 2.0)
QPSK_CONSTELLATION = np.array(
    [_A + 1j * _A, _A - 1j * _A, -_A + 1j * _A, -_A - 1j * _A], dtype=np.complex64
)

# CCSDS 131.0-B-5 additive scrambler (same convention as GR3 additive
# scrambler): Fibonacci LFSR defined by mask/seed/length.
SCRAMBLER_MASK = 0x4001
SCRAMBLER_SEED = 0x18E38
SCRAMBLER_LENGTH = 16

# CRC-32 (zlib) parameters used for the payload CRC.
CRC32_NUM_BITS = 32
CRC32_POLY = 0x4C11DB7
CRC32_INITIAL = 0xFFFFFFFF
CRC32_FINAL_XOR = 0xFFFFFFFF
CRC32_REFLECTED = True
CRC_NUM_BYTES = 4

# Header geometry.
HEADER_BYTES = 4           # formatted header length
HEADER_SPARE = 0x55        # spare byte value
HEADER_CODED_BYTES = 32    # after LDPC (128,32) + x2 repetition
HEADER_SYMBOLS = 128       # QPSK symbols of the coded header
HEADER_LDPC_N = 128
HEADER_LDPC_K = 32
HEADER_LLRS = 256          # LDPC n x 2 (repetition)
MAX_PACKET_LEN = 65535     # bytes; u16 length field

# Burst-mode framing.
RAMP_DOWN_SYMBOLS = 9      # GLFSR-filled ramp-down QPSK symbols
RAMP_DOWN_BITS = 2 * RAMP_DOWN_SYMBOLS
RRC_FLUSH_SYMBOLS = 11     # zero symbols flushing the RRC filter
BURST_RAMP_SYMBOLS = 4     # amplitude ramp length in symbols

# Costas loop bandwidth schedule (payload_metadata_insert.hpp:63-65).
SYNCWORD_COSTAS_BW = 0.02
HEADER_COSTAS_BW = 0.01
PAYLOAD_COSTAS_BW = 0.005

# RX design-point LLR noise sigma (packet_receiver.hpp:127-130: Es/N0 0 dB).
LLR_NOISE_SIGMA = 0.7

# Syncword detection defaults (syncword_detection.hpp:133-141).
SYNC_FFT_SIZE = 2048
SYNC_TIME_THRESHOLD = 768
SYNC_POWER_THRESHOLD = 9.5


class PacketType(enum.IntEnum):
    USER_DATA = 0
    IDLE = 1


class Constellation(enum.IntEnum):
    PILOT = 0
    BPSK = 1
    QPSK = 2


def format_header(packet_length: int, packet_type: int) -> np.ndarray:
    """Format a 4-byte packet header (header_formatter.hpp:110-113)."""
    if not 0 <= packet_length <= MAX_PACKET_LEN:
        raise ValueError(f"packet_length {packet_length} out of range")
    return np.array(
        [
            (packet_length >> 8) & 0xFF,
            packet_length & 0xFF,
            0x01 if packet_type == PacketType.IDLE else 0x00,
            HEADER_SPARE,
        ],
        dtype=np.uint8,
    )


def num_data_symbols(payload_len: int) -> int:
    """QPSK symbols for header+payload+CRC of a packet (no syncword)."""
    frame_bytes = HEADER_CODED_BYTES + payload_len + CRC_NUM_BYTES
    return 4 * frame_bytes


def burst_symbols(payload_len: int) -> int:
    """Total symbols of a burst-mode packet including sync/ramp/flush."""
    return (
        SYNCWORD_LEN
        + num_data_symbols(payload_len)
        + RAMP_DOWN_SYMBOLS
        + RRC_FLUSH_SYMBOLS
    )


def stream_symbols(payload_len: int) -> int:
    """Total symbols of a stream-mode packet (syncword + data)."""
    return SYNCWORD_LEN + num_data_symbols(payload_len)
