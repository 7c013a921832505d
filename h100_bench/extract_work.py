"""Bytes of the receiver's symbol extractions, counted by the algorithm and
not by how a program cuts them: the least time of a step's extractions,
for the extraction's roofline share.

An extraction takes ``S`` matched-filtered symbols of a row: the row's
span of ``sps * (S - 1) + K`` complex64 samples read once, its ``K``
float32 taps (its polyphase arm) read once, and its ``S`` complex64
symbols written once. A step extracts every detection slot twice: the
header's 192 symbols and the payload slot's ``4 * (max_payload_len + 4)``.
A program that fetches, derotates and filters in chunks, or in one pass,
is held to the same bytes.
"""

from __future__ import annotations

HEADER_SYMBOLS = 192  # syncword and header


def extraction_bytes(rows: int, symbols: int, sps: int, taps: int) -> int:
    """Bytes of extracting ``symbols`` symbols from each of ``rows`` rows
    with ``taps`` taps a row at ``sps`` samples a symbol."""
    return rows * ((sps * (symbols - 1) + taps) * 8 + taps * 4 + symbols * 8)


def step_extraction_bytes(rows: int, rx: dict, taps: int) -> int:
    """Bytes of a bank step's two extractions of ``rows`` slots under the
    configuration's receiver fields ``rx`` (``max_payload_len``,
    ``samples_per_symbol``; ``symbol_chunk`` does not enter)."""
    sps = int(rx.get("samples_per_symbol", 4))
    payload = 4 * (int(rx["max_payload_len"]) + 4)
    return sum(extraction_bytes(rows, s, sps, taps) for s in (HEADER_SYMBOLS, payload))
