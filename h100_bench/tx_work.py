"""Bytes of the transceiver's TX bank, counted by what a step must move and
not by how a program computes it: the least time of a step's TX, for the
TX's roofline share (``tx_roofline_pct.loop``).

A step's TX reads each payload byte handed to it once (the packets' own
lengths, not their slots) and writes the bank once: ``channels x block``
complex64 samples, the bursts and the zeros around them. The framing's
tables, the symbols and the shaped bursts in between are a program's own
business, so a program that frames, filters and lays out in one pass, or
in many, is held to the same bytes.
"""

from __future__ import annotations

SAMPLE_BYTES = 8  # complex64


def tx_bytes(payload_bytes: int, channels: int, block: int) -> int:
    """Bytes of a TX step that turns ``payload_bytes`` bytes of payload
    into a bank of ``channels`` rows of ``block`` samples."""
    return int(payload_bytes) + int(channels) * int(block) * SAMPLE_BYTES
