"""Additive scrambler (port of ``gr4_packet_modem_tpu/ops/scramble.py``:
``keystream``, ``scramble_bits`` and ``descramble_soft``).

The scrambler restarts at every packet, so every packet sees the same fixed
bit sequence; it comes from this package's numpy LFSR (``utils/lfsr.py``)
and is applied as an XOR of hard bits (transmit) or a sign flip of soft
values (receive).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.lfsr import additive_scrambler_keystream

__all__ = ["keystream", "keystream_np", "scramble_bits", "descramble_soft"]


@lru_cache(maxsize=8)
def keystream_np(num_bits: int) -> np.ndarray:
    """First ``num_bits`` keystream bits (uint8, read-only)."""
    bits = additive_scrambler_keystream(int(num_bits)).astype(np.uint8)
    bits.flags.writeable = False
    return bits


def keystream(num_bits: int, device: str | torch.device) -> torch.Tensor:
    """First ``num_bits`` keystream bits as a uint8 tensor on ``device``."""
    return torch.tensor(keystream_np(num_bits), device=device)


def scramble_bits(bits: torch.Tensor, ks: torch.Tensor | None = None) -> torch.Tensor:
    """XOR hard bits ``[..., N]`` with the keystream restarted at bit 0.
    ``ks`` holds at least N keystream bits on the bits' device (made from
    :func:`keystream_np` when None)."""
    n = bits.shape[-1]
    if ks is None:
        ks = keystream(n, bits.device)
    return bits ^ ks[:n].to(bits.dtype)


def descramble_soft(llrs: torch.Tensor, ks: torch.Tensor | None = None) -> torch.Tensor:
    """Sign-flip soft values ``[..., N]`` where the keystream bit is 1
    (additive_scrambler.hpp:89-93 soft-symbol branch). ``ks`` as in
    :func:`scramble_bits`."""
    n = llrs.shape[-1]
    if ks is None:
        ks = keystream(n, llrs.device)
    return torch.where(ks[:n].to(torch.bool), -llrs, llrs)
