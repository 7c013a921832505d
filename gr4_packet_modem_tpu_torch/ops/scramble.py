"""Additive scrambler keystream (port of ``gr4_packet_modem_tpu/ops/
scramble.py::keystream``).

The scrambler restarts at every packet, so every packet sees the same fixed
bit sequence; it comes from the JAX package's numpy LFSR
(``utils/lfsr.py``) and is applied as a sign flip of soft values.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.lfsr import additive_scrambler_keystream

__all__ = ["keystream", "keystream_np"]


@lru_cache(maxsize=8)
def keystream_np(num_bits: int) -> np.ndarray:
    """First ``num_bits`` keystream bits (uint8, read-only)."""
    bits = additive_scrambler_keystream(int(num_bits)).astype(np.uint8)
    bits.flags.writeable = False
    return bits


def keystream(num_bits: int, device: str | torch.device) -> torch.Tensor:
    """First ``num_bits`` keystream bits as a uint8 tensor on ``device``."""
    return torch.tensor(keystream_np(num_bits), device=device)
