"""Bit packing (port of ``gr4_packet_modem_tpu/ops/packing.py::pack_bits``).

PyTorch's unsigned 32-bit type has few operators, so packed words are
returned as int64 holding the same values as the JAX package's uint32.
"""

from __future__ import annotations

import torch

__all__ = ["pack_bits"]


def pack_bits(
    data: torch.Tensor,
    inputs_per_output: int,
    bits_per_input: int = 1,
    msb_first: bool = True,
) -> torch.Tensor:
    """Concatenate ``inputs_per_output`` consecutive nibbles of
    ``bits_per_input`` bits into one item (pack_bits.hpp semantics)."""
    k = inputs_per_output
    mask = (1 << bits_per_input) - 1
    d = (data.to(torch.int64) & mask).reshape(
        *data.shape[:-1], data.shape[-1] // k, k
    )
    shifts = torch.arange(k, device=data.device, dtype=torch.int64) * bits_per_input
    if msb_first:
        shifts = shifts.flip(0)
    return (d << shifts).sum(dim=-1)
