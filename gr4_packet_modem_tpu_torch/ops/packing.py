"""Bit packing and constellation mapping (port of
``gr4_packet_modem_tpu/ops/packing.py``: ``unpack_bits``, ``pack_bits``,
``bytes_to_bits``, ``bits_to_bytes``, ``map_symbols`` and
``binary_slice``).

PyTorch's unsigned 32-bit type has few operators, so packed words are
returned as int64 holding the same values as the JAX package's uint32.
"""

from __future__ import annotations

import torch

__all__ = [
    "unpack_bits", "pack_bits", "bytes_to_bits", "bits_to_bytes", "map_symbols", "binary_slice",
]


def _shifts(k: int, bits: int, msb_first: bool, device) -> torch.Tensor:
    shifts = torch.arange(k, device=device, dtype=torch.int64) * bits
    return shifts.flip(0) if msb_first else shifts


def unpack_bits(
    data: torch.Tensor,
    outputs_per_input: int,
    bits_per_output: int = 1,
    msb_first: bool = True,
) -> torch.Tensor:
    """Split each item into ``outputs_per_input`` nibbles of
    ``bits_per_output`` bits, folded into the last axis (unpack_bits.hpp
    semantics). Returns uint8."""
    k = outputs_per_input
    mask = (1 << bits_per_output) - 1
    shifts = _shifts(k, bits_per_output, msb_first, data.device)
    out = (data.to(torch.int64)[..., None] >> shifts) & mask
    return out.reshape(*data.shape[:-1], data.shape[-1] * k).to(torch.uint8)


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
    return (d << _shifts(k, bits_per_input, msb_first, data.device)).sum(dim=-1)


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> MSB-first bits (one bit per uint8 item)."""
    return unpack_bits(data, 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first bits -> packed uint8 bytes."""
    return pack_bits(bits, 8).to(torch.uint8)


def map_symbols(indices: torch.Tensor, constellation: torch.Tensor) -> torch.Tensor:
    """Constellation lookup (mapper.hpp): index -> complex point."""
    return constellation[indices.to(torch.int64)]


def binary_slice(llrs: torch.Tensor, invert: bool = True) -> torch.Tensor:
    """Hard-decide soft values (binary_slicer.hpp). ``invert=True`` maps a
    positive LLR to bit 0 (the modem's LLR convention). Returns uint8."""
    return (llrs < 0 if invert else llrs > 0).to(torch.uint8)
