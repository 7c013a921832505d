"""Batched CRC-32 over ragged byte packets (port of
``gr4_packet_modem_tpu/ops/crc.py::CrcEngine`` and ``make_crc32_engine``).

With a zero initial register the CRC update is linear, so leading zero
bytes do not change it, and for messages front-padded to ``max_len``:

    crc(msg) = init_lut[len] ^ XOR_{set bits j} g[j] ^ final_xor

where ``g[j]`` is the CRC word of message bit position ``j`` of the
right-aligned frame. The JAX package sums the set bits' words as an f32
GF(2) matmul; here the words are selected and XOR-reduced with integer ops,
which is exact by construction. PyTorch's uint32 has few operators, so CRC
words are carried in int64 and stay below 2**32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import constants as C

__all__ = ["crc32_tables", "crc32_compute", "crc_bytes_be"]


def _reflect32(word: int) -> int:
    return int(f"{word & 0xFFFFFFFF:032b}"[::-1], 2)


@lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    """Reflected CRC-32 byte table (crc.hpp:67-155, zlib convention)."""
    poly_r = _reflect32(C.CRC32_POLY)
    table = np.zeros(256, dtype=np.uint64)
    for byte in range(256):
        reg = byte
        for _ in range(8):
            lsb = reg & 1
            reg >>= 1
            if lsb:
                reg ^= poly_r
        table[byte] = reg
    return table


def _zero_byte_step(vec: int, table: np.ndarray) -> int:
    """Clock one zero byte through the register: s' = T[s & 0xff] ^ (s >> 8)."""
    return int(table[vec & 0xFF]) ^ (vec >> 8)


def crc32_tables(max_len: int) -> dict[str, np.ndarray]:
    """The constant tables of a CRC-32 engine for ``max_len``-byte rows,
    built as the JAX ``CrcEngine`` builds them: ``g_packed`` uint32
    ``[8*max_len]`` (one CRC word per MSB-first bit position of the
    right-aligned frame), ``init_lut`` uint32 ``[max_len+1]`` (the initial
    value clocked through L bytes) and ``final_xor`` uint32 ``[]``."""
    g_packed, init_lut = _tables(int(max_len))
    return {
        "g_packed": g_packed,
        "init_lut": init_lut,
        "final_xor": np.uint32(C.CRC32_FINAL_XOR),
    }


@lru_cache(maxsize=8)
def _tables(max_len: int) -> tuple[np.ndarray, np.ndarray]:
    table = _byte_table()
    g = np.zeros((max_len, 8), dtype=np.uint64)
    basis = np.array([int(table[0x80 >> k]) for k in range(8)], dtype=np.uint64)
    for p in range(max_len - 1, -1, -1):
        g[p] = basis
        basis = np.array(
            [_zero_byte_step(int(v), table) for v in basis], dtype=np.uint64
        )
    lut = np.zeros(max_len + 1, dtype=np.uint32)
    v = C.CRC32_INITIAL
    for n in range(max_len + 1):
        lut[n] = v
        v = _zero_byte_step(v, table)
    g_packed = g.reshape(max_len * 8).astype(np.uint32)
    g_packed.flags.writeable = False
    lut.flags.writeable = False
    return g_packed, lut


def _xor_reduce(w: torch.Tensor) -> torch.Tensor:
    """XOR of each row of ``w`` [B, M] by pairwise halving."""
    while w.shape[1] > 1:
        if w.shape[1] % 2:
            w = torch.cat([w, w.new_zeros(w.shape[0], 1)], dim=1)
        w = w[:, 0::2] ^ w[:, 1::2]
    return w[:, 0]


def crc32_compute(
    data: torch.Tensor,
    lengths: torch.Tensor,
    g_packed: torch.Tensor,
    init_lut: torch.Tensor,
    final_xor: torch.Tensor,
) -> torch.Tensor:
    """CRC-32 of each row. ``data``: uint8 ``[B, max_len]`` left-aligned;
    ``lengths``: int64 ``[B]`` in ``[0, max_len]``; tables as int64 tensors
    (see :func:`crc32_tables`). Returns int64 ``[B]``."""
    b, max_len = data.shape
    n = lengths.to(torch.int64)
    i = torch.arange(max_len, device=data.device)
    # byte i of a row of length n sits at position i + max_len - n of the
    # right-aligned frame; bytes past n do not count
    pos = (i[None, :] + (max_len - n)[:, None]).clamp(max=max_len - 1)
    valid = i[None, :] < n[:, None]
    words = g_packed.view(max_len, 8)[pos]  # [B, max_len, 8]
    shifts = torch.arange(7, -1, -1, device=data.device)
    bits = (data.to(torch.int64)[..., None] >> shifts) & 1
    sel = (bits == 1) & valid[..., None]
    crc_raw = _xor_reduce(torch.where(sel, words, 0).reshape(b, -1))
    return crc_raw ^ init_lut[n] ^ final_xor


def crc_bytes_be(crc: torch.Tensor) -> torch.Tensor:
    """CRC words ``[B]`` -> their four big-endian bytes, uint8 ``[B, 4]``
    (the order of CrcAppend with swap_endianness=false,
    crc_append.hpp:175-183)."""
    shifts = torch.tensor([24, 16, 8, 0], device=crc.device)
    return ((crc.to(torch.int64)[:, None] >> shifts) & 0xFF).to(torch.uint8)
