"""Batched CRC-32 over ragged byte packets (port of
``gr4_packet_modem_tpu/ops/crc.py``: ``CrcEngine``, ``BatchedCrcAppend``,
``BatchedCrcCheck``, and the host oracle ``CrcRef`` / ``crc32_ref``).

With a zero initial register the CRC update is linear, so leading zero
bytes do not change it, and for messages front-padded to ``max_len``:

    crc(msg) = init_lut[len] ^ XOR_{set bits j} g[j] ^ final_xor

where ``g[j]`` is the CRC word of message bit position ``j`` of the
right-aligned frame. The JAX package sums the set bits' words as an f32
GF(2) matmul; here the words are selected and XOR-reduced with integer ops,
which is exact by construction. PyTorch's uint32 has few operators, so CRC
words are carried in int64 and stay below 2**32.

``BatchedCrcAppend`` and ``BatchedCrcCheck`` are the CrcAppend and CrcCheck
blocks with their options (crc_append.hpp:66-73, crc_check.hpp): the CRC
covers ``data[skip:]``, is written big-endian or byte-reversed, and packets
not longer than the skipped header pass through.

:func:`payload_crc` is the receiver's payload check from the corrected
symbols to the bytes and both CRC words: on CUDA tensors one kernel
(``csrc/crc.cu``, which reads each row's symbols only up to its own
length), on CPU tensors :func:`payload_crc_plain`, the chain of PyTorch
operations it replaces.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import constants as C
from ..utils.device import kernel_route
from ..utils.trace import count
from . import _build
from .packing import binary_slice, pack_bits, unpack_bits
from .scramble import descramble_soft

__all__ = [
    "CrcRef", "crc32_ref", "crc32_tables", "crc32_compute", "crc_bytes_be",
    "CrcEngine", "make_crc32_engine", "BatchedCrcAppend", "BatchedCrcCheck",
    "THREADS", "SPAN", "TILE", "SHIFT_LEVELS", "zero_shift_matrices",
    "payload_crc_tables", "payload_crc", "payload_crc_plain",
]


class CrcRef:
    """Generic table-driven CRC (host/numpy), parameter-compatible with the
    reference Crc class (crc.hpp:67-155). Used as the test oracle and for
    host-side processing. (A copy of the JAX package's ``CrcRef``.)"""

    def __init__(
        self,
        num_bits: int = 32,
        poly: int = C.CRC32_POLY,
        initial_value: int = C.CRC32_INITIAL,
        final_xor: int = C.CRC32_FINAL_XOR,
        input_reflected: bool = True,
        result_reflected: bool = True,
    ):
        if num_bits < 8 or num_bits > 64:
            raise ValueError("CRC size must be between 8 and 64 bits")
        self.num_bits = num_bits
        self.mask = (1 << num_bits) - 1
        self.initial_value = initial_value & self.mask
        self.final_xor = final_xor & self.mask
        self.input_reflected = input_reflected
        self.result_reflected = result_reflected
        self.table = self._build_table(poly)

    def _reflect(self, word: int) -> int:
        ret = word & 1
        for _ in range(1, self.num_bits):
            word >>= 1
            ret = (ret << 1) | (word & 1)
        return ret

    def _build_table(self, poly: int) -> np.ndarray:
        """Each entry independently: clock one byte's 8 bits through the
        shift register (textbook byte-at-a-time table)."""
        table = np.zeros(256, dtype=np.uint64)
        if self.input_reflected:
            # reflected convention: LSB-first register, reflected polynomial
            poly_r = self._reflect(poly)
            for byte in range(256):
                reg = byte
                for _ in range(8):
                    lsb = reg & 1
                    reg >>= 1
                    if lsb:
                        reg ^= poly_r
                table[byte] = reg & self.mask
        else:
            # forward convention: byte enters at the register's top
            top = 1 << (self.num_bits - 1)
            for byte in range(256):
                reg = byte << (self.num_bits - 8)
                for _ in range(8):
                    carry = reg & top
                    reg = (reg << 1) & self.mask
                    if carry:
                        reg ^= poly & self.mask
                table[byte] = reg
        return table

    def compute(self, data) -> int:
        rem = self.initial_value
        table = self.table
        if self.input_reflected:
            for byte in np.asarray(data, dtype=np.uint8):
                idx = (rem ^ int(byte)) & 0xFF
                rem = int(table[idx]) ^ (rem >> 8)
        else:
            for byte in np.asarray(data, dtype=np.uint8):
                idx = ((rem >> (self.num_bits - 8)) ^ int(byte)) & 0xFF
                rem = (int(table[idx]) ^ (rem << 8)) & self.mask
        if self.input_reflected != self.result_reflected:
            rem = self._reflect(rem)
        return rem ^ self.final_xor


def crc32_ref(data) -> int:
    """Reference CRC-32 of a byte sequence (host)."""
    return CrcRef().compute(data)


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
    table = CrcRef().table  # reflected CRC-32, the zlib convention
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
    shifts = torch.arange(24, -1, -8, device=crc.device)  # made on the device: no host copy, no wait
    return ((crc.to(torch.int64)[:, None] >> shifts) & 0xFF).to(torch.uint8)


@lru_cache(maxsize=None)  # kept: captured CUDA graphs read these tensors by address
def _device_tables(max_len: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """:func:`crc32_tables` for ``max_len`` as int64 tensors on ``device``."""
    t = crc32_tables(max_len)
    return tuple(
        torch.from_numpy(np.asarray(t[k], np.int64).copy()).to(device)
        for k in ("g_packed", "init_lut", "final_xor")
    )


class CrcEngine:
    """Batched reflected CRC-32 over ragged byte rows ``[B, max_len]``
    (the JAX ``CrcEngine``): rows are left-aligned, ``lengths`` gives each
    row's valid byte count, ``max_len`` is a static bound. The sum over set
    bits is the exact integer XOR of :func:`crc32_compute`, not a float
    matmul."""

    def __init__(self, max_len: int):
        self.max_len = int(max_len)
        _tables(self.max_len)  # built once, here

    def compute(self, data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """CRC-32 of each row. ``data`` uint8 ``[B, max_len]``,
        ``lengths`` ``[B]`` in ``[0, max_len]``, on one device. Returns
        int64 ``[B]`` (values below 2**32)."""
        if data.ndim != 2 or data.shape[1] != self.max_len:
            raise ValueError(f"expected [B, {self.max_len}] rows, got {tuple(data.shape)}")
        return crc32_compute(
            data, lengths.to(torch.int64), *_device_tables(self.max_len, data.device)
        )


@lru_cache(maxsize=8)
def make_crc32_engine(max_len: int) -> CrcEngine:
    return CrcEngine(max_len)


def _body_crc(data: torch.Tensor, skip: int, body_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """CRC-32 of ``data[:, skip : skip + body_len]`` per row: the body is
    masked past its length and zero-padded to ``max_len`` columns."""
    body = data[:, skip:]
    if body.shape[1] > max_len:
        raise ValueError(f"rows of {data.shape[1]} bytes exceed max_len {max_len} (+ skip {skip})")
    pos = torch.arange(body.shape[1], device=data.device)
    body = torch.where(pos[None, :] < body_len[:, None], body, 0).to(torch.uint8)
    body = torch.nn.functional.pad(body, (0, max_len - body.shape[1]))
    return crc32_compute(body, body_len.clamp(max=max_len), *_device_tables(max_len, data.device))


class BatchedCrcAppend:
    """Batched CrcAppend (crc_append.hpp:66-73): the CRC of ``data[skip:]``
    of each packet is appended big-endian, or byte-reversed when
    ``swap_endianness``. Packets not longer than ``skip_header_bytes`` pass
    through unchanged (crc_append.hpp:254-258)."""

    def __init__(self, max_len: int, swap_endianness: bool = False, skip_header_bytes: int = 0):
        self.max_len = int(max_len)
        self.swap_endianness = bool(swap_endianness)
        self.skip = int(skip_header_bytes)

    def append(self, data: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``data`` uint8 ``[B, L]`` left-aligned (``L <= max_len``),
        ``lengths`` ``[B]``. Returns ``(out uint8 [B, L+4], out_lengths
        int64 [B])``."""
        lengths = lengths.to(torch.int64)
        crc = _body_crc(data, self.skip, (lengths - self.skip).clamp(min=0), self.max_len)
        cb = crc_bytes_be(crc)  # [B, 4]
        if self.swap_endianness:
            cb = cb.flip(1)
        too_short = lengths <= self.skip
        out = torch.nn.functional.pad(data.to(torch.uint8), (0, C.CRC_NUM_BYTES))
        jpos = torch.arange(out.shape[1], device=data.device)[None, :]
        for i in range(C.CRC_NUM_BYTES):
            sel = (jpos == (lengths + i)[:, None]) & ~too_short[:, None]
            out = torch.where(sel, cb[:, i : i + 1], out)
        return out, torch.where(too_short, lengths, lengths + C.CRC_NUM_BYTES)


class BatchedCrcCheck:
    """Batched CrcCheck (crc_check.hpp): verifies the trailing CRC over
    ``data[skip:]``, optionally stripping it. Returns the ok mask
    (``lengths > skip + 4`` and the CRCs equal); callers drop failed
    packets."""

    def __init__(
        self,
        max_len: int,
        swap_endianness: bool = False,
        skip_header_bytes: int = 0,
        discard_crc: bool = True,
    ):
        self.max_len = int(max_len)  # max length INCLUDING the CRC
        self.swap_endianness = bool(swap_endianness)
        self.skip = int(skip_header_bytes)
        self.discard_crc = bool(discard_crc)

    def check(
        self, data: torch.Tensor, lengths: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``data`` uint8 ``[B, L]``, ``lengths`` ``[B]``. Returns ``(ok
        bool [B], out_data, out_lengths int64)``, the CRC stripped (and the
        bytes past it zeroed) when ``discard_crc``."""
        lengths = lengths.to(torch.int64)
        body_end = (lengths - C.CRC_NUM_BYTES).clamp(min=0)
        crc = _body_crc(data, self.skip, (body_end - self.skip).clamp(min=0), self.max_len)
        # received CRC bytes at body_end..body_end+3 (0 past the row's end)
        width = data.shape[1]
        at = body_end[:, None] + torch.arange(C.CRC_NUM_BYTES, device=data.device)
        rx = data.to(torch.int64).gather(1, at.clamp(max=width - 1))
        rx = torch.where(at < width, rx, 0)
        if self.swap_endianness:
            rx = rx.flip(1)
        crc_rx = rx[:, 0] << 24 | rx[:, 1] << 16 | rx[:, 2] << 8 | rx[:, 3]
        ok = (crc == crc_rx) & (lengths > self.skip + C.CRC_NUM_BYTES)
        if not self.discard_crc:
            return ok, data, lengths
        pos = torch.arange(width, device=data.device)[None, :]
        return ok, torch.where(pos < body_end[:, None], data, 0).to(torch.uint8), body_end


# ------------------------------------------------ the payload pass's check

THREADS = 256  # threads a block, one block a row (csrc/crc.cu: kThreads)
SPAN = 16  # tile bytes a thread folds (kSpan)
TILE = THREADS * SPAN  # bytes a tile of the right-aligned frame (kTile)
SHIFT_LEVELS = 13  # shift matrices Z^(2^m), m < 13, up to a tile (kShiftLevels)


def _apply_matrix(mat: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A 32 x 32 GF(2) matrix (its 32 column words) applied to each word of
    ``v``: the XOR of the columns of ``v``'s set bits."""
    bits = (v[:, None] >> np.arange(32, dtype=np.uint64)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, mat[None, :], 0), axis=1)


def zero_shift_matrices() -> np.ndarray:
    """uint32 ``[SHIFT_LEVELS, 32]``: row ``m`` holds the columns of
    Z^(2^m), the CRC register clocked through 2^m zero bytes (column i is
    the image of the register ``1 << i``), each the square of the one
    before."""
    table = CrcRef().table
    one = np.array([_zero_byte_step(1 << i, table) for i in range(32)], np.uint64)
    mats = [one]
    for _ in range(SHIFT_LEVELS - 1):
        mats.append(_apply_matrix(mats[-1], mats[-1]))
    return np.stack(mats).astype(np.uint32)


def payload_crc_tables() -> np.ndarray:
    """The kernel's own tables as one uint32 array: the byte table (256)
    and :func:`zero_shift_matrices` (``SHIFT_LEVELS`` x 32). The initial
    register over n bytes and the final XOR come from the CRC engine's
    tables (:func:`crc32_tables`), as :func:`crc32_compute` takes them."""
    return np.concatenate([CrcRef().table.astype(np.uint32), zero_shift_matrices().reshape(-1)])


@lru_cache(maxsize=None)  # kept: captured CUDA graphs read these tensors by address
def _payload_device_tables(device: torch.device) -> torch.Tensor:
    """:func:`payload_crc_tables` on ``device`` (int32, the same bits)."""
    return torch.from_numpy(payload_crc_tables().view(np.int32)).to(device)


def payload_crc_plain(
    corrected: torch.Tensor, llr_scale: torch.Tensor, ks: torch.Tensor, plen: torch.Tensor,
    g_packed: torch.Tensor, init_lut: torch.Tensor, final_xor: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The check as PyTorch operations: LLRs scaled, descrambled, sliced
    (a positive LLR is bit 0) and packed MSB first; the payload masked at
    ``plen``; :func:`crc32_compute` over its first ``clamp(plen, 0,
    max_len)`` bytes; the received CRC the 4 big-endian bytes after them."""
    max_len = init_lut.shape[0] - 1
    llrs = torch.view_as_real(corrected).reshape(corrected.shape[0], -1) * llr_scale
    bits = binary_slice(descramble_soft(llrs, unpack_bits(ks, 8)))
    all_bytes = pack_bits(bits, 8).to(torch.uint8)  # [D, max_len + 4]
    pos = torch.arange(max_len, device=corrected.device)
    payload = torch.where(pos[None, :] < plen[:, None], all_bytes[:, :max_len], 0)
    crc = crc32_compute(payload, torch.clamp(plen, 0, max_len), g_packed, init_lut, final_xor)
    plen_c = torch.clamp(plen, 0, all_bytes.shape[1] - C.CRC_NUM_BYTES)
    at = plen_c[:, None] + torch.arange(C.CRC_NUM_BYTES, device=corrected.device)
    rx_bytes = all_bytes.gather(1, at).to(torch.int64)
    crc_rx = rx_bytes[:, 0] << 24 | rx_bytes[:, 1] << 16 | rx_bytes[:, 2] << 8 | rx_bytes[:, 3]
    return payload, crc, crc_rx


def payload_crc(
    corrected: torch.Tensor, llr_scale: torch.Tensor, ks: torch.Tensor, plen: torch.Tensor,
    g_packed: torch.Tensor, init_lut: torch.Tensor, final_xor: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Payload bytes and CRC words of every row. ``corrected``: complex64
    ``[D, 4 (max_len + 4)]`` payload symbols; ``llr_scale``: float32, one
    value; ``ks``: uint8 ``[max_len + 4]``, the payload keystream packed
    MSB first (byte i: the bits of payload byte i's 8 LLRs); ``plen``:
    int64 ``[D]``; the CRC engine's tables for ``max_len`` as
    :func:`crc32_compute` takes them (the kernel reads ``init_lut`` and
    ``final_xor``). Returns ``(payload uint8 [D, max_len], crc int64 [D],
    crc_rx int64 [D])``: the bytes before ``plen`` (zeros from there), the
    CRC-32 of the first ``clamp(plen, 0, max_len)`` of them and the
    big-endian word of the 4 bytes after them. The kernel counts its rows
    in ``rx.payload.crc_kernel_rows``."""
    route = kernel_route(corrected, llr_scale, ks, plen, g_packed, init_lut, final_xor)
    max_len = init_lut.shape[0] - 1
    d = corrected.shape[0]
    s = 4 * (max_len + C.CRC_NUM_BYTES)
    if corrected.dtype != torch.complex64 or tuple(corrected.shape) != (d, s):
        raise ValueError(f"symbols must be complex64 [D, {s}], got {corrected.dtype} {tuple(corrected.shape)}")
    if llr_scale.dtype != torch.float32 or llr_scale.numel() != 1:
        raise ValueError(f"llr_scale must be one float32, got {llr_scale.dtype} {tuple(llr_scale.shape)}")
    if ks.dtype != torch.uint8 or tuple(ks.shape) != (s // 4,):
        raise ValueError(f"keystream must be uint8 [{s // 4}], got {ks.dtype} {tuple(ks.shape)}")
    if plen.dtype != torch.int64 or tuple(plen.shape) != (d,):
        raise ValueError(f"lengths must be int64 [{d}], got {plen.dtype} {tuple(plen.shape)}")
    if (g_packed.dtype, init_lut.dtype, final_xor.dtype) != (torch.int64,) * 3 or (
        tuple(g_packed.shape), init_lut.ndim, final_xor.numel()) != ((8 * max_len,), 1, 1):
        raise ValueError("CRC tables must be int64 g_packed [8 max_len], init_lut [max_len + 1], final_xor []")
    if route == "plain":
        return payload_crc_plain(corrected, llr_scale, ks, plen, g_packed, init_lut, final_xor)
    if not all(t.is_contiguous() for t in (corrected, ks, plen, init_lut)) or corrected.data_ptr() % 16:
        raise ValueError("payload_crc needs contiguous tensors and 16-byte aligned symbols")
    payload = corrected.new_empty(d, max_len, dtype=torch.uint8)
    words = corrected.new_empty(2, d, dtype=torch.int64)
    if d:
        _build.launch(
            "crc", "pm_payload_crc", corrected.device,
            corrected.data_ptr(), llr_scale.data_ptr(), ks.data_ptr(), plen.data_ptr(),
            _payload_device_tables(corrected.device).data_ptr(), init_lut.data_ptr(),
            final_xor.data_ptr(), payload.data_ptr(), words.data_ptr(), d, max_len,
            -(-max_len // TILE), _build.stream_of(corrected),
        )
        count("rx.payload.crc_kernel_rows", d)
    return payload, words[0], words[1]
