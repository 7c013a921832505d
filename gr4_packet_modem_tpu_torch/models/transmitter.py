"""Batched packet transmitter (port of ``gr4_packet_modem_tpu/models/
transmitter.py``).

The reference's TX composite ``PacketTransmitterPdu``
(packet_transmitter_pdu.hpp:30-406) runs as one batched pass over a ragged
packet batch:

1. header: length, type and spare bytes, (128,32) LDPC and repetition, in
   exact integer GF(2) arithmetic (``ops/ldpc.py::encode_header``);
2. payload CRC-32 (``ops/crc.py``, integer XOR of table words), placed
   big-endian after each payload;
3. scrambling (keystream XOR), QPSK mapping;
4. burst assembly: syncword || data || GLFSR ramp-down || 11 flush zeros,
   each row's sections placed by position masks;
5. RRC interpolation (``ops/fir.py``, elementwise float32: no TF32 setting
   changes the samples);
6. burst shaping: the leading ramp, and the trailing ramp at each row's own
   end.

Stream mode concatenates sync || data of every packet into one symbol
stream and interpolates it with the FIR history carried across calls. The
constant tables are buffers (``models/tables.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.crc import crc32_compute, crc_bytes_be
from ..ops.fir import interpolating_fir, stream_interpolating_fir
from ..ops.ldpc import encode_header
from ..ops.packing import bytes_to_bits, map_symbols, pack_bits
from ..ops.scramble import keystream_np, scramble_bits
from ..utils import constants as C
from ..utils.ragged import PacketBatch, ragged_concat
from .tables import tables_from_numpy, transmitter_tables

__all__ = ["TxConfig", "Transmitter", "make_transmitter"]


@dataclass(frozen=True)
class TxConfig:
    samples_per_symbol: int = 4
    stream_mode: bool = False
    max_payload_len: int = 1536  # static bound on payload bytes per packet
    max_packets_glfsr: int = 4096  # ramp-down bits kept: packets before the sequence repeats


class Transmitter(nn.Module):
    """The transmit chain for one static configuration, on ``device``."""

    def __init__(self, config: TxConfig, device: str | torch.device):
        super().__init__()
        self.config = config
        lmax = config.max_payload_len
        # frame = coded header (32 B) + payload + CRC (4 B)
        self.max_frame_bytes = C.HEADER_CODED_BYTES + lmax + C.CRC_NUM_BYTES
        self.max_data_syms = 4 * self.max_frame_bytes
        self.max_stream_syms = C.SYNCWORD_LEN + self.max_data_syms
        self.max_burst_syms = self.max_stream_syms + C.RAMP_DOWN_SYMBOLS + C.RRC_FLUSH_SYMBOLS
        dev = torch.device(device)
        tables = transmitter_tables(config.samples_per_symbol, lmax, config.max_packets_glfsr)
        for name, value in tables_from_numpy(tables).items():
            self.register_buffer(name, value.to(dev))
        ks = keystream_np(8 * self.max_frame_bytes)
        self.register_buffer("ks", torch.tensor(ks, device=dev), persistent=False)

    @property
    def arm_len(self) -> int:
        """Symbols of FIR history: taps per polyphase arm."""
        return -(-self.taps.numel() // self.config.samples_per_symbol)

    def load_tables(self, tables: dict[str, torch.Tensor]) -> None:
        """Replace the constant tables (names of ``models/tables.py``, e.g.
        ``tables_from_numpy(numpy_tables_of(jax_tx, TX_JAX_ATTRIBUTES))``).
        Shapes and dtypes must match the transmitter's own."""
        bufs = {name: self.get_buffer(name) for name in tables}
        for name, buf in bufs.items():
            value = tables[name]
            if buf.shape != value.shape or buf.dtype != value.dtype:
                raise ValueError(
                    f"table {name}: {value.dtype} {tuple(value.shape)} does not "
                    f"match {buf.dtype} {tuple(buf.shape)}"
                )
        for name, buf in bufs.items():
            buf.copy_(tables[name])

    # ---------------------------------------------------------------- symbols

    def _frame_symbols(self, packets: PacketBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """Scrambled QPSK data symbols (header + payload + CRC) per packet:
        ``(syms complex64 [B, max_data_syms], data_sym_lens int64 [B])``;
        symbols past a row's length carry the zero padding's mapping."""
        data = packets.data
        lens = packets.lengths.to(torch.int64)
        b, lmax = data.shape[0], self.config.max_payload_len
        types = torch.zeros_like(lens) if packets.types is None else packets.types
        idle = (types == int(C.PacketType.IDLE)).to(torch.int64)
        header = torch.stack(
            [lens >> 8, lens & 0xFF, idle, torch.full_like(lens, C.HEADER_SPARE)], dim=-1
        ).to(torch.uint8)  # [B, 4] (header_formatter.hpp:110-113)
        coded_header_bits = encode_header(bytes_to_bits(header), self.ldpc_generator)
        # CRC-32 appended big-endian at bytes lens..lens+3 (crc_append.hpp)
        crc = crc32_compute(data, lens, self.crc_g_packed, self.crc_init_lut, self.crc_final_xor)
        rel = torch.arange(lmax + C.CRC_NUM_BYTES, device=data.device)[None, :] - lens[:, None]
        crc_at = crc_bytes_be(crc).gather(1, rel.clamp(0, C.CRC_NUM_BYTES - 1))
        padded = torch.cat([data, data.new_zeros(b, C.CRC_NUM_BYTES)], dim=1)
        payload_crc = torch.where((rel >= 0) & (rel < C.CRC_NUM_BYTES), crc_at, padded)
        frame_bits = torch.cat([coded_header_bits, bytes_to_bits(payload_crc)], dim=-1)
        frame_bits = scramble_bits(frame_bits, self.ks)
        syms = map_symbols(pack_bits(frame_bits, 2), self.qpsk)  # [B, 4*max_frame_bytes]
        return syms, 4 * (C.HEADER_CODED_BYTES + lens + C.CRC_NUM_BYTES)

    def _sync_data(self, packets: PacketBatch, width: int):
        """Symbols ``[B, width]`` holding sync || data of each packet and
        zeros past it, and the position of each row's data end."""
        data_syms, data_sym_lens = self._frame_symbols(packets)
        b, sl = data_syms.shape[0], C.SYNCWORD_LEN
        rest = width - sl - data_syms.shape[1]
        syms = torch.cat([self.sync_syms.expand(b, sl), data_syms, data_syms.new_zeros(b, rest)], dim=1)
        data_end = sl + data_sym_lens
        pos = torch.arange(width, device=syms.device)[None, :]
        return torch.where(pos < data_end[:, None], syms, syms.new_zeros(())), data_end

    # ------------------------------------------------------------- burst mode

    def burst_symbols(
        self, packets: PacketBatch, packet_index0: int | torch.Tensor = 0
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Burst-mode symbols ``(complex64 [B, max_burst_syms], sym_lens
        int64 [B])``: sync || data || ramp-down || 11 flush zeros, zeros
        past each row's burst.

        ``packet_index0`` is the first packet's index in the GLFSR
        ramp-down sequence: its state persists across packets in the
        reference, so packet p takes ramp bits ``[18p, 18p+18)``."""
        syms, data_end = self._sync_data(packets, self.max_burst_syms)
        dev = syms.device
        pidx = packet_index0 + torch.arange(syms.shape[0], device=dev)
        packed = self.ramp_bits_packed[pidx % self.config.max_packets_glfsr]
        ramp_bits = (packed[:, None] >> torch.arange(C.RAMP_DOWN_BITS, device=dev)) & 1
        ramp_idx = pack_bits(ramp_bits, 2)  # [B, 9]
        # ramp-down symbols at data_end .. data_end + 9, then flush zeros
        rel = torch.arange(self.max_burst_syms, device=dev)[None, :] - data_end[:, None]
        ramp = map_symbols(ramp_idx.gather(1, rel.clamp(0, C.RAMP_DOWN_SYMBOLS - 1)), self.qpsk)
        syms = torch.where((rel >= 0) & (rel < C.RAMP_DOWN_SYMBOLS), ramp, syms)
        return syms, data_end + C.RAMP_DOWN_SYMBOLS + C.RRC_FLUSH_SYMBOLS

    def modulate_bursts(
        self, packets: PacketBatch, packet_index0: int | torch.Tensor = 0
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Burst-mode TX: packets -> shaped sample bursts
        ``(samples complex64 [B, max_burst_syms*sps], sample_lens int64 [B])``
        (``packet_index0`` as in :meth:`burst_symbols`)."""
        sps = self.config.samples_per_symbol
        syms, sym_lens = self.burst_symbols(packets, packet_index0)
        samples = interpolating_fir(syms, self.taps, sps)
        sample_lens = sym_lens * sps
        dev = samples.device
        # shaping: lead ramp, trail ramp ending at each burst's end, zeros past it
        tl = self.trail_ramp.numel()
        spos = torch.arange(samples.shape[1], device=dev)[None, :]
        tail = spos - (sample_lens[:, None] - tl)
        weight = torch.where(tail >= 0, self.trail_ramp[tail.clamp(0, tl - 1)], 1.0)
        weight = torch.where(tail >= tl, 0.0, weight)
        nl = self.lead_ramp.numel()
        weight[:, :nl] = weight[:, :nl] * self.lead_ramp
        return samples * weight, sample_lens

    # ------------------------------------------------------------ stream mode

    def modulate_stream_symbols(
        self, packets: PacketBatch, out_syms: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stream-mode symbols: sync || data of each packet back to back,
        ``(symbols [out_syms], total_syms)``."""
        syms, data_end = self._sync_data(packets, self.max_stream_syms)
        return ragged_concat(syms, data_end, out_syms)

    def modulate_stream(
        self, packets: PacketBatch, out_syms: int, carry: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stream-mode TX: the symbol stream through the RRC interpolator.
        Returns ``(carry, samples [out_syms*sps], total_samples)``;
        ``carry`` holds the FIR history across calls (zeros when None)."""
        sps = self.config.samples_per_symbol
        if carry is None:
            carry = torch.zeros(self.arm_len - 1, dtype=torch.complex64, device=self.taps.device)
        syms, total = self.modulate_stream_symbols(packets, out_syms)
        carry, samples = stream_interpolating_fir(carry, syms, self.taps, sps)
        return carry, samples, total * sps


def make_transmitter(
    device: str | torch.device, max_payload_len: int = 1536, stream_mode: bool = False, sps: int = 4
) -> Transmitter:
    return Transmitter(
        TxConfig(samples_per_symbol=sps, stream_mode=stream_mode, max_payload_len=max_payload_len),
        device,
    )
