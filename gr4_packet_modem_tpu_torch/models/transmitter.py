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

A bank of links (``modulate_bank``) frames and shapes the packets of every
link as one batch, each packet at its link's own GLFSR index, and lays
each link's bursts back to back into a row of the bank.

Stream mode concatenates sync || data of every packet into one symbol
stream and interpolates it with the FIR history carried across calls. Its
bank form (``modulate_stream_bank``) frames the packets of every link as
one batch, lays each link's packets back to back after the symbols it
carried over from its last call, puts a fixed number of symbols a link
through the interpolator with each link's FIR history, and carries the
rest over. The constant tables are buffers (``models/tables.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.crc import crc32_compute, crc_bytes_be
from ..ops.fir import interpolating_fir, stream_interpolating_fir
from ..ops.ldpc import encode_header
from ..ops.packing import bytes_to_bits, map_symbols, pack_bits
from ..ops.scramble import keystream_np, scramble_bits
from ..utils import constants as C
from ..utils.ragged import PacketBatch, ragged_concat
from ..utils.trace import count, span
from .tables import tables_from_numpy, transmitter_tables

__all__ = ["TxConfig", "Transmitter", "StreamCarry", "make_transmitter"]


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
        rows = torch.arange(packets.batch, device=packets.data.device)
        return self.burst_symbols_at(packets, packet_index0 + rows)

    def burst_symbols_at(
        self, packets: PacketBatch, packet_index: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`burst_symbols` with each row's own GLFSR packet index,
        int64 ``[B]`` (the sequence wraps every ``max_packets_glfsr``
        packets)."""
        syms, data_end = self._sync_data(packets, self.max_burst_syms)
        dev = syms.device
        packed = self.ramp_bits_packed[packet_index % self.config.max_packets_glfsr]
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
        return self._shape(*self.burst_symbols(packets, packet_index0))

    def _shape(self, syms: torch.Tensor, sym_lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Burst symbols -> RRC-interpolated samples with the lead ramp and
        the trail ramp ending at each burst's end, zeros past it."""
        sps = self.config.samples_per_symbol
        samples = interpolating_fir(syms, self.taps, sps)
        sample_lens = sym_lens * sps
        dev = samples.device
        tl = self.trail_ramp.numel()
        spos = torch.arange(samples.shape[1], device=dev)[None, :]
        tail = spos - (sample_lens[:, None] - tl)
        weight = torch.where(tail >= 0, self.trail_ramp[tail.clamp(0, tl - 1)], 1.0)
        weight = torch.where(tail >= tl, 0.0, weight)
        nl = self.lead_ramp.numel()
        weight[:, :nl] = weight[:, :nl] * self.lead_ramp
        return samples * weight, sample_lens

    def modulate_bank(
        self,
        data: torch.Tensor,
        lengths: torch.Tensor,
        packet_index: torch.Tensor,
        offset: torch.Tensor,
        out_len: int,
    ) -> torch.Tensor:
        """Burst-mode TX of a bank of C links, K packets each: ``data``
        uint8 ``[C, K, max_payload_len]`` and ``lengths`` ``[C, K]`` (user
        data), framed and shaped as one batch of C*K packets, then each
        link's K bursts laid back to back from sample ``offset[c]`` of its
        row (bursts past ``out_len`` are cut). Packet k of link c takes the
        GLFSR index ``packet_index[c] + k`` (int64 ``[C]``: the packets the
        link sent before). Returns complex64 ``[C, out_len]``, zeros around
        the bursts. Spans ``tx.step`` (``.frame``: header, CRC,
        scrambling, mapping; ``.shape``: FIR and ramps; ``.layout``: the
        bursts into the rows); counters ``tx.packets`` (C*K) and
        ``tx.samples`` (C*out_len), a call."""
        c, k, width = data.shape
        dev = data.device
        with span("tx.step", dev):
            with span("tx.step.frame"):
                index = (packet_index.to(torch.int64)[:, None] + torch.arange(k, device=dev)).reshape(-1)
                syms, sym_lens = self.burst_symbols_at(
                    PacketBatch(data.reshape(c * k, width), lengths.reshape(-1)), index)
            with span("tx.step.shape"):
                samples, sample_lens = self._shape(syms, sym_lens)
            del syms
            with span("tx.step.layout"):
                bank = ragged_concat(samples.view(c, k, -1), sample_lens.view(c, k), out_len, offset=offset)[0]
        count("tx.packets", c * k)
        count("tx.samples", c * out_len)
        return bank

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

    def stream_carry(self, links: int) -> "StreamCarry":
        """The state of ``links`` stream-mode links before their first
        symbol: no backlog, zero FIR history."""
        dev = self.taps.device
        return StreamCarry(torch.zeros(links, self.max_stream_syms, dtype=torch.complex64, device=dev),
                           torch.zeros(links, dtype=torch.int64, device=dev),
                           torch.zeros(links, self.arm_len - 1, dtype=torch.complex64, device=dev))

    def modulate_stream_bank(
        self,
        data: torch.Tensor,
        lengths: torch.Tensor,
        types: torch.Tensor,
        carry: "StreamCarry",
        out_syms: int,
    ) -> tuple[torch.Tensor, "StreamCarry"]:
        """Stream-mode TX of a bank of C links for one call:
        ``data`` uint8 ``[C, K, max_payload_len]``, ``lengths`` ``[C, K]``
        (0: no packet in that slot) and ``types`` ``[C, K]``
        (``PacketType``), framed as one batch of C*K packets, each sync ||
        data; each link's packets laid back to back after its carried
        backlog; ``out_syms`` symbols a link put through the RRC
        interpolator with its carried FIR history. Returns the samples
        complex64 ``[C, out_syms * sps]`` and the carry for the next call
        (:class:`StreamCarry`): the symbols past ``out_syms``, at most one
        packet's worth (``max_stream_syms``; a link handed more than that
        beyond ``out_syms`` loses the rest), and the history. A link
        handed fewer symbols than ``out_syms`` sends zeros after them.
        Spans ``tx.step`` (``.frame``, ``.layout``: the packets after
        the backlog, ``.shape``: the FIR); counter ``tx.samples`` (C *
        out_syms * sps) a call."""
        c, k, width = data.shape
        dev, w = data.device, self.max_stream_syms
        with span("tx.step", dev):
            with span("tx.step.frame"):
                lens = lengths.reshape(-1)
                syms, data_end = self._sync_data(
                    PacketBatch(data.reshape(c * k, width), lens, types.reshape(-1)), w)
                data_end = torch.where(lens > 0, data_end, 0)
            with span("tx.step.layout"):
                n = out_syms + w
                stream, total = ragged_concat(syms.view(c, k, w), data_end.view(c, k), n, offset=carry.backlog_len)
                del syms
                pos = torch.arange(n, device=dev)
                stream = torch.where(pos < carry.backlog_len[:, None], F.pad(carry.backlog, (0, n - w)), stream)
                rest = (carry.backlog_len + total - out_syms).clamp(0, w)
            with span("tx.step.shape"):
                history, samples = stream_interpolating_fir(
                    carry.history, stream[:, :out_syms], self.taps, self.config.samples_per_symbol)
        count("tx.samples", samples.numel())
        return samples, StreamCarry(stream[:, out_syms:].contiguous(), rest, history)


class StreamCarry(NamedTuple):
    """What a bank of stream-mode links carries from one call of
    :meth:`Transmitter.modulate_stream_bank` to the next: each link's
    ``backlog`` symbols complex64 ``[C, max_stream_syms]`` (the rest of a
    packet cut at the last call's end), their count ``backlog_len`` int64
    ``[C]``, and the FIR ``history`` complex64 ``[C, arm_len - 1]`` (the
    last symbols interpolated)."""

    backlog: torch.Tensor
    backlog_len: torch.Tensor
    history: torch.Tensor


def make_transmitter(
    device: str | torch.device, max_payload_len: int = 1536, stream_mode: bool = False, sps: int = 4
) -> Transmitter:
    return Transmitter(
        TxConfig(samples_per_symbol=sps, stream_mode=stream_mode, max_payload_len=max_payload_len),
        device,
    )
