"""A bank of packet links: payloads in, TX, channel and RX on the card in
one step.

Upstream's packet transceiver (apps/packet_transceiver.cpp:25-184: TUN ->
``PacketTransmitterPdu`` -> Rotator (CFO) -> AWGN -> ``PacketReceiver`` ->
TUN; test/qa_loopback.cpp is the same loop) as C links side by side, K
bursts a link a step. :meth:`TransceiverBank.step` runs five stages:

1. :meth:`~TransceiverBank.stage`: the step's payloads (uint8 ``[C, K,
   max_payload_len]``) and lengths, and each link's burst offset, carrier
   offset and phase, from host memory (pinned, so the copies are
   asynchronous) into buffers on the card;
2. :meth:`~TransceiverBank.transmit`: ``Transmitter.modulate_bank``, each
   link's K bursts back to back from its offset in a block of ``block``
   samples; each link's GLFSR ramp-down index is carried across steps
   (upstream's state persists across packets: packet p takes ramp bits
   ``[18p, 18p+18)``);
3. :meth:`~TransceiverBank.impair`: each link rotated by its own offset
   and phase (``channel.rotate``) into the block of the receiver's padded
   bank, then complex AWGN over the whole bank, its pads too, from the
   bank's ``torch.Generator`` on the card (``channel.awgn``). Upstream's
   noise source runs on every sample; exact zeros beside noise would hand
   the receiver's CFAR test weak detections at the block's edges;
4. ``Receiver.bank_step`` on that bank. The bank sits at one address, so
   from the third step on every stage replays from CUDA graphs;
5. :meth:`~TransceiverBank.to_host`: the accepted rows (bytes, lengths,
   CRC flags, Es/N0, detection indices) on the host.

Stream mode (``TxConfig.stream_mode``; upstream's ``--stream``,
apps/packet_transceiver.cpp:55-66, :99-112: the carrier never stops, IDLE
packets fill it where there is no user data, and the receiver drops them)
runs :meth:`TransceiverBank.stream_step` in place of ``step``, each link
with a carrier offset fixed for the run (:meth:`~TransceiverBank.tune`):

1. the step's packets (uint8 ``[C, K, max_payload_len]``, lengths, 0 for
   an empty slot, and ``PacketType`` values) to the card, as ``stage``;
2. :meth:`~TransceiverBank.slide`: the receiver's bank moves back by one
   block, its last ``front_pad + pad_tail`` samples to its front, in
   place (span ``rx.slide``);
3. ``transmit``: ``Transmitter.modulate_stream_bank``, exactly ``block /
   sps`` symbols a link, each link's backlog (the rest of a packet cut at
   the last step's end) and FIR history carried;
4. ``impair``: each link rotated from its carried phase, AWGN over the new
   block alone, into the bank's last ``block`` samples; each phase moves
   on by ``cfo * block`` (float64);
5. ``Receiver.stream_step`` on the bank: only syncwords in the fresh
   window ``[front_pad, front_pad + block)`` start a packet, so each is
   acquired in one step, with the lookahead that decodes it whole; the
   suppression state is carried on the card from step to step. The bank
   and the state stay at their addresses, so the stages replay from CUDA
   graphs as ``bank_step``'s do;
6. ``to_host``.

The TX and the channel run eagerly. Spans: the transmitter's ``tx.step``
(``.frame``, ``.shape``, ``.layout``), ``channel.impair`` and, in stream
mode, ``rx.slide``; counters ``tx.packets`` and ``tx.samples``, and in
stream mode ``tx.idle_packets`` (``utils/trace.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils import constants as C
from ..utils.trace import count, span
from .channel import awgn, rotate
from .receiver import IDLE_BUSY, Receiver, RxConfig
from .transmitter import Transmitter, TxConfig

__all__ = ["TransceiverBank", "Delivered"]


@dataclass
class Delivered:
    """A step's accepted packets on the host, one entry a row: ``row`` in
    the step's flat ``[C * max_detections]`` rows (link ``row //
    max_detections``), the detection's sample ``index`` in the bank, the
    payload ``length``, ``crc_ok``, ``esn0_db`` and the bytes ``data``
    ``[n, max_payload_len]``."""

    row: torch.Tensor
    index: torch.Tensor
    length: torch.Tensor
    crc_ok: torch.Tensor
    esn0_db: torch.Tensor
    data: torch.Tensor


class TransceiverBank:
    """TX -> channel -> RX over ``channels`` links of ``packets`` bursts a
    step each (in stream mode, at most ``packets`` packets start in a
    link's step), in blocks of ``block`` samples, on ``device``. ``noise``
    is the AWGN's standard deviation a component; ``group`` is
    ``bank_step``'s (the stream step runs one batch); ``generator`` (on ``device``; seeded 0 when None)
    draws the noise."""

    def __init__(
        self,
        tx: TxConfig,
        rx: RxConfig,
        channels: int,
        packets: int,
        block: int,
        device: str | torch.device,
        noise: float = 0.05,
        group: int = 0,
        generator: torch.Generator | None = None,
    ):
        dev = torch.device(device)
        self.tx = Transmitter(tx, dev)
        self.rx = Receiver(rx, dev)
        self.channels, self.packets, self.block = int(channels), int(packets), int(block)
        self.noise, self.group = float(noise), int(group)
        self.generator = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        c, k = self.channels, self.packets
        self.data = torch.zeros(c, k, tx.max_payload_len, dtype=torch.uint8, device=dev)
        self.lengths = torch.zeros(c, k, dtype=torch.int64, device=dev)
        self.offset = torch.zeros(c, dtype=torch.int64, device=dev)
        self.cfo = torch.zeros(c, dtype=torch.float64, device=dev)
        self.phase = torch.zeros(c, dtype=torch.float64, device=dev)
        self.tx_index = torch.zeros(c, dtype=torch.int64, device=dev)  # packets each link has sent
        # the receiver's bank, at one address: its graphs read it there
        n = self.rx.front_pad + self.block + self.rx.pad_tail()
        self.bank = torch.zeros(c, n, dtype=torch.complex64, device=dev)
        self.tx_bank: torch.Tensor | None = None  # the last step's TX bank [C, block]
        self.stream = tx.stream_mode
        if self.stream:
            sps = tx.samples_per_symbol
            if self.block % sps or self.block < n - self.block:
                raise ValueError(f"a stream-mode block of {self.block} samples must be a whole number of "
                                 f"symbols and hold the {n - self.block} samples the bank keeps")
            self.types = torch.zeros(c, k, dtype=torch.int64, device=dev)
            self.carry = self.tx.stream_carry(c)
            # the suppression state, at one address: the graphed step reads and writes it there
            self.busy = torch.full((c,), IDLE_BUSY, dtype=torch.int64, device=dev)

    def stage(self, data: torch.Tensor, lengths: torch.Tensor, offset: torch.Tensor, cfo: torch.Tensor,
              phase: torch.Tensor) -> None:
        """Copy a step's inputs to the card: payloads uint8 ``[C, K,
        max_payload_len]``, lengths ``[C, K]``, and per link the first
        burst's sample in the block, the carrier offset in rad/sample and
        the phase (float64). From pinned host memory the copies run
        asynchronously: leave the host tensors as they are until the step
        returns."""
        for dst, src in ((self.data, data), (self.lengths, lengths), (self.offset, offset),
                         (self.cfo, cfo), (self.phase, phase)):
            dst.copy_(src, non_blocking=True)

    def transmit(self) -> torch.Tensor:
        """The staged payloads as the TX bank ``[C, block]``; each link's
        GLFSR index moves on by K (in stream mode, the links' backlogs and
        FIR histories move on)."""
        self.tx_bank = None  # the last step's bank is freed before this one is made
        if self.stream:
            sps = self.tx.config.samples_per_symbol
            self.tx_bank, self.carry = self.tx.modulate_stream_bank(
                self.data, self.lengths, self.types, self.carry, self.block // sps)
            return self.tx_bank
        self.tx_bank = self.tx.modulate_bank(self.data, self.lengths, self.tx_index, self.offset, self.block)
        self.tx_index += self.packets
        return self.tx_bank

    def impair(self, x: torch.Tensor) -> torch.Tensor:
        """The channel: ``x`` ``[C, block]`` rotated by each link's offset
        and phase into the block of the receiver's bank, AWGN over all of
        the bank; returns the bank. In stream mode the rotated block and
        its noise go into the bank's last ``block`` samples, the rest of
        the bank as :meth:`slide` left it, and each link's phase moves on
        by ``cfo * block``."""
        with span("channel.impair", x.device):
            if self.stream:
                self.bank[:, -self.block :].copy_(awgn(rotate(x, self.cfo, self.phase), self.noise, self.generator))
                self.phase.add_(self.cfo * self.block).remainder_(2 * math.pi)
                return self.bank
            padded = F.pad(rotate(x, self.cfo, self.phase), (self.rx.front_pad, self.rx.pad_tail()))
            self.bank.copy_(awgn(padded, self.noise, self.generator))
        return self.bank

    def tune(self, cfo: torch.Tensor, phase: torch.Tensor) -> None:
        """Stream mode: each link's carrier offset (rad/sample, fixed for
        the run) and the phase of its next sample, float64 ``[C]``."""
        self.cfo.copy_(cfo)
        self.phase.copy_(phase)

    def slide(self) -> torch.Tensor:
        """Stream mode: the receiver's bank moves back by one block, its
        last ``front_pad + pad_tail`` samples to its front (one copy in
        place: the two regions do not overlap, as the constructor
        checked). Returns the bank."""
        with span("rx.slide", self.bank.device):
            keep = self.bank.shape[1] - self.block
            self.bank[:, :keep].copy_(self.bank[:, self.block :])
        return self.bank

    def to_host(self, out) -> Delivered:
        """The accepted rows of a ``bank_step`` result on the host: one wait
        for the rows' count, then every copy issued before one wait for all
        of them."""
        det, _, res, _ = out
        rows = res.accepted.nonzero().squeeze(1)
        parts = (rows, det.index[rows], res.lengths[rows], res.crc_ok[rows], det.esn0_db[rows], res.data[rows])
        host = [p.to("cpu", non_blocking=True) for p in parts]
        if rows.is_cuda:
            torch.cuda.current_stream(rows.device).synchronize()
        return Delivered(*host)

    def step(self, data: torch.Tensor, lengths: torch.Tensor, offset: torch.Tensor, cfo: torch.Tensor,
             phase: torch.Tensor):
        """One step of the loop (arguments as :meth:`stage`). Returns
        ``(bank_step's (det, hdr, res, keep), Delivered)``."""
        self.stage(data, lengths, offset, cfo, phase)
        self.impair(self.transmit())
        out = self.rx.bank_step(self.bank, self.group)
        return out, self.to_host(out)

    def stream_step(self, data: torch.Tensor, lengths: torch.Tensor, types: torch.Tensor):
        """One step of the loop in stream mode: the packets that start in
        each link's next ``block / sps`` symbols, ``data`` uint8 ``[C, K,
        max_payload_len]``, ``lengths`` ``[C, K]`` (0: an empty slot) and
        ``types`` ``[C, K]`` (``PacketType``), in host memory (pinned, so
        the copies run asynchronously: leave them as they are until the
        step returns). Counts ``tx.packets`` and ``tx.idle_packets`` from
        the host's lengths and types. Returns ``(stream_step's (det, hdr,
        res, keep), Delivered)``: the step's accepted packets, their
        indices in the bank."""
        if not self.stream:
            raise RuntimeError("stream_step needs a TransceiverBank made with TxConfig(stream_mode=True)")
        sent = lengths > 0
        count("tx.packets", int(sent.sum()))
        count("tx.idle_packets", int((sent & (types == int(C.PacketType.IDLE))).sum()))
        for dst, src in ((self.data, data), (self.lengths, lengths), (self.types, types)):
            dst.copy_(src, non_blocking=True)
        self.slide()
        self.impair(self.transmit())
        out = self.rx.stream_step(self.bank, self.busy)
        return out, self.to_host(out)
