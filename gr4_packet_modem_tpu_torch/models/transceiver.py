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

The TX and the channel run eagerly. Spans: the transmitter's ``tx.step``
(``.frame``, ``.shape``, ``.layout``) and ``channel.impair``; counters
``tx.packets`` and ``tx.samples`` (``utils/trace.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils.trace import span
from .channel import awgn, rotate
from .receiver import Receiver, RxConfig
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
    step each, in blocks of ``block`` samples, on ``device``. ``noise`` is
    the AWGN's standard deviation a component; ``group`` is
    ``bank_step``'s; ``generator`` (on ``device``; seeded 0 when None)
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
        GLFSR index moves on by K."""
        self.tx_bank = None  # the last step's bank is freed before this one is made
        self.tx_bank = self.tx.modulate_bank(self.data, self.lengths, self.tx_index, self.offset, self.block)
        self.tx_index += self.packets
        return self.tx_bank

    def impair(self, x: torch.Tensor) -> torch.Tensor:
        """The channel: ``x`` ``[C, block]`` rotated by each link's offset
        and phase into the block of the receiver's bank, AWGN over all of
        the bank; returns the bank."""
        with span("channel.impair", x.device):
            padded = F.pad(rotate(x, self.cfo, self.phase), (self.rx.front_pad, self.rx.pad_tail()))
            self.bank.copy_(awgn(padded, self.noise, self.generator))
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
