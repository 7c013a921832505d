"""Entry points of the port: the counterparts of ``__graft_entry__.entry()``
and of the transmitter and transceiver benchmarks.

:func:`entry` returns the single-channel receive step (acquire -> header
decode -> overlap filter -> payload decode) and an example input;
:func:`bank_entry` returns the bank step at the bench geometry (64 channels
of 2**19 samples, 9 frequency bins, 1536-byte payloads, 24 detection slots,
V&V payload carrier, fused acquisition: bench.py's default backend);
:func:`tx_entry` the transmitter at the geometry of
benchmarks/benchmark_packet_transmitter_pdu.py (64 x 1500-byte packets,
burst or stream mode); :func:`transceiver_entry` the TX -> channel -> RX
step of benchmarks/benchmark_packet_transceiver.py (24 x 1500-byte bursts,
CFO 0.005 rad/sample, noise 0.05 a component).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.channel import awgn, rotate
from .models.receiver import PayloadResult, Receiver, RxConfig
from .models.transmitter import Transmitter, TxConfig
from .utils import constants as C
from .utils.ragged import PacketBatch, ragged_concat

__all__ = [
    "entry", "bank_entry", "tx_entry", "transceiver_entry", "Transceiver",
    "BENCH_CONFIG", "BENCH_CHANNELS", "BENCH_BLOCK", "TX_PAYLOAD_LEN",
]

# bench.py's geometry: max_detections is its formula for 12 x 1500-byte
# bursts tiled over a 2**19-sample block (bench.py:84-87)
BENCH_CHANNELS = 64
BENCH_BLOCK = 1 << 19
BENCH_CONFIG = RxConfig(
    max_payload_len=1536,
    max_detections=24,
    freq_bins=4,
    payload_carrier="vv",
    acquisition_backend="fused",
)


def entry(device: str | torch.device):
    """``(fn, example_args)`` for the single-channel step over one padded
    block of 2**16 samples; ``fn`` returns ``(accepted, lengths, data)``."""
    dev = torch.device(device)
    rx = Receiver(RxConfig(max_payload_len=256, max_detections=16, freq_bins=4), dev)

    def rx_step(samples: torch.Tensor):
        det = rx.acquirer.acquire(samples)
        hdr, _ = rx.decode_headers(samples, det)
        keep = rx.filter_detections(det, hdr)
        res = rx.decode_payloads(samples, det, hdr, keep)
        return res.accepted, res.lengths, res.data

    t = 1 << 16
    example = (
        torch.zeros(t + rx.front_pad + rx.pad_tail(), dtype=torch.complex64, device=dev),
    )
    return rx_step, example


def bank_entry(
    device: str | torch.device,
    channels: int = BENCH_CHANNELS,
    block: int = BENCH_BLOCK,
):
    """``(fn, example_args)`` for the bank step at the bench geometry;
    ``fn`` maps a padded bank ``[channels, front_pad + block + pad_tail]``
    to ``(det, hdr, res, keep)`` (``Receiver.bank_step``). ``channels`` and
    ``block`` may be cut for small runs."""
    dev = torch.device(device)
    rx = Receiver(BENCH_CONFIG, dev)
    n = rx.front_pad + block + rx.pad_tail()
    example = (torch.zeros(channels, n, dtype=torch.complex64, device=dev),)
    return rx.bank_step, example


TX_PAYLOAD_LEN = 1500  # bytes of each packet of the TX and transceiver entries


def _payloads(batch: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, TX_PAYLOAD_LEN, dtype=np.uint8) for _ in range(batch)]


def tx_entry(device: str | torch.device, stream: bool = False, batch: int = 64):
    """``(fn, example_args)`` for the transmitter on ``batch`` random
    1500-byte packets (``max_payload_len=1536``): ``fn`` maps a
    :class:`PacketBatch` on the device to ``(samples [B, max_burst_syms*4],
    sample_lens [B])`` (``modulate_bursts``), or with ``stream`` to
    ``(samples [batch * stream_symbols(1500) * 4], total)``
    (``modulate_stream`` from a zero FIR history)."""
    dev = torch.device(device)
    tx = Transmitter(TxConfig(max_payload_len=1536, stream_mode=stream), dev)
    packets = PacketBatch.from_list(_payloads(batch), 1536, dev)
    if stream:
        out_syms = batch * C.stream_symbols(TX_PAYLOAD_LEN)

        def step(b: PacketBatch) -> tuple[torch.Tensor, torch.Tensor]:
            return tx.modulate_stream(b, out_syms)[1:]

        return step, (packets,)
    return tx.modulate_bursts, (packets,)


class Transceiver:
    """TX -> channel -> RX as one step (benchmark_packet_transceiver.py:
    bursts back to back, ``rotate`` by 0.005 rad/sample, ``awgn`` at 0.05,
    padded and received by the one-shot receive path). The three stages
    are methods of their own so that each can be timed."""

    def __init__(self, device: str | torch.device, bins: int = 4, batch: int = 24):
        dev = torch.device(device)
        self.tx = Transmitter(TxConfig(max_payload_len=1536), dev)
        self.rx = Receiver(
            RxConfig(max_payload_len=1536, max_detections=max(32, batch + 8), freq_bins=bins), dev
        )
        self.total = batch * 4 * C.burst_symbols(TX_PAYLOAD_LEN)  # 24912 samples a packet

    def transmit(self, packets: PacketBatch) -> torch.Tensor:
        samples, lens = self.tx.modulate_bursts(packets)
        return ragged_concat(samples, lens, self.total)[0]

    @staticmethod
    def channel(stream: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return awgn(rotate(stream, 0.005), 0.05, generator)

    def receive(self, x: torch.Tensor) -> PayloadResult:
        return self.rx.receive(x)

    def __call__(self, packets: PacketBatch, generator: torch.Generator):
        """Returns ``(accepted.sum(), PayloadResult)``: the count of
        decoded packets and the decoded rows."""
        res = self.receive(self.channel(self.transmit(packets), generator))
        return res.accepted.sum(), res


def transceiver_entry(device: str | torch.device, bins: int = 4, batch: int = 24):
    """``(fn, example_args)`` for the transceiver step at ``bins``
    frequency bins a side (``freq_bins``) on ``batch`` random 1500-byte
    packets: ``fn`` is a :class:`Transceiver`, the arguments a
    :class:`PacketBatch` and a ``torch.Generator`` (seed 0) on the
    device."""
    dev = torch.device(device)
    fn = Transceiver(dev, bins, batch)
    packets = PacketBatch.from_list(_payloads(batch), 1536, dev)
    return fn, (packets, torch.Generator(device=dev).manual_seed(0))
