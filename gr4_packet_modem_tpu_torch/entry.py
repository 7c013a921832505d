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
CFO 0.005 rad/sample, noise 0.05 a component); :func:`per_curve` the packet
error rate against Es/N0 (examples/per_sweep.py); :func:`sharded_dryrun`
the multi-card dry run of ``__graft_entry__.dryrun_multichip`` on a
``(ch, time)`` mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.channel import awgn, esn0_db_to_noise_sigma, rotate
from .models.receiver import PayloadResult, Receiver, RxConfig
from .models.transmitter import Transmitter, TxConfig
from .utils import constants as C
from .utils.ragged import PacketBatch, ragged_concat

__all__ = [
    "entry", "bank_entry", "tx_entry", "transceiver_entry", "Transceiver",
    "BENCH_CONFIG", "BENCH_CHANNELS", "BENCH_BLOCK", "TX_PAYLOAD_LEN",
    "per_curve", "per_config", "per_signal", "per_decode", "per_sets", "sharded_dryrun",
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
        res = rx.decode(samples, rx.acquirer.acquire(samples)).res
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


# the PER sweep of tests/test_per_snr.py and examples/per_sweep.py
PER_PACKETS = 24  # packets a row
PER_PAYLOAD_LEN = 200
PER_CFO = 0.005  # rad/sample


def per_config(carrier: str = "costas") -> RxConfig:
    return RxConfig(max_payload_len=256, max_detections=48, payload_carrier=carrier)


def per_signal(device: str | torch.device, channels: int = 42, seed: int = 0):
    """The PER sweep's clean bank: on each of ``channels`` rows, 24 random
    200-byte packets (``np.random.default_rng(seed)``, row after row) as
    back-to-back bursts from the port's transmitter, rotated by 0.005
    rad/sample. Returns ``(x [channels, n] complex64 on the device,
    payloads per row, signal power)``; the power is tests/test_per_snr.py:
    49-52's (mean sample power over the bursts' own samples)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    payloads = [
        [rng.integers(0, 256, PER_PAYLOAD_LEN, dtype=np.uint8) for _ in range(PER_PACKETS)]
        for _ in range(channels)
    ]
    tx = Transmitter(TxConfig(max_payload_len=256), dev)
    rows = []
    for row in payloads:  # each row's packet indices count from 0, as one JAX call's
        s, lens = tx.modulate_bursts(PacketBatch.from_list(row, 256, dev))
        rows.append(ragged_concat(s, lens, PER_PACKETS * 4 * C.burst_symbols(PER_PAYLOAD_LEN))[0])
    stream = torch.stack(rows)
    power = float(stream.abs().square().mean())
    return rotate(stream, PER_CFO), payloads, power


def per_decode(rx: Receiver, x: torch.Tensor) -> PayloadResult:
    """One ``rx.bank_step(·, group=0)`` of the unpadded bank ``x``
    ``[C, n]``: the payload rows ``[C*D]``."""
    return rx.bank_step(rx.pad(x), group=0)[2]


def per_sets(res: PayloadResult, payloads):
    """Per channel of a bank step's ``res``: the set of good packets (as
    bytes; a packet is good when an accepted row of its channel has its
    exact length and bytes, tests/test_per_snr.py:60-65) and the list of
    every accepted row's bytes."""
    c = len(payloads)
    acc = res.accepted.view(c, -1).cpu().numpy()
    lens = res.lengths.view(c, -1).cpu().numpy()
    data = res.data.view(c, acc.shape[1], -1).cpu().numpy()
    good, rows = [], []
    for ch, want in enumerate(payloads):
        got = [data[ch, i, : lens[ch, i]].tobytes() for i in np.nonzero(acc[ch])[0]]
        good.append({p.tobytes() for p in want} & set(got))
        rows.append(got)
    return good, rows


def per_curve(
    device: str | torch.device,
    esn0_db,
    carrier: str = "costas",
    channels: int = 42,
    seed: int = 0,
) -> list[dict]:
    """Packet error rate against Es/N0 (examples/per_sweep.py, at
    tests/test_per_snr.py's sizes): :func:`per_signal`'s bank, then at each
    point of ``esn0_db`` (a number or a sequence) noise at
    ``esn0_db_to_noise_sigma`` from a ``torch.Generator`` seeded
    ``seed + 100`` (the same draw at every point) and :func:`per_decode`
    with ``per_config(carrier)``. Returns one dict a point: ``esn0_db``,
    ``per``, ``good``, ``packets`` and ``crc_ok``."""
    dev = torch.device(device)
    x, payloads, power = per_signal(dev, channels, seed)
    rx = Receiver(per_config(carrier), dev)
    out = []
    for e in np.atleast_1d(np.asarray(esn0_db, np.float64)):
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        res = per_decode(rx, awgn(x, esn0_db_to_noise_sigma(float(e), power), gen))
        good = sum(map(len, per_sets(res, payloads)[0]))
        n = channels * PER_PACKETS
        out.append({"esn0_db": float(e), "per": 1.0 - good / n, "good": good, "packets": n,
                    "crc_ok": int(res.crc_ok.sum())})
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sharded_dryrun(mesh, device: str | torch.device) -> dict:
    """The multi-card dry run (``__graft_entry__.dryrun_multichip``), called
    on every rank of a ``(ch, time)`` mesh over the world:

    - ``StreamingShardedBank`` at production shapes (``freq_bins=4``,
      packets of 1536 and 700 bytes on each of ``ch_shards`` channels,
      block 2**15 so the bursts straddle the time shards, the int8 wire,
      budget 3 a cell): every packet decoded once, byte-exact, in order;
    - one ``ReceiverBank`` step with a 32-byte packet on each channel at
      the start of the bank: the mesh accepts one row a channel, with its
      bytes.

    Raises on a failed gate; returns the packet counts."""
    import torch.distributed as dist

    from .parallel.bank import BankConfig, ReceiverBank
    from .parallel.serving import StreamingShardedBank

    dev = torch.device(device)
    ch_shards, t_shards = (int(n) for n in mesh.mesh.shape)
    block = 1 << 15
    tx = Transmitter(TxConfig(max_payload_len=1536), dev)
    rng = np.random.default_rng(7)
    payloads = [[rng.integers(0, 256, n, dtype=np.uint8) for n in (1536, 700)] for _ in range(ch_shards)]
    x = np.zeros((ch_shards, 2 * block), np.complex64)
    for c, pays in enumerate(payloads):
        s, lens = tx.modulate_bursts(PacketBatch.from_list(pays, 1536, dev))
        stream = ragged_concat(s, lens, 4 * sum(C.burst_symbols(p.size) for p in pays))[0]
        off = 100 + 517 * c
        x[c, off : off + stream.shape[0]] = stream.cpu().numpy() * np.exp(1j * 0.2 * c)
    bank = StreamingShardedBank(
        mesh, RxConfig(max_payload_len=1536, max_detections=4, freq_bins=4), dev,
        channels=ch_shards, block=block, transfer_dtype=torch.int8, result_budget=3,
    )
    pkts = bank.process(x) + bank.flush()
    _check(bank.overflow_blocks == 0 and bank.budget_overflow_blocks == 0,
           f"sharded serving: {bank.overflow_blocks} overflow, {bank.budget_overflow_blocks} budget-overflow blocks")
    for c, pays in enumerate(payloads):
        got = [p.data for p in sorted(pkts, key=lambda p: p.index) if p.channel == c]
        _check(len(got) == len(pays) and all(np.array_equal(g, p) for g, p in zip(got, pays)),
               f"sharded serving channel {c}: {len(got)} of {len(pays)} packets, or bytes differ")

    rbank = ReceiverBank(mesh, BankConfig(rx=RxConfig(max_payload_len=64, max_detections=4, freq_bins=1)), dev)
    payload = np.arange(32, dtype=np.uint8)
    s, lens = Transmitter(TxConfig(max_payload_len=64), dev).modulate_bursts(
        PacketBatch.from_list([payload], 64, dev))
    stream = ragged_concat(s, lens, 4096 * t_shards)[0]
    res = rbank.step(rbank.local_slice(stream[None].expand(ch_shards, -1)).contiguous())
    acc = res.accepted.sum(dim=1)  # [C_loc]
    total = acc.clone()
    dist.all_reduce(total, group=rbank.time_group)
    _check(bool((total == 1).all()), f"ReceiverBank: accepted {total.tolist()} a channel, not 1")
    for c in torch.nonzero(acc).flatten().tolist():
        i = int(torch.nonzero(res.accepted[c])[0])
        _check(int(res.lengths[c, i]) == 32 and np.array_equal(res.data[c, i, :32].cpu().numpy(), payload),
               f"ReceiverBank channel {c}: the packet differs")
    return {"packets": len(pkts), "bank_accepted": int(total.sum())}
