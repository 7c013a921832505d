"""Full transceiver app: TX -> channel model -> RX, IP over radio via TUN.

Port of apps/packet_transceiver.py (apps/packet_transceiver.cpp):
TunSource -> PacketTransmitterPdu -> [throttle @ samp_rate] -> channel (SFO
resampler, CFO rotator, AWGN) -> PacketReceiver -> PacketTypeFilter ->
TunSink, with the latency-management credit loop bounding in-flight
packets. Without ``--tun-in`` it runs a self-test loopback with generated
packets. The TUN devices need root (CAP_NET_ADMIN).

The transmitter and the channel run on the device; each loop's samples
cross to the host for the streaming receiver, as the JAX app's do. As in
the JAX app, each chunk is resampled by ``sfo`` from scratch, the CFO phase
runs on across chunks through ``rotate``'s ``n0``, and the stream-mode tail
goes through the same channel. The noise comes from a ``torch.Generator``
on the device seeded from the clock.

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_transceiver
       [--stream] [--esn0 DB] [--cfo RAD_PER_SAMPLE] [--sfo PPM] [--bins N]
       [--samp-rate SPS] [--max-len N] [--max-packets N] [--idle-size N]
       [--tun-in NAME] [--tun-out NAME] [--netns-in NS] [--netns-out NS]
       [--seconds T] [--log-packets] [--zmq] [--device DEV]
"""

from __future__ import annotations

import argparse
import logging
import statistics
import time

import numpy as np
import torch

from ..models.channel import awgn, esn0_db_to_noise_sigma, rotate, sfo
from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.flow import PacketCredit, ProbeRate, Throttle
from ..runtime.streaming import StreamingReceiver, StreamingTransmitter
from ..utils import constants as C
from ..utils.device import require_device

PACKETS_PER_LOOP = 4
RX_BLOCK = 1 << 17


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="packet_transceiver")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--esn0", type=float, default=20.0)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--sfo", type=float, default=0.0)
    p.add_argument("--bins", type=int, default=4)
    p.add_argument("--samp-rate", type=float, default=3.2e6)
    p.add_argument("--max-len", type=int, default=1536)
    p.add_argument("--max-packets", type=int, default=2, help="credit limit")
    p.add_argument("--idle-size", type=int, default=256)
    p.add_argument("--tun-in", default="")
    p.add_argument("--tun-out", default="")
    p.add_argument("--netns-in", default="")
    p.add_argument("--netns-out", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument(
        "--log-packets",
        action="store_true",
        help="per-packet RX debug line (index/len/type/esn0/freq/arm), the "
        "reference's PayloadMetadataInsert{log:true}",
    )
    p.add_argument(
        "--zmq",
        action="store_true",
        help="publish post-Costas header/payload symbols on tcp://*:5000 "
        "and :5001 for scripts/plot_symbols.py",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def run(argv: list[str] | None = None, echo=print) -> dict:
    """Run the transceiver for ``--seconds``, then flush. Returns:

    - ``sent``, ``received``: packet counts;
    - ``sent_payloads``: the self-test and TUN payloads sent as user data,
      in order; ``decoded``: the decoded packets (``DecodedPacket``), in
      order;
    - ``reports``: ``ProbeRate``'s ``RateReport`` list;
    - ``samples``, ``loops``, ``seconds``: samples through the channel,
      loop iterations and the loop's wall time (the flush excluded);
    - ``split_ms``, ``split_mean_ms``: median and mean host ms of a loop's
      stages: ``tx_channel`` (the transmitter and the channel model, up to
      their samples on the host: the copy waits for the device), ``throttle``
      and ``rx`` (``process``, which pushes a block every few loops).
    """
    args = parser().parse_args(argv)
    dev = require_device(args.device)
    if args.log_packets:
        logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

    tx = StreamingTransmitter(
        Transmitter(TxConfig(max_payload_len=args.max_len, stream_mode=args.stream), dev)
    )
    header_tap = payload_tap = None
    if args.zmq:
        from ..io.zmq_pub import ZmqPduPubSink

        header_tap = ZmqPduPubSink("tcp://*:5000")
        payload_tap = ZmqPduPubSink("tcp://*:5001")
    rx = StreamingReceiver(
        RxConfig(max_payload_len=args.max_len, freq_bins=args.bins),
        dev,
        block=RX_BLOCK,
        header_tap=header_tap,
        payload_tap=payload_tap,
        log=args.log_packets,
    )
    throttle = Throttle(args.samp_rate)
    probe = ProbeRate()
    credit = PacketCredit(args.max_packets)

    tun_in = tun_out = None
    if args.tun_in or args.tun_out:
        from ..io.tun import TunDevice

        if args.tun_in:
            tun_in = TunDevice(args.tun_in, args.netns_in)
        if args.tun_out:
            tun_out = TunDevice(args.tun_out, args.netns_out)

    # noise sigma from Es/N0 at the TX output power
    probe_sig = tx.burst([np.zeros(256, np.uint8)])
    sig_power = float(probe_sig.abs().square().mean())
    tx._packet_index = 0  # the probe burst was out-of-band
    sigma = esn0_db_to_noise_sigma(args.esn0, sig_power)
    gen = torch.Generator(device=dev).manual_seed(int(time.time()))

    # channel impairments shared by the main loop and the stream-mode tail
    # flush: the CFO rotator phase is continuous across chunks (rotate's n0
    # carries the absolute sample index), so the final in-flight packet sees
    # no phase discontinuity at the flush boundary
    n_abs = 0

    def through_channel(sig: torch.Tensor) -> np.ndarray:
        nonlocal n_abs
        x = sig
        if args.sfo:
            x = sfo(x, args.sfo)
        if args.cfo:
            x = rotate(x, args.cfo, n0=n_abs)
        n_abs += int(x.shape[0])
        return awgn(x, sigma, gen).cpu().numpy()

    decoded, sent_payloads, reports = [], [], []
    split = {"tx_channel": [], "throttle": [], "rx": []}

    def deliver(pkts, release: bool) -> None:
        for pkt in pkts:
            decoded.append(pkt)
            if release:
                credit.release()
            if tun_out is not None:
                tun_out.write_packet(pkt.data.tobytes())

    user = int(C.PacketType.USER_DATA)
    sent = seq = samples = loops = 0
    t_start = time.perf_counter()
    deadline = time.time() + args.seconds
    while time.time() < deadline:
        # ---- ingress: TUN packets or idle/test packets
        payloads, types = [], []
        for _ in range(PACKETS_PER_LOOP):
            pkt = tun_in.read_packet(10) if tun_in is not None else None
            if pkt is not None and credit.acquire(0.1):
                payloads.append(np.frombuffer(pkt, np.uint8))
                types.append(user)
            elif args.stream or tun_in is None:
                payloads.append((np.arange(args.idle_size) + seq).astype(np.uint8) % np.uint8(255))
                types.append(int(C.PacketType.IDLE) if tun_in is not None else user)
                seq += 1
        if not payloads:
            continue
        sent += len(payloads)
        sent_payloads.extend(p for p, t in zip(payloads, types) if t == user)
        t0 = time.perf_counter()
        sig = tx.stream(payloads, types) if args.stream else tx.burst(payloads, types)
        # ---- channel
        x = through_channel(sig)
        t1 = time.perf_counter()
        throttle.wait(x.shape[0])
        t2 = time.perf_counter()
        # ---- RX
        deliver(rx.process(x), release=True)
        t3 = time.perf_counter()
        for k, a, b in (("tx_channel", t0, t1), ("throttle", t1, t2), ("rx", t2, t3)):
            split[k].append((b - a) * 1e3)
        samples += x.shape[0]
        loops += 1
        rep = probe.update(x.shape[0])
        if rep is not None:
            reports.append(rep)
            echo(
                f"rate {rep.rate_now / 1e6:.2f} Msps (avg "
                f"{rep.rate_avg / 1e6:.2f}), sent {sent}, received {len(decoded)}"
            )
    seconds = time.perf_counter() - t_start
    if args.stream:
        # flush the TX interpolator history through the receiver so the
        # final in-flight packet's tail samples are not lost; the tail goes
        # through the same channel (continuous CFO phase) as the main loop
        tail = tx.flush()
        if tail.numel():
            deliver(rx.process(through_channel(tail)), release=True)
    deliver(rx.flush(), release=False)
    for tun in (tun_in, tun_out):
        if tun is not None:
            tun.close()
    echo(f"done: sent {sent}, received {len(decoded)}")
    return {
        "sent": sent, "received": len(decoded), "sent_payloads": sent_payloads,
        "decoded": decoded, "reports": reports, "samples": samples, "loops": loops,
        "seconds": seconds,
        "split_ms": {k: statistics.median(v) if v else 0.0 for k, v in split.items()},
        "split_mean_ms": {k: statistics.fmean(v) if v else 0.0 for k, v in split.items()},
    }


def main() -> None:
    run()


if __name__ == "__main__":
    main()
