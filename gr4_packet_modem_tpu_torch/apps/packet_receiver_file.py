"""RX-only app: decode packets from a raw complex64 IQ file.

Port of apps/packet_receiver_file.py (apps/packet_receiver_file.cpp):
FileSource -> PacketReceiver -> (TunSink | summary). Decoded user packets
are written to a TUN device when ``--tun`` is given (needs root,
CAP_NET_ADMIN), otherwise summarised on stdout.

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_receiver_file
       IQ_FILE [--tun NAME] [--netns NS] [--bins N] [--threshold X]
       [--max-len N] [--block N] [--zmq] [--log-packets] [--device DEV]
"""

from __future__ import annotations

import argparse
import logging
import time

from ..io.file import stream_c64_blocks
from ..models.receiver import RxConfig
from ..runtime.streaming import StreamingReceiver
from ..utils.device import require_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="packet_receiver_file")
    p.add_argument("iq_file")
    p.add_argument("--tun", default="")
    p.add_argument("--netns", default="")
    p.add_argument("--bins", type=int, default=4)
    p.add_argument("--threshold", type=float, default=9.5)
    p.add_argument("--max-len", type=int, default=1536)
    p.add_argument("--block", type=int, default=1 << 18)
    p.add_argument(
        "--zmq",
        action="store_true",
        help="publish post-Costas header/payload symbols on tcp://*:5000 "
        "and :5001 for scripts/plot_symbols.py (packet_receiver.hpp:159-189)",
    )
    p.add_argument(
        "--log-packets",
        action="store_true",
        help="per-packet RX debug line (index/len/type/esn0/freq/arm), the "
        "reference's PayloadMetadataInsert{log:true} "
        "(payload_metadata_insert.hpp:66)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def run(argv: list[str] | None = None, echo=print) -> dict:
    """Decode the file. Returns ``packets`` (the ``DecodedPacket`` list in
    the order decoded), ``count``, ``samples`` read, ``seconds`` from the
    first block read to the end of the flush and ``rate_sps`` (their
    ratio)."""
    args = parser().parse_args(argv)
    dev = require_device(args.device)
    if args.log_packets:
        logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

    tun = None
    if args.tun:
        from ..io.tun import TunDevice

        tun = TunDevice(args.tun, args.netns)

    header_tap = payload_tap = None
    if args.zmq:
        from ..io.zmq_pub import ZmqPduPubSink

        header_tap = ZmqPduPubSink("tcp://*:5000")
        payload_tap = ZmqPduPubSink("tcp://*:5001")

    rx = StreamingReceiver(
        RxConfig(
            max_payload_len=args.max_len,
            freq_bins=args.bins,
            power_threshold=args.threshold,
        ),
        dev,
        block=args.block,
        header_tap=header_tap,
        payload_tap=payload_tap,
        log=args.log_packets,
    )
    packets, samples = [], 0
    t0 = time.perf_counter()
    for block in stream_c64_blocks(args.iq_file, args.block):
        samples += block.size
        for pkt in rx.process(block):
            packets.append(pkt)
            if tun is not None:
                tun.write_packet(pkt.data.tobytes())
            else:
                echo(
                    f"packet {len(packets)}: len={pkt.data.size} at sample "
                    f"{pkt.index}, Es/N0={pkt.esn0_db:.2f} dB"
                )
    for pkt in rx.flush():
        packets.append(pkt)
        if tun is not None:
            tun.write_packet(pkt.data.tobytes())
        else:
            echo(f"packet {len(packets)}: len={pkt.data.size} at sample {pkt.index}")
    seconds = time.perf_counter() - t0
    if tun is not None:
        tun.close()
    echo(f"decoded {len(packets)} packets")
    return {"packets": packets, "count": len(packets), "samples": samples,
            "seconds": seconds, "rate_sps": samples / seconds if seconds > 0 else 0.0}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
