"""TX app for SDR use: TUN -> transmitter -> file/FIFO, with credit loop.

Port of apps/packet_transmitter_sdr.py (apps/packet_transmitter_sdr.cpp):
no throttle (the downstream consumer, typically a GR3/UHD flowgraph reading
the FIFO, sets the rate). In stream mode idle packets fill the time the TUN
device is empty (tun_source.hpp:101-107). ``--tun`` needs root
(CAP_NET_ADMIN).

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_transmitter_sdr
       OUT_FIFO [--stream] [--tun NAME] [--netns NS] [--idle-size N]
       [--seconds T] [--device DEV]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..io.file import FileSinkC64
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.streaming import StreamingTransmitter
from ..utils import constants as C
from ..utils.device import require_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="packet_transmitter_sdr")
    p.add_argument("out_fifo")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--tun", default="")
    p.add_argument("--netns", default="")
    p.add_argument("--idle-size", type=int, default=256)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def run(argv: list[str] | None = None, echo=print) -> dict:
    """Transmit until ``--seconds`` have passed. Returns ``sent`` (packets),
    ``types`` (their packet types, in order) and ``samples`` written (the
    stream-mode flush included)."""
    args = parser().parse_args(argv)
    dev = require_device(args.device)
    tx = StreamingTransmitter(
        Transmitter(TxConfig(max_payload_len=1536, stream_mode=args.stream), dev)
    )
    tun = None
    if args.tun:
        from ..io.tun import TunDevice

        tun = TunDevice(args.tun, args.netns)

    deadline = time.time() + args.seconds
    sent_types: list[int] = []
    samples = 0
    with FileSinkC64(args.out_fifo) as sink:
        while time.time() < deadline:
            payloads, types = [], []
            pkt = tun.read_packet(100) if tun is not None else None
            if pkt is not None:
                payloads.append(np.frombuffer(pkt, np.uint8))
                types.append(int(C.PacketType.USER_DATA))
            elif args.stream:
                # stream mode inserts idle packets when the TUN is empty
                payloads.append(np.zeros(args.idle_size, np.uint8))
                types.append(int(C.PacketType.IDLE))
            else:
                continue
            sig = tx.send_stream(payloads, types) if args.stream else tx.send_burst(payloads, types)
            sink.write(sig)
            samples += sig.size
            sent_types.extend(types)
        if args.stream:
            # flush the interpolator history or the last packet's tail
            # samples never leave the filter
            tail = tx.flush_stream()
            sink.write(tail)
            samples += tail.size
    if tun is not None:
        tun.close()
    echo(f"sent {len(sent_types)} packets")
    return {"sent": len(sent_types), "types": sent_types, "samples": samples}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
