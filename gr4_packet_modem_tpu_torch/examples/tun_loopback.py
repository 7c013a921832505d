"""IP over the modem: TUN -> modem TX -> channel -> modem RX -> TUN (port
of examples/tun_loopback.py; the reference's tun.cpp plumbing extended
through the whole modem, a small ``apps/packet_transceiver``). With root
and the ``scripts/netns-setup`` topology:

    sudo scripts/netns-setup
    sudo python -m gr4_packet_modem_tpu_torch.examples.tun_loopback --netns
    # in another terminal:
    sudo ip netns exec pmtx ping -c 3 10.9.0.2

Ping requests from the ``pmtx`` namespace travel through the modem (TUN
read -> burst modulation -> AWGN -> acquisition and decode -> TUN write
into ``pmrx``); replies return over the namespaces' veth path.

Without ``--netns`` (the default) it runs the same data path in loopback
demo mode: synthetic IP packets stand in for the TUN reads and the decoded
packets are checked byte for byte instead of written to a device. On CUDA
tensors the receive runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.tun_loopback
       [--netns] [--noise X] [--count N] [--device DEV]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.channel import awgn
from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.streaming import StreamingReceiver, StreamingTransmitter
from . import parse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gr4_packet_modem_tpu_torch.examples.tun_loopback",
                                 description="IP-over-modem walkthrough: TUN -> modem TX -> "
                                 "channel -> modem RX -> TUN.")
    ap.add_argument("--netns", action="store_true",
                    help="use the real pmtx/pmrx TUN topology (root + netns-setup)")
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--count", type=int, default=4)
    return ap


def fake_ip_packet(seq: int, size: int = 84) -> bytes:
    """A syntactically plausible IPv4 packet (what a TUN read yields)."""
    hdr = bytearray(20)
    hdr[0] = 0x45  # v4, IHL 5
    hdr[2:4] = size.to_bytes(2, "big")
    hdr[8] = 64  # TTL
    hdr[9] = 1  # ICMP
    hdr[12:16] = bytes([10, 9, 0, 1])
    hdr[16:20] = bytes([10, 9, 0, 2])
    body = bytes((seq + i) % 256 for i in range(size - 20))
    return bytes(hdr) + body


def modem_pipeline(device, max_len: int = 256, block: int = 1 << 14):
    tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=max_len), device))
    rx = StreamingReceiver(
        RxConfig(max_payload_len=max_len, max_detections=8, freq_bins=1), device, block=block
    )
    return tx, rx


def run_demo(device, noise: float, count: int, echo=print) -> dict:
    tx, srx = modem_pipeline(device)
    sent = [fake_ip_packet(i) for i in range(count)]
    burst = tx.burst([np.frombuffer(p, np.uint8) for p in sent])
    gen = torch.Generator(device=device).manual_seed(3)
    pkts = srx.process(awgn(burst, noise, gen).cpu().numpy())
    pkts += srx.flush()
    ok = 0
    for p, exp in zip(sorted(pkts, key=lambda p: p.index), sent):
        match = p.data.tobytes() == exp
        ok += match
        echo(f"packet at {p.index}: {len(p.data)} B Es/N0={p.esn0_db:5.1f} dB byte-exact={match}")
    echo(f"demo loopback: {ok}/{count} IP packets through the modem")
    return {"rc": 0 if ok == count else 1, "ok": ok, "sent": sent, "decoded": pkts}


def run_netns(device, noise: float, echo=print) -> dict:
    from ..io.tun import TunDevice

    tx, srx = modem_pipeline(device)
    gen = torch.Generator(device=device).manual_seed(0)
    forwarded = 0
    echo("opening tun0 in pmtx (TX ingress) and pmrx (RX egress)...")
    with TunDevice("tun0", "pmtx") as tun_in, TunDevice("tun0", "pmrx") as tun_out:
        echo("forwarding; ctrl-C to stop (try: sudo ip netns exec pmtx ping 10.9.0.2)")
        try:
            while True:
                pkt = tun_in.read_packet(timeout_ms=100)
                if pkt is None:
                    continue
                burst = tx.burst([np.frombuffer(pkt, np.uint8)])
                for out in srx.process(awgn(burst, noise, gen).cpu().numpy()) + srx.flush():
                    tun_out.write_packet(out.data.tobytes())
                    forwarded += 1
                    echo(f"forwarded {len(out.data)} B (Es/N0 {out.esn0_db:.1f} dB)")
        except KeyboardInterrupt:
            pass
    return {"rc": 0, "forwarded": forwarded}


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """The demo (or, with ``--netns``, the TUN forwarding loop, which needs
    CAP_NET_ADMIN: ``TunDevice`` raises without it). Returns ``rc`` (0 when
    every packet came back byte-exact), and for the demo ``ok``, the
    ``sent`` packets and the ``decoded`` ones (``DecodedPacket``)."""
    args, dev = parse(argv, "tun_loopback", parser())
    t0 = time.time()
    out = run_netns(dev, args.noise, echo) if args.netns else run_demo(dev, args.noise, args.count, echo)
    echo(f"done in {time.time() - t0:.1f} s")
    return out


def main() -> int:
    return run()["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
