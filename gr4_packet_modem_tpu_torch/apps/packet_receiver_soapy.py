"""RX app for SDR hardware via SoapySDR.

Port of apps/packet_receiver_soapy.py (apps/packet_receiver_soapy.cpp:
rtlsdr @ 3.2 Msps -> PacketReceiver -> TUN). Without the SoapySDR python
bindings it prints how to bridge the samples instead and exits with code 2,
as the JAX app does (use packet_receiver_file with a FIFO as the hardware
bridge). ``--tun`` needs root (CAP_NET_ADMIN).

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_receiver_soapy
       [--driver rtlsdr] [--freq HZ] [--rate SPS] [--gain DB] [--tun NAME]
       [--netns NS] [--bins N] [--device DEV]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.receiver import RxConfig
from ..runtime.streaming import StreamingReceiver
from ..utils.device import require_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="packet_receiver_soapy")
    p.add_argument("--driver", default="rtlsdr")
    p.add_argument("--freq", type=float, default=435e6)
    p.add_argument("--rate", type=float, default=3.2e6)
    p.add_argument("--gain", type=float, default=30.0)
    p.add_argument("--tun", default="")
    p.add_argument("--netns", default="")
    p.add_argument("--bins", type=int, default=4)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def run(argv: list[str] | None = None, echo=print) -> dict:
    """Receive from the SDR until interrupted (``SystemExit(2)`` without
    SoapySDR). Returns ``count``, the packets decoded."""
    args = parser().parse_args(argv)
    dev = require_device(args.device)
    try:
        import SoapySDR  # type: ignore
        from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_RX  # type: ignore
    except ImportError:
        echo(
            "SoapySDR python bindings not available in this environment; "
            "bridge hardware samples through a FIFO and use "
            "packet_receiver_file.py instead."
        )
        raise SystemExit(2)

    sdr = SoapySDR.Device({"driver": args.driver})
    sdr.setSampleRate(SOAPY_SDR_RX, 0, args.rate)
    sdr.setFrequency(SOAPY_SDR_RX, 0, args.freq)
    sdr.setGain(SOAPY_SDR_RX, 0, args.gain)
    st = sdr.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32)
    sdr.activateStream(st)

    tun = None
    if args.tun:
        from ..io.tun import TunDevice

        tun = TunDevice(args.tun, args.netns)

    rx = StreamingReceiver(
        RxConfig(max_payload_len=1536, freq_bins=args.bins), dev, block=1 << 17
    )
    buf = np.zeros(1 << 16, np.complex64)
    total = 0
    try:
        while True:
            sr = sdr.readStream(st, [buf], buf.size)
            if sr.ret <= 0:
                continue
            for pkt in rx.process(buf[: sr.ret]):
                total += 1
                if tun is not None:
                    tun.write_packet(pkt.data.tobytes())
                else:
                    echo(f"packet {total}: len={pkt.data.size}")
    except KeyboardInterrupt:
        pass
    finally:
        sdr.deactivateStream(st)
        sdr.closeStream(st)
    return {"count": total}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
