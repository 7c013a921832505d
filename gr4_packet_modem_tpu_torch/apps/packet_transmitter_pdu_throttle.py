"""TX benchmark app: transmitter -> throttle -> rate probe.

Port of apps/packet_transmitter_pdu_throttle.py
(apps/packet_transmitter_pdu_throttle.cpp): continuous 1500-byte packets,
8 a call, modulated and throttled to the target sample rate, with the
achieved rate printed periodically, for 10 s.

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_transmitter_pdu_throttle
       [stream|burst] [samp_rate] [--device DEV]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..models.transmitter import Transmitter, TxConfig
from ..runtime.flow import ProbeRate, Throttle
from ..runtime.streaming import StreamingTransmitter
from ..utils.device import require_device
from . import split_device_arg


def run(argv: list[str] | None = None, seconds: float = 10.0, echo=print) -> dict:
    """Transmit for ``seconds``. Returns ``samp_rate`` (the target),
    ``reports`` (``RateReport`` list), ``samples`` and ``calls``."""
    args, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    if args[:1] in (["-h"], ["--help"]):
        echo(__doc__)
        raise SystemExit(0)
    stream_mode = (args[0] if args else "burst") == "stream"
    samp_rate = float(args[1]) if len(args) > 1 else 3.2e6
    dev = require_device(device)

    tx = StreamingTransmitter(
        Transmitter(TxConfig(max_payload_len=1536, stream_mode=stream_mode), dev)
    )
    throttle = Throttle(samp_rate)
    probe = ProbeRate()
    payloads = [(np.arange(1500) % 256).astype(np.uint8) for _ in range(8)]
    reports, samples, calls = [], 0, 0
    t_end = time.time() + seconds
    while time.time() < t_end:
        sig = tx.send_stream(payloads) if stream_mode else tx.send_burst(payloads)
        throttle.wait(sig.size)
        samples += sig.size
        calls += 1
        rep = probe.update(sig.size)
        if rep is not None:
            reports.append(rep)
            echo(
                f"rate_now = {rep.rate_now / 1e6:.3f} Msps, "
                f"rate_avg = {rep.rate_avg / 1e6:.3f} Msps"
            )
    return {"samp_rate": samp_rate, "reports": reports, "samples": samples, "calls": calls}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
