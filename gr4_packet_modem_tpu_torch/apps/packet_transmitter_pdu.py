"""TX-only app: modulate packets and write IQ samples to a file.

Port of apps/packet_transmitter_pdu.py (apps/packet_transmitter_pdu.cpp):
fixed-size packets through the PDU transmitter, 16 a call, samples written
as raw complex64 (GR 'complex' format).

usage: python -m gr4_packet_modem_tpu_torch.apps.packet_transmitter_pdu
       OUT_FILE [stream|burst] [packet_len] [count] [--device DEV]
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.file import FileSinkC64
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.streaming import StreamingTransmitter
from ..utils.device import require_device
from . import split_device_arg

BATCH = 16  # packets a transmitter call


def run(argv: list[str] | None = None, echo=print) -> dict:
    """Write ``count`` packets of ``packet_len`` bytes (``i % 256``) to
    OUT_FILE. Returns ``path``, ``stream``, ``packets``, ``packet_len``,
    ``payloads`` and ``samples`` (written, the stream-mode flush
    included)."""
    args, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    # positional parsing as the reference apps; -h prints the usage, and an
    # option-looking output path is refused
    if not args or args[0].startswith("-"):
        echo(__doc__)
        raise SystemExit(0 if args[:1] in (["-h"], ["--help"]) else 1)
    out_file = args[0]
    stream_mode = (args[1] if len(args) > 1 else "burst") == "stream"
    packet_len = int(args[2]) if len(args) > 2 else 1500
    count = int(args[3]) if len(args) > 3 else 100
    dev = require_device(device)

    tx = StreamingTransmitter(
        Transmitter(TxConfig(max_payload_len=max(packet_len, 64), stream_mode=stream_mode), dev)
    )
    payloads = [(np.arange(packet_len) % 256).astype(np.uint8) for _ in range(count)]
    samples = 0
    with FileSinkC64(out_file) as sink:
        for i in range(0, count, BATCH):
            chunk = payloads[i : i + BATCH]
            sig = tx.send_stream(chunk) if stream_mode else tx.send_burst(chunk)
            sink.write(sig)
            samples += sig.size
        if stream_mode:
            # a finite stream must flush the interpolator history or the
            # last packet's tail samples never leave the filter
            tail = tx.flush_stream()
            sink.write(tail)
            samples += tail.size
    echo(f"wrote {count} packets of {packet_len} bytes to {out_file}")
    return {"path": out_file, "stream": stream_mode, "packets": count,
            "packet_len": packet_len, "payloads": payloads, "samples": samples}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
