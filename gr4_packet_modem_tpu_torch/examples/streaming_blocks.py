"""Streaming decode with the block-pipelined receiver driver (port of
examples/streaming_blocks.py; the intent of the reference's
stop_flowgraph.cpp and vector_{source,sink}.cpp): a ``StreamingReceiver``
fed an in-memory stream in odd-sized chunks, to show the overlap carry, the
depth-2 block pipeline and ``flush()`` draining the tail. On CUDA tensors
the receive runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.streaming_blocks [--device DEV]
"""

from __future__ import annotations

import numpy as np

from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.streaming import StreamingReceiver, StreamingTransmitter
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``sent`` payloads and the ``decoded`` packets
    (``DecodedPacket``)."""
    _, dev = parse(argv, "streaming_blocks")
    tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256), dev))
    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in (40, 100, 256, 77)]
    signal = tx.send_burst(payloads)

    rx = StreamingReceiver(RxConfig(max_payload_len=256, max_detections=8), dev, block=4096)
    decoded = []
    for i in range(0, signal.size, 2500):  # odd chunks exercise the carry
        decoded += rx.process(signal[i : i + 2500])
    decoded += rx.flush()

    sizes = [p.size for p in payloads]
    for pkt in decoded:
        echo(f"packet len={pkt.data.size:4d} at sample {pkt.index:6d} "
             f"Es/N0={pkt.esn0_db:5.1f} dB  ok={pkt.data.size in sizes}")
    check(len(decoded) == len(payloads), f"decoded {len(decoded)} of {len(payloads)} packets")
    echo(f"decoded {len(decoded)}/{len(payloads)} packets")
    return {"sent": payloads, "decoded": decoded}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
