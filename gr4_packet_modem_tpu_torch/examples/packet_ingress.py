"""Ingress validation and packet-type filtering (port of
examples/packet_ingress.py; the reference's packet_ingress.cpp and the
PacketIngress / PacketTypeFilter pair): oversized payloads are refused
before the modulator, and IDLE filler packets are decoded but kept from the
user-data egress by their header type. On CUDA tensors the receive runs all
six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.packet_ingress [--device DEV]
"""

from __future__ import annotations

import numpy as np

from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..runtime.streaming import StreamingReceiver, StreamingTransmitter
from ..utils.constants import PacketType
from . import check, parse

MAX_LEN = 256


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``dropped`` candidates, the ``sent`` payloads and
    ``types``, and the ``decoded`` packets (``DecodedPacket``)."""
    _, dev = parse(argv, "packet_ingress")
    # --- ingress gate: validate payload sizes before they reach the modulator
    candidates = {
        "user-40": np.arange(40, dtype=np.uint8),
        "user-200": (np.arange(200, dtype=np.uint8) * 3).astype(np.uint8),
        "oversized-300": np.zeros(300, np.uint8),  # > MAX_LEN: must be rejected
        "idle-64": np.zeros(64, np.uint8),  # stream filler, tagged IDLE
    }
    accepted, types, dropped = [], [], []
    for name, payload in candidates.items():
        if payload.size > MAX_LEN:
            dropped.append(name)  # packet_ingress.hpp:104 (drop + warn)
            continue
        accepted.append(payload)
        types.append(int(PacketType.IDLE) if name.startswith("idle") else int(PacketType.USER_DATA))
    echo(f"ingress: accepted {len(accepted)}, dropped oversized {dropped}")

    # --- TX -> RX loopback
    tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=MAX_LEN), dev))
    signal = tx.send_burst(accepted, types=types)
    rx = StreamingReceiver(RxConfig(max_payload_len=MAX_LEN, max_detections=8), dev, block=4096)
    decoded = rx.process(signal) + rx.flush()

    # --- egress: the receiver accepts only header-valid, CRC-ok USER_DATA
    # packets, so the idle filler never reaches the host
    for p in decoded:
        echo(f"user packet len={p.data.size} ok={p.data.size in (40, 200)}")
    echo(f"egress: {len(decoded)} user packets "
         f"({len(accepted) - len(decoded)} idle filtered in-device)")
    check(len(decoded) == 2, f"{len(decoded)} user packets, not 2")
    check(all(p.packet_type == int(PacketType.USER_DATA) for p in decoded), "a non-user packet egressed")
    echo("ok")
    return {"dropped": dropped, "sent": accepted, "types": types, "decoded": decoded}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
