"""Minimal end-to-end loopback: TX -> channel -> RX, print the decoded
payloads (port of examples/loopback.py). On CUDA tensors the receive runs
all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.loopback [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.channel import awgn, rotate
from ..models.receiver import Receiver, RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..utils.ragged import PacketBatch, ragged_concat
from . import parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns ``sent`` and ``decoded`` (payload bytes, in the receiver's
    row order)."""
    _, dev = parse(argv, "loopback")
    payloads = [np.frombuffer(s, np.uint8) for s in (b"hello", b"tpu packet modem")]

    tx = Transmitter(TxConfig(max_payload_len=64), dev)
    batch = PacketBatch.from_list(payloads, 64, dev)
    samples, lens = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(samples, lens, int(lens.sum()))

    gen = torch.Generator(device=dev).manual_seed(0)
    x = awgn(rotate(stream, 0.006), 0.05, gen)

    rx = Receiver(RxConfig(max_payload_len=64, max_detections=8), dev)
    res = rx.receive(x)
    acc, lengths, data = (t.cpu().numpy() for t in (res.accepted, res.lengths, res.data))
    decoded = []
    for i in np.nonzero(acc)[0]:
        decoded.append(bytes(data[i, : lengths[i]]))
        echo(f"decoded: {decoded[-1]}")
    return {"sent": [p.tobytes() for p in payloads], "decoded": decoded}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
