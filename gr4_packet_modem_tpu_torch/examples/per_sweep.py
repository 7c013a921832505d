"""PER against Es/N0 of the whole modem, 32 packets of 200 bytes a point
from 5 to 20 dB in steps of 1.5 (port of examples/per_sweep.py). On CUDA
tensors every point's receive runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.per_sweep [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.channel import awgn, esn0_db_to_noise_sigma, rotate
from ..models.receiver import Receiver, RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..utils.ragged import PacketBatch, ragged_concat
from . import parse

NUM = 32
LEN = 200


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns ``rows``: ``(Es/N0 dB, PER)`` for each point."""
    _, dev = parse(argv, "per_sweep")
    tx = Transmitter(TxConfig(max_payload_len=256), dev)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, LEN, dtype=np.uint8) for _ in range(NUM)]
    batch = PacketBatch.from_list(payloads, 256, dev)
    s, lens = tx.modulate_bursts(batch)
    total = int(lens.sum())
    stream, _ = ragged_concat(s, lens, total)
    duty = total / stream.numel()
    sig_power = float(np.mean(np.abs(stream.cpu().numpy()) ** 2)) / duty

    rx = Receiver(RxConfig(max_payload_len=256, max_detections=64), dev)
    echo("Es/N0[dB]  PER")
    rows = []
    for esn0 in np.arange(5.0, 21.0, 1.5):
        sigma = esn0_db_to_noise_sigma(esn0, sig_power)
        gen = torch.Generator(device=dev).manual_seed(int(esn0 * 10))
        res = rx.receive(awgn(rotate(stream, 0.005), sigma, gen))
        acc, lengths, data = (t.cpu().numpy() for t in (res.accepted, res.lengths, res.data))
        good = sum(
            1
            for i in np.nonzero(acc)[0]
            for p in payloads
            if lengths[i] == p.size and np.array_equal(data[i, : p.size], p)
        )
        rows.append((float(esn0), 1.0 - good / NUM))
        echo(f"{esn0:8.1f}  {1.0 - good / NUM:.3f}")
    return {"rows": rows}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
