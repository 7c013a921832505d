"""Full RX chain benchmark (port of benchmarks/benchmark_packet_receiver.py;
the reference's benchmark_packet_receiver.cpp fed a fully loaded packet
stream instead of an idle one): a bank of channels acquired as one batch,
then ``Receiver.decode_bank``; metric = samples/s. On the card every
kernel runs (K1, K2, K2b, K3, K4 twice: the Costas payload carrier is the
``RxConfig`` default; K5).

Baseline: the GR4 reference on a Ryzen 7 5800X CPU, 6-8 Msps at 4
frequency bins (results.md:43-51).

usage: python -m gr4_packet_modem_tpu_torch.benchmarks.benchmark_packet_receiver
       [freq_bins] [channels] [block_log2] [--device DEV]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models.receiver import Receiver, RxConfig
from .common import arg, card_fields, parse, report, tiled_burst_signal, time_fn

BASELINES = {0: 30e6, 1: 17e6, 2: 11.5e6, 3: 9e6, 4: 7e6}


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Times 10 bank steps; returns the printed record, whose
    ``decoded_frac`` counts accepted packets over the complete bursts of
    every channel."""
    rest, dev = parse(argv, device)
    bins, channels, block = arg(rest, 0, 4), arg(rest, 1, 8), 1 << arg(rest, 2, 18)
    rx = Receiver(RxConfig(max_payload_len=1536, max_detections=32, freq_bins=bins), dev)
    sig, pkts = tiled_burst_signal(total=block, device=dev)
    fp = rx.front_pad
    x = np.zeros((channels, fp + block + rx.pad_tail()), np.complex64)
    x[:, fp : fp + block] = sig
    x = torch.from_numpy(x).to(dev)

    def step(samples: torch.Tensor) -> torch.Tensor:
        _, _, res, _ = rx.decode_bank(samples, rx.acquirer.acquire(samples))
        return res.accepted.sum()

    dt, first_s = time_fn(step, x, iters=10, device=dev)
    acc = int(step(x))
    return report(
        f"rx_chain_{bins}bins_samples_per_sec", channels * block / dt, "samples/s",
        BASELINES.get(bins), echo, channels=channels, block=block,
        decoded_frac=round(acc / (pkts * channels), 3), compile_s=round(first_s, 1),
        **card_fields(dev),
    )


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
