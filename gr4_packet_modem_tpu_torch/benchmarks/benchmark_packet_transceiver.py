"""Full transceiver benchmark (port of benchmarks/benchmark_packet_transceiver.py;
the reference's benchmark_packet_transceiver.cpp): TX -> ``rotate`` by
0.005 rad/sample -> ``awgn`` at 0.05 -> the one-shot receive, as one step
(``entry.Transceiver``); metric = channel samples/s. On the card every
kernel runs, K4 twice (the Costas payload carrier).

The noise comes from a ``torch.Generator`` seeded 0 before every call
(the JAX program's fixed ``PRNGKey(0)``), so the port matches it in
outcome (``decoded == expected``), not sample by sample.

Baseline: the GR4 reference on a Ryzen 7 5800X CPU, 10-11 Msps at 2
frequency bins in burst mode (results.md:53-66).

usage: python -m gr4_packet_modem_tpu_torch.benchmarks.benchmark_packet_transceiver
       [freq_bins] [batch] [--device DEV]
"""

from __future__ import annotations

import sys

import torch

from ..entry import transceiver_entry
from ..utils.ragged import PacketBatch
from .common import arg, card_fields, parse, report, time_fn

BASELINES = {0: 26e6, 1: 14.5e6, 2: 10.5e6, 3: 10.5e6, 4: 10.5e6}


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Times 10 steps on ``batch`` random 1500-byte packets (seed 0);
    returns the printed record (``decoded`` of ``expected``)."""
    rest, dev = parse(argv, device)
    bins, batch = arg(rest, 0, 4), arg(rest, 1, 24)
    fn, (packets, gen) = transceiver_entry(dev, bins, batch)

    def step(b: PacketBatch, g: torch.Generator) -> torch.Tensor:
        return fn(b, g.manual_seed(0))[0]

    dt, first_s = time_fn(step, packets, gen, iters=10, device=dev)
    acc = int(step(packets, gen))
    return report(
        f"transceiver_{bins}bins_samples_per_sec", fn.total / dt, "samples/s",
        BASELINES.get(bins), echo, decoded=acc, expected=batch, compile_s=round(first_s, 1),
        **card_fields(dev),
    )


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
