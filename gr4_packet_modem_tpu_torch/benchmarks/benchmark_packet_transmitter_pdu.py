"""TX pipeline benchmark (port of benchmarks/benchmark_packet_transmitter_pdu.py;
the reference's benchmark_packet_transmitter_pdu.cpp): continuous 1500-byte
packets, 4 samples a symbol; metric = output samples/s. The transmitter
launches none of the receive kernels.

Baseline: the GR4 reference on a Ryzen 7 5800X CPU, 156-167 Msps burst /
65-72 Msps stream (results.md:28-31).

usage: python -m gr4_packet_modem_tpu_torch.benchmarks.benchmark_packet_transmitter_pdu
       [stream|burst] [batch] [--device DEV]
"""

from __future__ import annotations

import sys

from ..entry import TX_PAYLOAD_LEN, tx_entry
from ..utils import constants as C
from .common import arg, card_fields, parse, report, time_fn

BASELINES = {"burst": 160e6, "stream": 68e6}  # results.md:28-31 midpoints


def tx_step(mode: str, batch: int, device):
    """``(fn, packets, samples_per_call)``: ``entry.tx_entry``'s transmitter
    in ``mode`` ("burst" or "stream") on ``batch`` random 1500-byte packets
    (seed 0), and the output samples one call counts."""
    fn, (packets,) = tx_entry(device, stream=mode == "stream", batch=batch)
    syms = C.stream_symbols(TX_PAYLOAD_LEN) if mode == "stream" else C.burst_symbols(TX_PAYLOAD_LEN)
    return fn, packets, batch * syms * 4


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Times 20 calls of the transmitter; returns the printed record."""
    rest, dev = parse(argv, device)
    mode = "stream" if arg(rest, 0, "burst") == "stream" else "burst"
    batch = arg(rest, 1, 64)
    fn, packets, samples_per_call = tx_step(mode, batch, dev)
    dt, first_s = time_fn(fn, packets, iters=20, device=dev)
    return report(
        f"tx_{mode}_samples_per_sec", samples_per_call / dt, "samples/s", BASELINES[mode], echo,
        batch=batch, compile_s=round(first_s, 1), **card_fields(dev),
    )


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
