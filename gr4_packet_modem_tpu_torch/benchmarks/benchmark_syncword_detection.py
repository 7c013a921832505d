"""Syncword detection benchmark (port of benchmarks/benchmark_syncword_detection.py;
the reference's benchmark_syncword_detection.cpp): the acquisition block
alone on a continuous stream; metric = samples/s. The backend is any of
the JAX program's (``fft``, ``fused``, ``fused_bf16``, ``conv``,
``conv_bf16``; ``auto``). On the card every backend launches the region
and row fetches (K2, K2b); ``fused`` the correlator (K1) too, and
``fused_bf16`` K1's bf16 form.

Baseline: the GR4 reference on a Ryzen 7 5800X CPU, 49-51 / 29 / 20-21 /
16 / 13 Msps at 0/1/2/3/4 frequency bins (results.md:35-41).

usage: python -m gr4_packet_modem_tpu_torch.benchmarks.benchmark_syncword_detection
       [freq_bins] [backend] [block_log2] [--device DEV]
"""

from __future__ import annotations

import sys

import torch

from ..ops.acquire import AcquisitionConfig, SyncwordAcquirer
from .common import arg, card_fields, parse, report, tiled_burst_signal, time_fn

BASELINES = {0: 50e6, 1: 29e6, 2: 20.5e6, 3: 16e6, 4: 13e6}


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Times 20 acquisitions of one block; returns the printed record."""
    rest, dev = parse(argv, device)
    bins, backend, block = arg(rest, 0, 4), arg(rest, 1, "fft"), 1 << arg(rest, 2, 18)
    acq = SyncwordAcquirer(AcquisitionConfig(freq_bins=bins, backend=backend, max_detections=32), dev)
    sig, _ = tiled_burst_signal(total=block, device=dev)
    x = torch.from_numpy(sig).to(dev)
    dt, first_s = time_fn(acq.acquire, x, iters=20, device=dev)
    return report(
        f"syncword_detection_{bins}bins_samples_per_sec", block / dt, "samples/s",
        BASELINES.get(bins), echo, backend=backend, block=block, compile_s=round(first_s, 1),
        **card_fields(dev),
    )


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
