"""Receiver-bank scaling benchmark (port of benchmarks/benchmark_bank_scaling.py;
BASELINE config #5: a channel bank sharded over channels and time):
``parallel/multihost.measure_scaling`` at 1, 2, 4 and all ranks of the
process group; samples/s per card and scaling efficiency. On the card every
kernel runs (the bank's receiver: fused acquisition, Costas carrier).

The process group is the one set up already, or one started from
``PM_COORDINATOR`` / ``PM_NUM_PROCESSES`` / ``PM_PROCESS_ID`` (every
process runs this program), or a world of one started here and destroyed
at the end: one card reports the per-card rate only, as the JAX program
does on one device.

usage: python -m gr4_packet_modem_tpu_torch.benchmarks.benchmark_bank_scaling
       [channels_per_device] [block_log2] [--device DEV]
"""

from __future__ import annotations

import json
import sys

from ..models.receiver import RxConfig
from ..parallel import multihost
from .common import arg, card_fields, parse, process_group, tiled_burst_signal


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Returns ``{"records": [...]}`` on rank 0 (one dict a device count,
    floats rounded to 4 places, each printed as a JSON line), an empty
    list on the other ranks."""
    rest, dev = parse(argv, device)
    ch_per_dev, block = arg(rest, 0, 8), 1 << arg(rest, 1, 17)
    with process_group(dev):
        sig, _ = tiled_burst_signal(total=block, max_payload_len=256, payload_len=200, device=dev)
        results = multihost.measure_scaling(
            sig, device_counts=(1, 2, 4, None), channels_per_device=ch_per_dev,
            rx_config=RxConfig(max_payload_len=256, max_detections=16), device_type=dev.type,
        )
    records = [
        {**{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}, **card_fields(dev)}
        for r in results or ()
    ]
    if echo:
        for r in records:
            print(json.dumps(r), flush=True)
    return {"records": records}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
