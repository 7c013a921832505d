"""Burst -> continuous stream: a constant-rate DAC pull loop that zero-fills
between packets when starved but never inside a packet (port of
examples/packet_to_stream.py; packet_to_stream.hpp:17-45). Runs on the
host; ``--device`` is taken and checked like every example's.

usage: python -m gr4_packet_modem_tpu_torch.examples.packet_to_stream [--device DEV]
"""

from __future__ import annotations

import numpy as np

from ..runtime.streaming import PacketToStream
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the pulled ``stream``, ``zeros_inserted`` and the
    ``packets`` started."""
    parse(argv, "packet_to_stream")
    counts = []
    p2s = PacketToStream(on_packet=counts.append)

    burst_a = np.full(300, 1 + 1j, np.complex64)
    burst_b = np.full(500, 2 + 0j, np.complex64)
    p2s.push(burst_a)

    # the DAC pulls fixed 256-sample chunks regardless of what is queued
    chunks = [p2s.pull(256)]          # 256 of burst_a
    chunks.append(p2s.pull(256))      # 44 of burst_a + zeros (starved between)
    p2s.push(burst_b)
    chunks.append(p2s.pull(256))      # burst_b begins
    stream = np.concatenate(chunks)

    echo(f"pulled {stream.size} samples, {p2s.zeros_inserted} zeros inserted, "
         f"{len(counts)} packets started")
    # burst_a is finished from its own samples before any zeros appear
    check(np.all(stream[:300] == burst_a), "burst_a was cut")
    check(np.all(stream[300:512] == 0), "no zero fill between the packets")
    check(np.all(stream[512:768] == burst_b[:256]), "burst_b does not follow the fill")
    echo("zero-fill only between packets: OK")
    return {"stream": stream, "zeros_inserted": p2s.zeros_inserted, "packets": len(counts)}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
