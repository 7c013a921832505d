"""The smallest pipeline: vector source -> scramble -> descramble -> sink
(port of examples/minimal_flowgraph.py; the reference's
minimal_flowgraph.cpp). The blocks are resolved by their reference names
through the port's registry.

usage: python -m gr4_packet_modem_tpu_torch.examples.minimal_flowgraph [--device DEV]
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..ops.packing import bytes_to_bits, pack_bits
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``lines`` printed (the packets after the round trip)."""
    _, dev = parse(argv, "minimal_flowgraph")
    vector_source = registry.resolve("VectorSource")  # PacketBatch.from_list
    scramble = registry.resolve("AdditiveScrambler").scramble_bits

    batch = vector_source([np.frombuffer(b"hello gr4", np.uint8),
                           np.frombuffer(b"tpu modem", np.uint8)], None, dev)
    bits = bytes_to_bits(batch.data)
    once = scramble(bits)
    twice = scramble(once)  # the CCSDS additive scrambler is an involution
    out = pack_bits(twice, 8).cpu().numpy().astype(np.uint8)
    lines = [bytes(row[:n]).decode() for row, n in zip(out, batch.lengths.cpu().numpy())]
    for line in lines:
        echo(line)
    check(bytes(out[0][:9]) == b"hello gr4", f"row 0 {bytes(out[0][:9])!r}")
    return {"lines": lines}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
