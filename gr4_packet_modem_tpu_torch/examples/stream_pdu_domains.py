"""PDU <-> stream domain conversion (port of examples/stream_pdu_domains.py;
the reference's pdu_to_tagged_stream.cpp, tagged_stream_to_pdu.cpp and
pdu_specialization.cpp): the Pdu domain is a :class:`PacketBatch`, the
tagged-stream domain a flat item array plus its lengths, PduToTaggedStream
is :func:`ragged_concat`, and TaggedStreamToPdu slices the flat stream back
by the lengths (StreamToPdu's fixed-size chop is a reshape). The round trip
is exact.

usage: python -m gr4_packet_modem_tpu_torch.examples.stream_pdu_domains [--device DEV]
"""

from __future__ import annotations

import numpy as np

from ..utils.ragged import PacketBatch, ragged_concat
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the flat ``stream``, the ``round_trip`` packets and the
    count of ``fixed`` 15-item PDUs."""
    _, dev = parse(argv, "stream_pdu_domains")
    # --- Pdu domain: a ragged batch of byte packets
    payloads = [
        np.arange(10, dtype=np.uint8),
        np.arange(50, 80, dtype=np.uint8),
        np.full(5, 0xAB, np.uint8),
    ]
    batch = PacketBatch.from_list(payloads, 32, dev)
    lengths = batch.lengths.cpu().numpy()
    echo(f"pdu domain: B={batch.batch} max_len={batch.max_len} lengths={lengths.tolist()}")

    # --- PduToTaggedStream: concatenate valid bytes; lengths ARE the tags
    total = int(lengths.sum())
    stream, n = ragged_concat(batch.data, batch.lengths, total)
    stream = stream.cpu().numpy()[: int(n)]
    echo(f"tagged-stream domain: {stream.size} items, len 'tags' {lengths.tolist()}")

    # --- TaggedStreamToPdu: chop the flat stream back by the length metadata
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    round_trip = [stream[o : o + ln] for o, ln in zip(offsets, lengths)]
    check(all(np.array_equal(a, b) for a, b in zip(round_trip, payloads)), "round trip differs")
    echo("round trip Pdu -> stream -> Pdu: exact")

    # --- StreamToPdu: the fixed-size chop (stream_to_pdu.hpp) is a reshape
    fixed = stream[: (stream.size // 15) * 15].reshape(-1, 15)
    echo(f"StreamToPdu(15): {fixed.shape[0]} fixed-size PDUs of 15 items")
    echo("ok")
    return {"stream": stream, "round_trip": round_trip, "fixed": fixed.shape[0]}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
