"""ZeroMQ PDU publisher for live monitoring.

The port's own copy of ``gr4_packet_modem_tpu/io/zmq_pub.py``, kept equal
to it in behaviour (tests/test_torch_standalone.py checks that).
Equivalent of ZmqPduPubSink (zmq_pdu_pub_sink.hpp): publishes each packet's
raw payload on a PUB socket; used by the live constellation/MER plot
(reference scripts/plot_symbols.py, ports 5000/5001). Gated on pyzmq
availability: without it the module still imports and ``have_zmq()`` is
False.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ZmqPduPubSink", "have_zmq"]

try:
    import zmq  # type: ignore

    _ZMQ = True
except Exception:  # pragma: no cover
    zmq = None
    _ZMQ = False


def have_zmq() -> bool:
    return _ZMQ


class ZmqPduPubSink:
    """PUB-socket packet publisher (one message per PDU, raw bytes)."""

    def __init__(self, endpoint: str = "tcp://*:5000"):
        if not _ZMQ:
            raise RuntimeError("pyzmq not available")
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.bind(endpoint)

    def send(self, pdu: np.ndarray) -> None:
        self._sock.send(np.ascontiguousarray(pdu).tobytes())

    def close(self):
        self._sock.close(0)
