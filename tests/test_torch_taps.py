"""The port's symbol taps (``StreamingReceiver(header_tap=, payload_tap=)``)
against the JAX package's, and its ZMQ publisher end to end.

Both drivers get the same samples and list sinks: the same number of
messages must come out, in the same order and with the same lengths
(128 header symbols; ``4*(len+4)`` payload symbols a packet), complex64,
with the symbols within 1e-4 (the tolerance of the receivers' float32
sums). The PUB/SUB run mirrors tests/test_zmq_tap.py on ports of its own
(15810/15811, so it can run beside that test under xdist) and is skipped
without pyzmq. Bursts come from the port's transmitter.
"""

import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.runtime import streaming as jstreaming  # noqa: E402
from gr4_packet_modem_tpu_torch.io.zmq_pub import ZmqPduPubSink, have_zmq  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingReceiver, StreamingTransmitter  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from plot_symbols import mer_db  # noqa: E402

CFG = dict(max_payload_len=256, max_detections=8)
BLOCK = 4096


class ListSink:
    def __init__(self):
        self.msgs = []

    def send(self, pdu):
        self.msgs.append(np.asarray(pdu))


def _signal(lengths, cfo=0.0, noise=0.0, seed=0):
    tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256), "cpu"))
    payloads = [((np.arange(n) + n) % 256).astype(np.uint8) for n in lengths]
    x = tx.send_burst(payloads)
    rng = np.random.default_rng(seed)
    x = x * np.exp(1j * cfo * np.arange(x.size))
    x = x + noise * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return payloads, x.astype(np.complex64)


def _run(cls, x, **kw):
    sinks = {k: ListSink() for k in kw}
    rx = cls(**{k: sinks[k] for k in kw})
    pkts = rx.process(x) + rx.flush()
    return rx, pkts, {k: s.msgs for k, s in sinks.items()}


@pytest.mark.parametrize("taps", [("header_tap", "payload_tap"), ("header_tap",), ("payload_tap",)])
def test_taps_match_jax(taps):
    """Four packets over several blocks, CFO and noise; both taps and each
    alone."""
    payloads, x = _signal([100, 200, 37, 256], cfo=0.003, noise=0.03, seed=1)
    kw = dict.fromkeys(taps)

    def port(**sinks):
        return StreamingReceiver(RxConfig(**CFG), "cpu", block=BLOCK, **sinks)

    def jax(**sinks):
        return jstreaming.StreamingReceiver(JConfig(**CFG), block=BLOCK, **sinks)

    rx, got, got_msgs = _run(port, x, **kw)
    _, want, want_msgs = _run(jax, x, **kw)
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]
    assert [p.index for p in got] == [p.index for p in want]
    assert rx.rx.config.keep_payload_symbols == ("payload_tap" in taps)
    for name in taps:
        g, w = got_msgs[name], want_msgs[name]
        assert [m.size for m in g] == [m.size for m in w]
        want_sizes = [128] * 4 if name == "header_tap" else [4 * (len(p) + 4) for p in payloads]
        assert [m.size for m in g] == want_sizes
        for a, b in zip(g, w):
            assert a.dtype == np.complex64
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_no_tap_keeps_no_symbols():
    """Without a tap the step returns no symbols and the payload symbols
    are not kept."""
    payloads, x = _signal([64, 90])
    rx = StreamingReceiver(RxConfig(**CFG), "cpu", block=BLOCK)
    steps = []
    step = rx._step
    rx._step = lambda planes: steps.append(step(planes)) or steps[-1]
    got = rx.process(x) + rx.flush()
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]
    assert steps and all(syms is None for _, syms in steps)
    assert not rx.rx.config.keep_payload_symbols


def test_taps_clean_channel_mer():
    """On a clean channel every message has MER above 20 dB
    (tests/test_zmq_tap.py's gate)."""
    payloads, x = _signal([100, 200])
    _, got, msgs = _run(
        lambda **s: StreamingReceiver(RxConfig(**CFG), "cpu", block=BLOCK, **s), x,
        header_tap=None, payload_tap=None,
    )
    assert len(got) == 2
    for m in msgs["header_tap"] + msgs["payload_tap"]:
        assert mer_db(m) > 20.0


@pytest.mark.skipif(not have_zmq(), reason="pyzmq not available")
def test_zmq_symbol_taps_end_to_end():
    import zmq

    hdr_port, pay_port = 15810, 15811
    header_tap = ZmqPduPubSink(f"tcp://127.0.0.1:{hdr_port}")
    payload_tap = ZmqPduPubSink(f"tcp://127.0.0.1:{pay_port}")
    ctx = zmq.Context.instance()
    subs = []
    for port in (hdr_port, pay_port):
        s = ctx.socket(zmq.SUB)
        s.connect(f"tcp://127.0.0.1:{port}")
        s.setsockopt(zmq.SUBSCRIBE, b"")
        s.setsockopt(zmq.RCVTIMEO, 5000)
        subs.append(s)
    time.sleep(0.2)  # PUB/SUB join latency
    try:
        payloads, x = _signal([100, 200])
        rx = StreamingReceiver(
            RxConfig(**CFG), "cpu", block=BLOCK, header_tap=header_tap, payload_tap=payload_tap
        )
        got = rx.process(x) + rx.flush()
        assert len(got) == len(payloads)
        for sub, expect_lens in zip(subs, ([128, 128], [4 * (100 + 4), 4 * (200 + 4)])):
            for expect_len in expect_lens:
                syms = np.frombuffer(sub.recv(), np.complex64)
                assert syms.size == expect_len
                assert mer_db(syms) > 20.0
    finally:
        for s in subs:
            s.close(0)
        header_tap.close()
        payload_tap.close()
