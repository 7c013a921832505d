"""TX -> channel -> RX loopback on the port alone, byte for byte.

The oracle of tests/test_loopback.py (the reference's qa_loopback): the
14 packets of 10..1500 bytes go through the port's transmitter (burst and
stream mode), the port's ``rotate`` and ``awgn`` (noise 0.05 a component,
qa_loopback.cpp:66) and the port's ``Receiver.receive``, which must
decode every packet byte-exact, for CFO 0, +0.006 and -0.02 rad/sample;
also the transceiver's operating point (SFO 1.2 ppm, CFO 0.005), IDLE
packets filtered by type, the JAX transmitter's stream into the port's
receiver, and the transceiver entry point. Samples stay tensors from the
transmitter to the receiver.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.transmitter import Transmitter as JTransmitter  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import TxConfig as JTxConfig  # noqa: E402
from gr4_packet_modem_tpu.utils.ragged import PacketBatch as JBatch  # noqa: E402
from gr4_packet_modem_tpu_torch.entry import transceiver_entry  # noqa: E402
from gr4_packet_modem_tpu_torch.models.channel import awgn, rotate, sfo  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat  # noqa: E402

LENGTHS = [10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34]
PAYLOADS = [(np.arange(n) % 256).astype(np.uint8) for n in LENGTHS]
NOISE_AMPLITUDE = 0.05  # qa_loopback.cpp:66


def _tx_burst(payloads, max_len, types=None):
    tx = Transmitter(TxConfig(max_payload_len=max_len), "cpu")
    samples, lens = tx.modulate_bursts(PacketBatch.from_list(payloads, max_len, "cpu", types=types))
    return ragged_concat(samples, lens, int(lens.sum()))[0]


def _tx_stream(payloads, max_len):
    tx = Transmitter(TxConfig(max_payload_len=max_len, stream_mode=True), "cpu")
    out_syms = sum(C.stream_symbols(len(p)) for p in payloads) + 16  # FIR flush
    return tx.modulate_stream(PacketBatch.from_list(payloads, max_len, "cpu"), out_syms)[1]


@pytest.fixture(scope="module")
def streams():
    return {"burst": _tx_burst(PAYLOADS, 1536), "stream": _tx_stream(PAYLOADS, 1536)}


@pytest.fixture(scope="module")
def rx():
    return Receiver(RxConfig(max_payload_len=1536, max_detections=32), "cpu")


def _decoded(res):
    acc, lens, data = (t.numpy() for t in (res.accepted, res.lengths, res.data))
    return [data[i, : lens[i]] for i in np.nonzero(acc)[0]]


def _assert_all(res, payloads):
    got = _decoded(res)
    assert len(got) == len(payloads), f"decoded {len(got)}/{len(payloads)}"
    for g, e in zip(got, payloads):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("mode", ["burst", "stream"])
@pytest.mark.parametrize("cfo", [0.0, 0.006, -0.02])
def test_loopback(streams, rx, mode, cfo):
    g = torch.Generator().manual_seed(1 + int(1000 * abs(cfo)))
    x = awgn(rotate(streams[mode], cfo), NOISE_AMPLITUDE, g)
    _assert_all(rx.receive(x), PAYLOADS)


def test_loopback_transceiver_operating_point(streams, rx):
    """SFO 1.2 ppm, CFO 0.005, noise 0.05, burst mode
    (tests/test_loopback.py:77)."""
    x = awgn(rotate(sfo(streams["burst"], 1.2), 0.005), NOISE_AMPLITUDE, torch.Generator().manual_seed(4))
    _assert_all(rx.receive(x), PAYLOADS)


def test_idle_packets_filtered():
    """IDLE packets decode and pass the CRC but the type filter drops them
    (packet_type_filter.hpp)."""
    payloads = [PAYLOADS[0], np.zeros(256, np.uint8), PAYLOADS[1]]
    stream = _tx_burst(payloads, 512, types=[0, int(C.PacketType.IDLE), 0])
    x = awgn(stream, NOISE_AMPLITUDE, torch.Generator().manual_seed(5))
    res = Receiver(RxConfig(max_payload_len=512, max_detections=16), "cpu").receive(x)
    _assert_all(res, [payloads[0], payloads[2]])
    assert int(res.crc_ok.sum()) == 3


def test_jax_stream_into_port_receiver(rx):
    """The JAX transmitter's stream, impaired by the port's channel, decodes
    in the port's receiver; numpy and tensor input give the same result."""
    jtx = JTransmitter(JTxConfig(max_payload_len=1536, stream_mode=True))
    out_syms = sum(C.stream_symbols(len(p)) for p in PAYLOADS) + 16
    _, stream, _ = jtx.modulate_stream(JBatch.from_list(PAYLOADS, max_len=1536), out_syms)
    x = awgn(rotate(torch.tensor(np.asarray(stream)), 0.006), NOISE_AMPLITUDE,
             torch.Generator().manual_seed(6))
    res = rx.receive(x)
    _assert_all(res, PAYLOADS)
    again = rx.receive(x.numpy())
    assert torch.equal(res.accepted, again.accepted) and torch.equal(res.data, again.data)


def test_receive_rejects_samples_on_another_device(rx):
    with pytest.raises(ValueError, match="samples on meta, the receiver on cpu"):
        rx.pad(torch.zeros(10, dtype=torch.complex64, device="meta"))


def test_transceiver_entry_decodes_every_packet():
    fn, (packets, gen) = transceiver_entry("cpu", bins=4, batch=4)
    n, res = fn(packets, gen)
    assert int(n) == 4
    _assert_all(res, packets.to_list())
    assert fn.transmit(packets).numel() == 4 * 24912
