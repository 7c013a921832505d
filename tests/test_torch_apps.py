"""The port's apps (``gr4_packet_modem_tpu_torch/apps/``), driven in this
process through their ``run()`` with ``--device cpu``:

- ``packet_transmitter_pdu`` (burst and stream, 6 x 200 B): the file is
  within 1e-5 of what the JAX app writes (the JAX ``StreamingTransmitter``
  called as the JAX app calls it), and as long;
- ``packet_receiver_file`` on that file: the JAX ``StreamingReceiver``'s
  indices and lengths, the payloads byte-exact;
- ``packet_transceiver`` (``--max-len 256 --seconds 2 --cfo 0.005``, burst
  and stream): every packet sent is received byte-exact, in order;
- ``packet_transmitter_sdr`` in stream mode: idle packets, the expected
  sample count;
- ``packet_transmitter_pdu_throttle.run(seconds=1)``: the reported rate
  within 5 % of the target, on a virtual clock that only the throttle's
  sleeps advance (the app's and ``runtime/flow.py``'s ``time``), so a
  loaded CPU's speed cannot move it; chip_smoke measures the real clock's
  rate on the card;
- ``packet_receiver_soapy`` without SoapySDR: exit code 2;
- ``--device cuda`` without a card raises.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.receiver import RxConfig as JRxConfig  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import Transmitter as JTransmitter  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import TxConfig as JTxConfig  # noqa: E402
from gr4_packet_modem_tpu.runtime.streaming import StreamingReceiver as JStreamingReceiver  # noqa: E402
from gr4_packet_modem_tpu.runtime.streaming import StreamingTransmitter as JStreamingTransmitter  # noqa: E402
from gr4_packet_modem_tpu_torch.apps import (  # noqa: E402
    packet_receiver_file,
    packet_receiver_soapy,
    packet_transceiver,
    packet_transmitter_pdu,
    packet_transmitter_pdu_throttle,
    packet_transmitter_sdr,
    split_device_arg,
)
from gr4_packet_modem_tpu_torch.io.file import read_c64, stream_c64_blocks  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402

LEN, COUNT = 200, 6
RX_ARGS = ["--max-len", "256", "--block", "16384"]


def quiet(*_):
    pass


def _jax_app_samples(stream: bool) -> np.ndarray:
    """What apps/packet_transmitter_pdu.py writes for COUNT x LEN bytes."""
    tx = JStreamingTransmitter(JTransmitter(JTxConfig(max_payload_len=max(LEN, 64), stream_mode=stream)))
    payloads = [(np.arange(LEN) % 256).astype(np.uint8) for _ in range(COUNT)]
    out = []
    for i in range(0, COUNT, 16):
        chunk = payloads[i : i + 16]
        out.append(tx.send_stream(chunk) if stream else tx.send_burst(chunk))
    if stream:
        out.append(tx.flush_stream())
    return np.concatenate(out).astype(np.complex64)


@pytest.fixture(scope="module", params=["burst", "stream"])
def tx_file(request, tmp_path_factory):
    mode = request.param
    path = str(tmp_path_factory.mktemp("apps") / f"{mode}.c64")
    res = packet_transmitter_pdu.run([path, mode, str(LEN), str(COUNT), "--device", "cpu"], echo=quiet)
    return mode, path, res


def test_transmitter_pdu_file_matches_jax_app(tx_file):
    mode, path, res = tx_file
    got = read_c64(path)
    want = _jax_app_samples(mode == "stream")
    assert res["samples"] == got.size == want.size
    assert res["packets"] == COUNT and res["stream"] == (mode == "stream")
    assert np.abs(got - want).max() <= 1e-5


def test_receiver_file_matches_jax_receiver(tx_file):
    mode, path, _ = tx_file
    res = packet_receiver_file.run([path, "--device", "cpu", *RX_ARGS], echo=quiet)
    jrx = JStreamingReceiver(JRxConfig(max_payload_len=256, freq_bins=4, power_threshold=9.5), block=16384)
    jpkts = []
    for block in stream_c64_blocks(path, 16384):
        jpkts += jrx.process(block)
    jpkts += jrx.flush()
    got = [(p.index, p.data.size) for p in res["packets"]]
    assert got == [(p.index, p.data.size) for p in jpkts]
    per = 4 * (C.stream_symbols(LEN) if mode == "stream" else C.burst_symbols(LEN))
    assert [i for i, _ in got] == [k * per for k in range(COUNT)]
    payload = (np.arange(LEN) % 256).astype(np.uint8)
    assert res["count"] == COUNT and all(np.array_equal(p.data, payload) for p in res["packets"])
    assert res["samples"] == os.path.getsize(path) // 8 and res["rate_sps"] > 0


@pytest.mark.parametrize("mode", ["burst", "stream"])
def test_transceiver_loopback(mode):
    argv = ["--device", "cpu", "--max-len", "256", "--seconds", "2", "--cfo", "0.005"]
    res = packet_transceiver.run(argv + (["--stream"] if mode == "stream" else []), echo=quiet)
    assert res["sent"] >= 4 and res["loops"] >= 1
    assert res["received"] == res["sent"] == len(res["sent_payloads"])
    for got, want in zip(res["decoded"], res["sent_payloads"]):
        assert np.array_equal(got.data, want)
    indices = [p.index for p in res["decoded"]]
    assert indices == sorted(indices)
    assert set(res["split_ms"]) == {"tx_channel", "throttle", "rx"}


def test_transmitter_sdr_stream_writes_idle_packets(tmp_path):
    path = str(tmp_path / "sdr.c64")
    res = packet_transmitter_sdr.run([path, "--stream", "--seconds", "0.3", "--device", "cpu"], echo=quiet)
    assert res["sent"] >= 1 and res["types"] == [int(C.PacketType.IDLE)] * res["sent"]
    flush = 4 * (Transmitter(TxConfig(max_payload_len=1536, stream_mode=True), "cpu").arm_len - 1)
    want = res["sent"] * 4 * C.stream_symbols(256) + flush
    assert res["samples"] == want == os.path.getsize(path) // 8


class VirtualClock:
    """``time.monotonic``, ``time.time`` and ``time.sleep`` of a clock
    that only ``sleep`` advances."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    time = monotonic

    def sleep(self, seconds):
        self.now += max(0.0, seconds)


def test_throttle_holds_its_rate(monkeypatch):
    from gr4_packet_modem_tpu_torch.runtime import flow

    clock = VirtualClock()
    monkeypatch.setattr(flow, "time", clock)
    monkeypatch.setattr(packet_transmitter_pdu_throttle, "time", clock)
    rate = 1e6
    res = packet_transmitter_pdu_throttle.run(["burst", str(rate), "--device", "cpu"], seconds=1, echo=quiet)
    # 199,296 samples a call: 6 calls fill the virtual second, a report
    # every second call (ProbeRate waits 0.2 s between reports)
    assert res["samp_rate"] == rate and res["calls"] == 6 and len(res["reports"]) == 2
    assert abs(clock.now - 6 * 199_296 / rate) < 1e-9
    for rep in res["reports"]:
        assert abs(rep.rate_now / rate - 1.0) < 0.05 and abs(rep.rate_avg / rate - 1.0) < 0.05


def test_soapy_without_soapysdr_exits_2():
    try:
        import SoapySDR  # noqa: F401
        pytest.skip("SoapySDR is installed")
    except ImportError:
        pass
    lines = []
    with pytest.raises(SystemExit) as exc:
        packet_receiver_soapy.run(["--device", "cpu"], echo=lines.append)
    assert exc.value.code == 2 and "SoapySDR" in lines[0]


def test_usage_and_device_arguments(tmp_path):
    assert split_device_arg(["x", "--device", "cpu", "stream"]) == (["x", "stream"], "cpu")
    assert split_device_arg(["--device=cuda:1"]) == ([], "cuda:1")
    assert split_device_arg(["x"]) == (["x"], "cuda")
    with pytest.raises(SystemExit) as exc:
        packet_transmitter_pdu.run(["--help"], echo=quiet)
    assert exc.value.code == 0
    with pytest.raises(SystemExit) as exc:
        packet_transmitter_pdu.run([], echo=quiet)
    assert exc.value.code == 1
    if torch.cuda.is_available():
        return
    # the card by default: without one every app raises
    with pytest.raises(RuntimeError, match="cuda"):
        packet_transceiver.run(["--seconds", "0"], echo=quiet)
    with pytest.raises(RuntimeError, match="cuda"):
        packet_transmitter_pdu.run([str(tmp_path / "x.c64")], echo=quiet)
    with pytest.raises(RuntimeError, match="cuda"):
        packet_receiver_file.run([str(tmp_path / "x.c64")], echo=quiet)
