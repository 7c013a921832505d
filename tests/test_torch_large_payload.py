"""The u16 payload envelope on the port against the JAX receiver.

tests/test_large_payload.py's cases (the reference's hard limit of 65,535
bytes, packet_ingress.hpp:104): a 16 KiB and a 5,000-byte payload with
both payload carriers, and one 65,535-byte payload with the V&V carrier.
262,156 payload symbols run the chunked extraction (2048-symbol chunks,
129 of them). The waveform comes from the JAX transmitter, the CFO and
the noise from numpy with a seed, and the same samples go through the JAX
receiver (``use_pallas=False``, fft acquisition) and the port's receiver
computing from the JAX receiver's tables: accepted flags, lengths and
bytes must be equal, and equal to the payloads. The 65,535-byte Costas
case runs on the card only (tests/test_torch_cuda.py): the plain Costas
loop issues about 20 small operations a symbol. The port's transmitter at
65,535 bytes is held against the JAX transmitter: symbols exact, samples
within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import Transmitter as JTransmitter  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import TxConfig as JTxConfig  # noqa: E402
from gr4_packet_modem_tpu.ops import ldpc as jldpc  # noqa: E402
from gr4_packet_modem_tpu.utils import ragged as jragged  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import (  # noqa: E402
    TX_JAX_ATTRIBUTES, numpy_tables_of, tables_from_numpy,
)
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch  # noqa: E402

U16_MAX = 65535
CASES = {  # tests/test_large_payload.py's configurations
    "u16_16k": dict(lengths=(16384, 5000), seed=7, max_len=16384, detections=4, bins=4,
                    cfo=0.002, noise=0.05, chunks=33),
    "u16_max": dict(lengths=(U16_MAX,), seed=11, max_len=U16_MAX, detections=2, bins=1,
                    cfo=0.001, noise=0.02, chunks=129),
}


def _payloads(case):
    rng = np.random.default_rng(case["seed"])
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in case["lengths"]]


def _signal(case, payloads):
    """JAX burst-mode waveform, rotated by ``cfo`` a sample, with complex
    Gaussian noise of ``noise`` a component from numpy."""
    tx = JTransmitter(JTxConfig(max_payload_len=case["max_len"]))
    s, n = tx.modulate_bursts(jragged.PacketBatch.from_list(payloads, max_len=case["max_len"]))
    stream = np.asarray(jragged.ragged_concat(s, n, int(np.asarray(n).sum()))[0])
    rng = np.random.default_rng(case["seed"] + 100)
    x = stream * np.exp(1j * case["cfo"] * np.arange(stream.size))
    x = x + case["noise"] * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def signals():
    out = {}
    for name, case in CASES.items():
        payloads = _payloads(case)
        out[name] = payloads, _signal(case, payloads)
    return out


def _decoded(res):
    acc = np.asarray(res.accepted)
    return acc, np.asarray(res.lengths), np.asarray(res.data)


@pytest.mark.parametrize("name,carrier", [("u16_16k", "vv"), ("u16_16k", "costas"), ("u16_max", "vv")])
def test_envelope_matches_jax(signals, name, carrier):
    case = CASES[name]
    payloads, x = signals[name]
    kw = dict(max_payload_len=case["max_len"], max_detections=case["detections"],
              freq_bins=case["bins"], payload_carrier=carrier, acquisition_backend="fft")
    jrx = JReceiver(JConfig(**kw, use_pallas=False))
    rx = Receiver(RxConfig(**kw), "cpu")
    rx.load_tables(tables_from_numpy(numpy_tables_of(jrx)))
    # 2048-symbol chunks: 33 for 16 KiB (65,552 symbols), 129 for 65,535 B
    assert rx._extraction_chunks(rx.config.max_payload_syms) == (2048, case["chunks"])
    want_acc, want_lens, want_data = _decoded(jrx.receive(x))
    got_acc, got_lens, got_data = _decoded(rx.receive(x))
    np.testing.assert_array_equal(got_acc, want_acc)
    np.testing.assert_array_equal(got_lens[got_acc], want_lens[want_acc])
    np.testing.assert_array_equal(got_data[got_acc], want_data[want_acc])
    rows = np.nonzero(got_acc)[0]
    assert rows.size == len(payloads)
    for row, p in zip(rows, payloads):
        assert got_lens[row] == p.size
        np.testing.assert_array_equal(got_data[row, : p.size], p)


def test_u16_max_transmitter_matches_jax(signals):
    """The port's transmitter at 65,535 bytes on the JAX transmitter's
    tables: frame symbols (header, data, CRC) exact, samples within 1e-5,
    lengths equal."""
    payloads, _ = signals["u16_max"]
    jtx = JTransmitter(JTxConfig(max_payload_len=U16_MAX))
    tx = Transmitter(TxConfig(max_payload_len=U16_MAX), "cpu")
    tables = numpy_tables_of(jtx, TX_JAX_ATTRIBUTES)
    tables["ldpc_generator"] = jldpc.load_generator()
    tx.load_tables(tables_from_numpy(tables))
    jb = jragged.PacketBatch.from_list(payloads, max_len=U16_MAX)
    b = PacketBatch.from_list(payloads, U16_MAX, "cpu")
    want_syms, want_sym_lens = jtx._frame_symbols(jb)
    got_syms, got_sym_lens = tx._frame_symbols(b)
    np.testing.assert_array_equal(got_sym_lens.numpy(), np.asarray(want_sym_lens))
    np.testing.assert_array_equal(got_syms.numpy(), np.asarray(want_syms))
    want, want_lens = jtx.modulate_bursts(jb)
    got, got_lens = tx.modulate_bursts(b)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
