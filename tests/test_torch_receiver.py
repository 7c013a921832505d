"""Port receiver vs the JAX receiver, end to end.

The loopback cases of tests/test_loopback.py (14 packets of 10..1500
bytes, burst mode, CFO 0 / +0.006 / -0.02, with the Costas and the V&V
payload carrier) and the 3-channel bank of tests/test_bank_decode.py go
through both packages: the same accepted flags, lengths and payload bytes
must come out. Waveforms come from the JAX transmitter; CFO and noise are
applied with numpy from a seed. The JAX side runs with ``use_pallas=False``
and the fft acquisition backend; the port's receivers compute from the
JAX receivers' own tables (``Receiver.load_tables``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import (  # noqa: E402
    packet_extent_samples as jpacket_extent_samples,
    suppress_overlapping as jsuppress_overlapping,
)
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import numpy_tables_of, tables_from_numpy  # noqa: E402

LENGTHS = [10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34]
PAYLOADS = [(np.arange(n) % 256).astype(np.uint8) for n in LENGTHS]
NOISE_AMPLITUDE = 0.05  # qa_loopback.cpp:66


def _bursts(payloads, max_len):
    tx = Transmitter(TxConfig(max_payload_len=max_len))
    s, l = tx.modulate_bursts(PacketBatch.from_list(payloads, max_len=max_len))
    stream, _ = ragged_concat(s, l, int(np.sum(np.asarray(l))))
    return np.asarray(stream)


def _impair(x, cfo, noise, seed):
    rng = np.random.default_rng(seed)
    x = x * np.exp(1j * cfo * np.arange(x.size))
    x = x + noise * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def loopback_stream():
    return _bursts(PAYLOADS, 1536)


@pytest.fixture(scope="module")
def receivers():
    """One receiver pair per payload carrier (the JAX receiver's jit cache
    is per instance, so reuse keeps its compiles to one per carrier)."""
    return {
        carrier: _pair(max_payload_len=1536, max_detections=32, payload_carrier=carrier)
        for carrier in ("costas", "vv")
    }


def _pair(**kw):
    jrx = JReceiver(JConfig(**kw, acquisition_backend="fft", use_pallas=False))
    rx = Receiver(RxConfig(**kw, acquisition_backend="fft"), "cpu")
    rx.load_tables(tables_from_numpy(numpy_tables_of(jrx)))
    return jrx, rx


def _decoded(res):
    acc = np.asarray(res.accepted)
    lens = np.asarray(res.lengths)
    data = np.asarray(res.data)
    return acc, lens, data, [data[i, : lens[i]] for i in np.nonzero(acc)[0]]


@pytest.mark.parametrize("carrier", ["costas", "vv"])
@pytest.mark.parametrize("cfo", [0.0, 0.006, -0.02])
def test_loopback_matches_jax(loopback_stream, receivers, carrier, cfo):
    x = _impair(loopback_stream, cfo, NOISE_AMPLITUDE, seed=1 + int(1000 * abs(cfo)))
    jrx, rx = receivers[carrier]
    want_acc, want_lens, want_data, want = _decoded(jrx.receive(x))
    got_acc, got_lens, got_data, got = _decoded(rx.receive(x))
    np.testing.assert_array_equal(got_acc, want_acc)
    np.testing.assert_array_equal(got_lens[got_acc], want_lens[want_acc])
    np.testing.assert_array_equal(got_data[got_acc], want_data[want_acc])
    assert len(got) == len(PAYLOADS)
    for g, e in zip(got, PAYLOADS):
        np.testing.assert_array_equal(g, e)


BANK_KW = dict(max_payload_len=128, max_detections=8, freq_bins=1)


@pytest.fixture(scope="module")
def bank():
    """The 3-channel bank of tests/test_bank_decode.py: staggered packets
    so the same index ranges overlap across channels, per-channel CFO."""
    rng = np.random.default_rng(42)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (50, 96, 128)]
    burst = _bursts(payloads, 128)
    jrx, rx = _pair(**BANK_KW)
    fp, pt = rx.front_pad, rx.pad_tail()
    assert (fp, pt) == (jrx.front_pad, jrx.pad_tail())
    n = 16384
    x = np.zeros((3, fp + n + pt), np.complex64)
    for c in range(3):
        sig = np.zeros(n, np.complex64)
        sig[37 + 401 * c : 37 + 401 * c + burst.size] = burst
        x[c, fp : fp + n] = _impair(sig, 0.002 * (c - 1), 0.02, seed=c)
    return jrx, rx, x, payloads


def test_bank_step_matches_jax(bank):
    jrx, rx, x, payloads = bank
    jdet, jhdr, jres, jkeep = jrx.bank_step(x, 0)
    det, hdr, res, keep = rx.bank_step(torch.from_numpy(x))
    v = np.asarray(jdet.valid)
    np.testing.assert_array_equal(det.valid.numpy(), v)
    np.testing.assert_array_equal(det.index.numpy()[v], np.asarray(jdet.index)[v])
    assert bool(det.overflow) == bool(jdet.overflow)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(res.accepted.numpy(), np.asarray(jres.accepted))
    np.testing.assert_array_equal(
        hdr.packet_length.numpy()[v], np.asarray(jhdr.packet_length)[v]
    )
    np.testing.assert_array_equal(res.lengths.numpy()[v], np.asarray(jres.lengths)[v])
    np.testing.assert_array_equal(res.data.numpy()[v], np.asarray(jres.data)[v])
    # loop state after the header (same recursion; tests/test_bank_decode.py)
    np.testing.assert_allclose(hdr.phase.numpy()[v], np.asarray(jhdr.phase)[v], atol=1e-5)


def test_bank_step_decodes_all_packets(bank):
    _, rx, x, payloads = bank
    _, _, res, _ = rx.bank_step(torch.from_numpy(x))
    acc, lens, data, got = _decoded(res)
    assert len(got) == x.shape[0] * len(payloads)
    expected = payloads * x.shape[0]  # channel-major rows, index-sorted
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)


def test_bank_step_tracks_valid_slots_only(bank, monkeypatch):
    """Both passes of ``bank_step`` hand the Costas loop the detections'
    valid flags as its row mask (header at symbol 0, payload at 192): a
    slot with no detection is not tracked, and its header symbols read
    zeros."""
    import gr4_packet_modem_tpu_torch.models.receiver as receiver_module

    _, rx, x, _ = bank
    calls, track = [], receiver_module.costas_track

    def spy(symbols, phase0, freq0, offset=0, active=None):
        calls.append((offset, active))
        return track(symbols, phase0, freq0, offset, active)

    monkeypatch.setattr(receiver_module, "costas_track", spy)
    det, _, res, _ = rx.bank_step(torch.from_numpy(x))
    assert [offset for offset, _ in calls] == [0, 192]
    assert not bool(det.valid.all()) and bool(det.valid.any())
    for _, active in calls:
        assert active is not None and torch.equal(active, det.valid)
    assert not bool(res.accepted[~det.valid].any())
    got = rx.decode(torch.from_numpy(x), rx.acquirer.acquire(torch.from_numpy(x)))
    blank = ~got.det.valid
    assert torch.equal(got.header_symbols[blank], torch.zeros_like(got.header_symbols[blank]))


def test_decode_seeded_suppression(bank):
    """``Receiver.decode``, the chain every caller runs, against the JAX
    receiver: unseeded, its rows are the JAX ``bank_step``'s; unseeded and
    with a busy-until seed past channel 0's first detection (which that
    seed drops), ``busy_end`` and ``keep`` are JAX's
    ``suppress_overlapping(packet_extent_samples(...))`` per channel on
    the same detections, header lengths and seed."""
    jrx, rx, x, _ = bank
    det = rx.acquirer.acquire(torch.from_numpy(x))
    c, dd = det.index.shape
    got = rx.decode(torch.from_numpy(x), det)
    jdet, _, jres, jkeep = jrx.bank_step(x, 0)
    v = np.asarray(jdet.valid)
    np.testing.assert_array_equal(got.det.valid.numpy(), v)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(got.res.accepted.numpy(), np.asarray(jres.accepted))
    np.testing.assert_array_equal(got.res.lengths.numpy()[v], np.asarray(jres.lengths)[v])
    np.testing.assert_array_equal(got.res.data.numpy()[v], np.asarray(jres.data)[v])
    assert got.header_symbols.shape == (c * dd, 192) and got.det.overflow.ndim == 0

    extent = jpacket_extent_samples(
        jnp.asarray(got.hdr.packet_length.numpy().reshape(c, dd)),
        jnp.asarray(got.hdr.header_ok.numpy().reshape(c, dd)),
        rx.config.samples_per_symbol,
    )
    scan = jax.vmap(jsuppress_overlapping)
    index, valid = jnp.asarray(det.index.numpy()), jnp.asarray(det.valid.numpy())
    want_busy, want_keep = scan(index, valid, extent, jnp.full((c,), -1, index.dtype))
    np.testing.assert_array_equal(got.busy_end.numpy(), np.asarray(want_busy))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want_keep).reshape(-1))

    assert bool(det.valid[0, 0]) and bool(got.res.accepted[0])
    seed = torch.tensor([int(det.index[0, 0]) + 1, -1, -1])
    seeded = rx.decode(torch.from_numpy(x), det, seed)
    assert not bool(seeded.keep[0]) and not bool(seeded.res.accepted[0])
    want_busy, want_keep = scan(index, valid, extent, jnp.asarray(seed.numpy(), index.dtype))
    np.testing.assert_array_equal(seeded.busy_end.numpy(), np.asarray(want_busy))
    np.testing.assert_array_equal(seeded.keep.numpy(), np.asarray(want_keep).reshape(-1))
    assert torch.equal(seeded.keep[dd:], got.keep[dd:])  # the unseeded channels


def test_bank_suppression_is_per_channel():
    """Packets at overlapping indices on two channels both decode."""
    rng = np.random.default_rng(1)
    p = rng.integers(0, 256, 64, dtype=np.uint8)
    burst = _bursts([p], 128)
    rx = Receiver(RxConfig(**BANK_KW), "cpu")
    fp, pt = rx.front_pad, rx.pad_tail()
    x = np.zeros((2, fp + 8192 + pt), np.complex64)
    x[0, fp + 100 : fp + 100 + burst.size] = burst
    x[1, fp + 140 : fp + 140 + burst.size] = burst
    _, _, res, _ = rx.bank_step(torch.from_numpy(x))
    assert int(res.accepted.sum()) == 2


def test_chunked_extraction_matches_jax():
    """Extractions longer than 4 * symbol_chunk run chunk by chunk (the
    long-payload path); a small chunk forces it at a small payload."""
    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in (256, 40, 200)]
    x = _impair(_bursts(payloads, 256), 0.003, NOISE_AMPLITUDE, seed=9)
    jrx, rx = _pair(max_payload_len=256, max_detections=8, symbol_chunk=64)
    assert rx.config.max_payload_syms > 4 * rx.config.symbol_chunk
    want_acc, want_lens, want_data, _ = _decoded(jrx.receive(x))
    got_acc, got_lens, got_data, got = _decoded(rx.receive(x))
    np.testing.assert_array_equal(got_acc, want_acc)
    np.testing.assert_array_equal(got_data[got_acc], want_data[want_acc])
    assert len(got) == len(payloads)
    for g, e in zip(got, payloads):
        np.testing.assert_array_equal(g, e)
