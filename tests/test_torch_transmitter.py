"""The port's transmitter, its ops and its host drivers against the JAX
package.

The port's ``Transmitter`` computes from the JAX ``Transmitter``'s own
tables (``Transmitter.load_tables`` with ``TX_JAX_ATTRIBUTES`` and the
JAX package's LDPC generator). Data symbols, burst symbols (sync, data,
ramp-down, flush) and lengths must be equal exactly; samples within 1e-5
abs (float32 FIR sums in another order); the header encoder, the CRC
bytes, ``ragged_concat``, the packing ops and ``PacketToStream`` exactly.
Burst symbols are also held against tests/reference_impl.py, the JAX
tests' sequential transmitter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import reference_impl as ref  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import Transmitter as JTransmitter  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import TxConfig as JTxConfig  # noqa: E402
from gr4_packet_modem_tpu.ops import crc as jcrc  # noqa: E402
from gr4_packet_modem_tpu.ops import ldpc as jldpc  # noqa: E402
from gr4_packet_modem_tpu.ops import packing as jpacking  # noqa: E402
from gr4_packet_modem_tpu.ops import scramble as jscramble  # noqa: E402
from gr4_packet_modem_tpu.runtime import streaming as jstreaming  # noqa: E402
from gr4_packet_modem_tpu.utils import ragged as jragged  # noqa: E402
from gr4_packet_modem_tpu_torch.entry import TX_PAYLOAD_LEN, tx_entry  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import (  # noqa: E402
    TX_JAX_ATTRIBUTES, numpy_tables_of, tables_from_numpy,
)
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import crc, ldpc, packing, scramble  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import PacketToStream, StreamingTransmitter  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import (  # noqa: E402
    PacketBatch, mask_from_lengths, ragged_concat, ragged_concat_lengths,
)

MAX_LEN = 256
LENGTHS = [1, 10, 100, 256, 57]
TYPES = [0, 0, 0, 0, int(C.PacketType.IDLE)]


def _pair(**kw):
    jtx = JTransmitter(JTxConfig(**kw))
    tx = Transmitter(TxConfig(**kw), "cpu")
    tables = numpy_tables_of(jtx, TX_JAX_ATTRIBUTES)
    tables["ldpc_generator"] = jldpc.load_generator()
    tx.load_tables(tables_from_numpy(tables))
    return jtx, tx


@pytest.fixture(scope="module")
def pair():
    return _pair(max_payload_len=MAX_LEN)


@pytest.fixture(scope="module")
def packets():
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in LENGTHS]
    return (
        payloads,
        jragged.PacketBatch.from_list(payloads, max_len=MAX_LEN, types=TYPES),
        PacketBatch.from_list(payloads, MAX_LEN, "cpu", types=TYPES),
    )


def test_own_tables_equal_jax(pair):
    """The tables the port builds itself are the JAX transmitter's."""
    jtx, _ = pair
    own = Transmitter(TxConfig(max_payload_len=MAX_LEN), "cpu")
    want = numpy_tables_of(jtx, TX_JAX_ATTRIBUTES)
    for name, value in tables_from_numpy(want).items():
        assert torch.equal(own.get_buffer(name), value), name
    assert torch.equal(own.ldpc_generator, torch.from_numpy(jldpc.load_generator()))


def test_frame_symbols_equal_jax(pair, packets):
    jtx, tx = pair
    _, jb, b = packets
    want, want_lens = jtx._frame_symbols(jb)
    got, got_lens = tx._frame_symbols(b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("index0", [0, 5])
def test_burst_symbols_equal_reference(pair, packets, index0):
    """sync || data || ramp-down || flush exactly as the sequential
    reference builds them, zeros past each burst."""
    _, tx = pair
    payloads, _, b = packets
    syms, lens = tx.burst_symbols(b, packet_index0=index0)
    for i, (p, t) in enumerate(zip(payloads, TYPES)):
        want = ref.burst_symbols(p, packet_index=index0 + i, packet_type=t).astype(np.complex64)
        assert lens[i] == want.size == C.burst_symbols(p.size)
        np.testing.assert_array_equal(syms[i, : want.size].numpy(), want)
        assert not syms[i, want.size :].any()
    np.testing.assert_array_equal(syms[:, : C.SYNCWORD_LEN].numpy(), np.broadcast_to(tx.sync_syms.numpy(), (len(payloads), 64)))


@pytest.mark.parametrize("index0", [0, 5, 4095])
def test_bursts_match_jax(pair, packets, index0):
    """Samples within 1e-5, lengths exact; 4095 wraps the GLFSR index."""
    jtx, tx = pair
    _, jb, b = packets
    want, want_lens = jtx.modulate_bursts(jb, packet_index0=index0)
    got, got_lens = tx.modulate_bursts(b, packet_index0=index0)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for i, n in enumerate(got_lens.tolist()):
        assert not got[i, n:].any()


def test_stream_matches_jax_with_carry(pair, packets):
    """Stream mode in two calls, the FIR history carried from the first to
    the second (tests/test_transmitter.py:84)."""
    jtx, tx = pair
    payloads, _, _ = packets
    jcarry = carry = None
    for part in (payloads[:2], payloads[2:]):
        n = sum(C.stream_symbols(p.size) for p in part)
        jb = jragged.PacketBatch.from_list(part, max_len=MAX_LEN)
        jcarry, want, want_total = jtx.modulate_stream(jb, n, jcarry)
        carry, got, total = tx.modulate_stream(PacketBatch.from_list(part, MAX_LEN, "cpu"), n, carry)
        assert int(total) == int(want_total) == 4 * n
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), atol=1e-5, rtol=0)
    syms, total = tx.modulate_stream_symbols(PacketBatch.from_list(payloads, MAX_LEN, "cpu"), 5000)
    want, want_total = jtx.modulate_stream_symbols(jragged.PacketBatch.from_list(payloads, max_len=MAX_LEN), 5000)
    assert int(total) == int(want_total)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(want))


def test_streaming_transmitter_matches_jax(pair, packets):
    """send_burst twice (the packet index carries), send_stream twice (the
    FIR history carries), then flush_stream."""
    jtx, tx = pair
    payloads, _, _ = packets
    jd, td = jstreaming.StreamingTransmitter(jtx), StreamingTransmitter(tx)
    for part in (payloads[:3], payloads[3:]):
        want, got = jd.send_burst(part, types=[0] * len(part)), td.send_burst(part)
        assert got.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for part in (payloads[:2], payloads[2:]):
        np.testing.assert_allclose(td.send_stream(part), jd.send_stream(part), atol=1e-5, rtol=0)
    tail = td.flush_stream()
    np.testing.assert_allclose(tail, jd.flush_stream(), atol=1e-5, rtol=0)
    assert tail.size == 4 * (tx.arm_len - 1)
    assert td.flush_stream().size == 0
    dev = td.burst(payloads[:1])
    assert isinstance(dev, torch.Tensor) and dev.numel() == 4 * C.burst_symbols(payloads[0].size)


def test_encode_header_and_crc_bytes_equal_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (40, 32), dtype=np.uint8)
    want = np.asarray(jldpc.encode_header(jnp.asarray(bits)))
    np.testing.assert_array_equal(ldpc.encode_header(torch.from_numpy(bits)).numpy(), want)
    assert (ldpc.load_generator() == jldpc.load_generator()).all()
    words = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jcrc.crc_bytes_be(jnp.asarray(words)))
    np.testing.assert_array_equal(crc.crc_bytes_be(torch.from_numpy(words.astype(np.int64))).numpy(), want)


@pytest.mark.parametrize("kind", ["int", "complex"])
def test_ragged_concat_equal_jax(kind):
    """Rows of length 0 included, the output longer and shorter than the
    total, a fill value."""
    rng = np.random.default_rng(4)
    lens = np.array([3, 0, 5, 1, 0, 7])
    if kind == "int":
        data = rng.integers(-100, 100, (6, 8)).astype(np.int32)
        fills = (0, -7)
    else:
        data = (rng.standard_normal((6, 8)) + 1j * rng.standard_normal((6, 8))).astype(np.complex64)
        fills = (0,)
    for out_len, fill in [(n, f) for n in (10, 16, 25) for f in fills]:
        want, want_total = jragged.ragged_concat(jnp.asarray(data), jnp.asarray(lens), out_len, fill)
        got, total = ragged_concat(torch.from_numpy(data), torch.from_numpy(lens), out_len, fill)
        assert int(total) == int(want_total) == 16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tl = torch.from_numpy(lens)
    np.testing.assert_array_equal(ragged_concat_lengths(tl).numpy(), np.asarray(jragged.ragged_concat_lengths(jnp.asarray(lens))))
    np.testing.assert_array_equal(mask_from_lengths(tl, 9).numpy(), np.asarray(jragged.mask_from_lengths(jnp.asarray(lens), 9)))


def test_packing_equal_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, 12), dtype=np.uint8)
    for k, bits in ((8, 1), (4, 2), (2, 4)):
        for msb in (True, False):
            want = np.asarray(jpacking.unpack_bits(jnp.asarray(data), k, bits, msb))
            got = packing.unpack_bits(torch.from_numpy(data), k, bits, msb).numpy()
            np.testing.assert_array_equal(got, want)
            back = packing.pack_bits(torch.from_numpy(got), k, bits, msb).numpy()
            np.testing.assert_array_equal(back, data)
    for n in (1, 96, 3000):  # the keystream restarts at every row
        b = rng.integers(0, 2, (2, n), dtype=np.uint8)
        want = np.asarray(jscramble.scramble_bits(jnp.asarray(b)))
        np.testing.assert_array_equal(scramble.scramble_bits(torch.from_numpy(b)).numpy(), want)
    bits = packing.bytes_to_bits(torch.from_numpy(data))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jpacking.bytes_to_bits(jnp.asarray(data))))
    np.testing.assert_array_equal(packing.bits_to_bytes(bits).numpy(), data)
    idx = rng.integers(0, 4, (3, 9))
    qpsk = np.asarray(C.QPSK_CONSTELLATION)
    want = np.asarray(jpacking.map_symbols(jnp.asarray(idx), jnp.asarray(qpsk)))
    np.testing.assert_array_equal(packing.map_symbols(torch.from_numpy(idx), torch.from_numpy(qpsk)).numpy(), want)


def test_packet_batch_round_trip():
    rng = np.random.default_rng(6)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (0, 4, 9)]
    b = PacketBatch.from_list(payloads, None, "cpu", types=[1, 0, 1])
    jb = jragged.PacketBatch.from_list(payloads, types=[1, 0, 1])
    assert (b.batch, b.max_len) == (jb.batch, jb.max_len) == (3, 9)
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(jb.data))
    assert b.lengths.dtype == torch.int64 and b.lengths.tolist() == [0, 4, 9]
    assert b.types.tolist() == [1, 0, 1]
    for g, w in zip(b.to_list(), payloads):
        np.testing.assert_array_equal(g, w)


def test_packet_to_stream_same_pulls():
    """The same pull sequence, packet callbacks, zero fill and pending
    counts as the JAX package's ``PacketToStream``."""
    rng = np.random.default_rng(7)
    bursts = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64) for n in (50, 0, 130, 7)]
    counts = ([], [])
    drivers = (PacketToStream(counts[0].append), jstreaming.PacketToStream(counts[1].append))
    for d in drivers:
        d.push(bursts[0])
        d.push(bursts[1])
    for n in (20, 40, 200):
        outs = [d.pull(n) for d in drivers]
        np.testing.assert_array_equal(outs[0], outs[1])
        for d in drivers:
            d.push(bursts[2])
            d.push(bursts[3])
        assert drivers[0].pending == drivers[1].pending
    outs = [d.pull(1000) for d in drivers]  # drains, then starves
    np.testing.assert_array_equal(outs[0], outs[1])
    assert counts[0] == counts[1] and drivers[0].zeros_inserted == drivers[1].zeros_inserted > 0


@pytest.mark.parametrize("stream", [False, True])
def test_tx_entry_shapes(stream):
    """The TX entry at a small batch: the benchmark's sample counts."""
    fn, (b,) = tx_entry("cpu", stream=stream, batch=3)
    samples, lens = fn(b)
    assert samples.dtype == torch.complex64
    if stream:
        assert samples.shape == (3 * 4 * C.stream_symbols(TX_PAYLOAD_LEN),) and int(lens) == samples.numel()
    else:
        assert lens.tolist() == [4 * C.burst_symbols(TX_PAYLOAD_LEN)] * 3
