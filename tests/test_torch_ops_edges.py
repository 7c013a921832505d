"""The ops the block registry resolves to, against the JAX package on the
same seeded numpy inputs:

- ``binary_slice`` and ``descramble_soft``: exact;
- ``BatchedCrcAppend`` / ``BatchedCrcCheck`` over tests/test_crc_options.py's
  cases (swap x skip, short packets passing through, corruption): bytes,
  lengths and ``ok`` exact against the JAX blocks and against ``CrcRef``;
  ``CrcRef`` and ``crc32_ref`` against the JAX copies and zlib;
- ``pfb_symbol_filter``: within 1e-5 of the largest output (float32 sums in
  another order);
- ``vv_phase_estimate``: within 1e-5 rad, and the tracking case of
  tests/test_costas_channel.py:100-110;
- ``HeaderLdpcDecoder`` (the plain BP of K5 on CPU tensors): bits and
  ``ok`` exact against the JAX scan decoder at B=300, failing codewords
  included; the receiver's header pass decodes through one such decoder
  on its carried tables.
"""

import zlib
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.ops import costas as jcostas  # noqa: E402
from gr4_packet_modem_tpu.ops import crc as jcrc  # noqa: E402
from gr4_packet_modem_tpu.ops import fir as jfir  # noqa: E402
from gr4_packet_modem_tpu.ops import ldpc as jldpc  # noqa: E402
from gr4_packet_modem_tpu.ops import packing as jpacking  # noqa: E402
from gr4_packet_modem_tpu.ops import scramble as jscramble  # noqa: E402
from gr4_packet_modem_tpu.utils import constants as JC  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import costas, crc, fir, ldpc, packing, scramble  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.firdes import rx_pfb_taps  # noqa: E402

MAX_LEN = 64


# ------------------------------------------------------- slicer, scrambler


@pytest.mark.parametrize("invert", [True, False])
def test_binary_slice_equals_jax(invert):
    rng = np.random.default_rng(1)
    llrs = rng.standard_normal((4, 300)).astype(np.float32)
    llrs[0, :5] = [0.0, -0.0, 1e-30, -1e-30, np.inf]
    got = packing.binary_slice(torch.from_numpy(llrs), invert)
    want = np.asarray(jpacking.binary_slice(jnp.asarray(llrs), invert))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64,), (3, 500), (2, 2, 12_376)])
def test_descramble_soft_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    llrs = rng.standard_normal(shape).astype(np.float32)
    got = scramble.descramble_soft(torch.from_numpy(llrs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jscramble.descramble_soft(jnp.asarray(llrs))))
    # descrambling the hard bits' signs is the hard scrambler
    bits = (llrs < 0).astype(np.uint8)
    hard = scramble.scramble_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal((got < 0).astype(np.uint8), hard)


# -------------------------------------------------------------------- CRC


def _packets(rng, n=6):
    """tests/test_crc_options.py's packets."""
    lens = rng.integers(5, MAX_LEN + 1, n)
    data = np.zeros((n, MAX_LEN), np.uint8)
    for i, n_ in enumerate(lens):
        data[i, :n_] = rng.integers(0, 256, n_, dtype=np.uint8)
    return data, lens.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_crc_ref_equals_jax_and_zlib():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 64, 1500):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert crc.crc32_ref(data) == jcrc.crc32_ref(data) == zlib.crc32(data.tobytes())
    for kw in (dict(num_bits=16, poly=0x1021, initial_value=0xFFFF, final_xor=0,
                    input_reflected=False, result_reflected=False),
               dict(num_bits=8, poly=0x07, initial_value=0, final_xor=0, input_reflected=True,
                    result_reflected=False)):
        data = rng.integers(0, 256, 33, dtype=np.uint8)
        assert crc.CrcRef(**kw).compute(data) == jcrc.CrcRef(**kw).compute(data)
        np.testing.assert_array_equal(crc.CrcRef(**kw).table, jcrc.CrcRef(**kw).table)
    with pytest.raises(ValueError):
        crc.CrcRef(num_bits=4)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("skip", [0, 3])
def test_append_equals_jax_and_oracle(swap, skip):
    rng = np.random.default_rng(42)
    data, lens = _packets(rng)
    out, out_lens = crc.BatchedCrcAppend(MAX_LEN, swap, skip).append(_t(data), _t(lens))
    jout, jlens = jcrc.BatchedCrcAppend(MAX_LEN, swap_endianness=swap, skip_header_bytes=skip).append(data, lens)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(jlens))
    ref = crc.CrcRef()
    for i, n in enumerate(lens):
        cb = ref.compute(data[i, skip:n]).to_bytes(4, "little" if swap else "big")
        assert int(out_lens[i]) == n + 4 and bytes(out[i, n : n + 4].numpy()) == cb
        np.testing.assert_array_equal(out[i, :n].numpy(), data[i, :n])


def test_append_short_packet_passthrough():
    data = np.zeros((3, MAX_LEN), np.uint8)
    data[0, :5] = 7
    data[1, :20] = 9
    data[2, :8] = 3
    lens = np.array([5, 20, 8], np.int32)
    out, out_lens = crc.BatchedCrcAppend(MAX_LEN, skip_header_bytes=8).append(_t(data), _t(lens))
    jout, jlens = jcrc.BatchedCrcAppend(MAX_LEN, skip_header_bytes=8).append(data, lens)
    assert out_lens.tolist() == [5, 24, 8]  # <= skip: unchanged
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("discard", [True, False])
def test_check_roundtrip_and_corruption(swap, skip, discard):
    rng = np.random.default_rng(1)
    data, lens = _packets(rng)
    jout, jout_lens = jcrc.BatchedCrcAppend(MAX_LEN, swap_endianness=swap, skip_header_bytes=skip).append(data, lens)
    out, out_lens = np.array(jout), np.array(jout_lens)
    chk = crc.BatchedCrcCheck(MAX_LEN + 4, swap, skip, discard)
    jchk = jcrc.BatchedCrcCheck(MAX_LEN + 4, swap_endianness=swap, skip_header_bytes=skip, discard_crc=discard)
    bad = out.copy()
    bad[2, skip] ^= 0xFF  # a payload byte after the skipped header
    bad2 = out.copy()
    bad2[1, 0] ^= 0xFF  # inside the skipped header: not covered when skip > 0
    short = out.copy()
    short_lens = out_lens.copy()
    short_lens[3] = skip + 4  # not longer than skip + CRC: never ok
    short_lens[4] = 2  # shorter than the CRC itself
    for d, n in ((out, out_lens), (bad, out_lens), (bad2, out_lens), (short, short_lens)):
        ok, stripped, slens = chk.check(_t(d), _t(n))
        jok, jstripped, jslens = jchk.check(d, n)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(stripped.numpy(), np.asarray(jstripped))
        np.testing.assert_array_equal(slens.numpy(), np.asarray(jslens))
    ok, stripped, slens = chk.check(_t(out), _t(out_lens))
    assert ok.all()
    if discard:
        np.testing.assert_array_equal(slens.numpy(), lens)
        for i, n in enumerate(lens):
            np.testing.assert_array_equal(stripped[i, :n].numpy(), data[i, :n])
    assert chk.check(_t(bad), _t(out_lens))[0].tolist() == [True, True, False, True, True, True]
    assert bool(chk.check(_t(bad2), _t(out_lens))[0][1]) == bool(skip)
    assert chk.check(_t(short), _t(short_lens))[0].tolist()[3:5] == [False, False]


# ------------------------------------------------------------- symbol filter


@lru_cache(maxsize=None)
def _jax_symbol_filter(num_symbols):
    """The JAX filter jitted with the window start and arm traced (one
    compile a symbol count, instead of one per eager slice)."""
    taps = rx_pfb_taps(4, 32)
    return jax.jit(lambda x, start, arm: jfir.pfb_symbol_filter(x, start, arm, taps, 32, num_symbols))


@pytest.mark.parametrize("start,arm,num_symbols", [
    (100, 3, 200), (43, 0, 200), (4990, 31, 200), (10, 7, 200), (700, 16, 1),
])
def test_pfb_symbol_filter_equals_jax(start, arm, num_symbols):
    """Interior, edge-clamped and negative-start windows (the JAX slice's
    placement), complex and real samples."""
    rng = np.random.default_rng(start + arm)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    taps = rx_pfb_taps(4, 32)
    for s in (x, x.real.copy()):
        got = fir.pfb_symbol_filter(torch.from_numpy(s), start, arm, taps, 32, num_symbols).numpy()
        want = np.asarray(_jax_symbol_filter(num_symbols)(jnp.asarray(s), start, arm))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pfb_symbol_filter_takes_tensor_args():
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal(3000) + 1j * rng.standard_normal(3000)).astype(np.complex64))
    taps = rx_pfb_taps(4, 32)
    a = fir.pfb_symbol_filter(x, torch.tensor(500), torch.tensor(5), torch.from_numpy(taps), 32, 100)
    b = fir.pfb_symbol_filter(x, 500, 5, taps, 32, 100)
    assert torch.equal(a, b)


# --------------------------------------------------------------- V&V phase


@pytest.mark.parametrize("shape,block", [((1024,), 32), ((3, 1000), 32), ((2, 777), 64)])
def test_vv_phase_estimate_equals_jax(shape, block):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    got = costas.vv_phase_estimate(torch.from_numpy(x), block).numpy()
    want = np.asarray(jax.jit(jcostas.vv_phase_estimate, static_argnums=1)(jnp.asarray(x), block))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-5


def test_vv_estimate_tracks_phase():
    """tests/test_costas_channel.py:100-110 on the port."""
    rng = np.random.default_rng(2)
    n = 1024
    syms = np.asarray(JC.QPSK_CONSTELLATION)[rng.integers(0, 4, n)]
    phase = 0.3 + 1e-4 * np.arange(n)
    recv = (syms * np.exp(1j * phase)).astype(np.complex64)
    est = costas.vv_phase_estimate(torch.from_numpy(recv)).numpy()
    # 4th-power estimate has a pi/2 ambiguity; compare modulo pi/2
    d = (est - phase + np.pi / 4) % (np.pi / 2) - np.pi / 4
    assert np.abs(d[64:]).mean() < 0.08


def test_vv_phase_estimate_needs_a_block():
    with pytest.raises(ValueError, match="at least one block"):
        costas.vv_phase_estimate(torch.ones(31, dtype=torch.complex64), 32)


# --------------------------------------------------------------- LDPC block


def _noisy_codewords(b, seed):
    """Seeded codewords at three noise levels: clean ones, ones that
    converge, ones that fail."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, 32), dtype=np.uint8)
    cw = np.asarray(jldpc.encode_header(jnp.asarray(bits)))[:, :128]
    snr = np.repeat([-6.0, 0.0, 6.0], -(-b // 3))[:b]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr / 10)))[:, None]
    bpsk = 1.0 - 2.0 * cw.astype(np.float32)
    llr = (2.0 / sigma**2) * (bpsk + sigma * rng.standard_normal(cw.shape))
    return llr.astype(np.float32), bits


def test_header_decoder_equals_jax():
    llr, bits = _noisy_codewords(300, 5)
    want_bits, want_ok = jldpc.HeaderLdpcDecoder(25, use_pallas=False).decode(jnp.asarray(llr))
    dec = ldpc.HeaderLdpcDecoder(25, device="cpu")
    got_bits, got_ok = dec.decode(torch.from_numpy(llr))
    assert got_bits.dtype == torch.uint8 and got_ok.dtype == torch.bool
    assert tuple(got_bits.shape) == (300, 32)
    want_ok = np.asarray(want_ok)
    assert 0.0 < want_ok.mean() < 1.0  # failing codewords exercised
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_array_equal(got_bits.numpy()[want_ok], bits[want_ok])
    # the buffers follow the module, the factory caches
    assert {b.device.type for b in dec.buffers()} == {"cpu"}
    assert ldpc.make_header_decoder(25, "cpu") is ldpc.make_header_decoder(25, "cpu")


def test_receiver_header_pass_uses_one_header_decoder():
    """The receiver's header pass runs its ``HeaderLdpcDecoder``: the
    carried parity-check matrix itself, index tables rebuilt by
    ``load_tables``, decoding as a decoder set to the same tables does."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    rx = Receiver(RxConfig(max_payload_len=MAX_LEN, max_detections=4, freq_bins=1), "cpu")
    dec = rx.header_decoder
    assert isinstance(dec, ldpc.HeaderLdpcDecoder) and dec.h is rx.ldpc_h
    assert dec.num_iterations == rx.config.ldpc_iterations
    assert not any(k.startswith("header_decoder.") for k in rx.state_dict())
    fresh = ldpc.HeaderLdpcDecoder(25, device="cpu")
    for name in ("chk_vars", "var_edges", "h"):
        assert torch.equal(dec.get_buffer(name), fresh.get_buffer(name)), name
    # the first check's first two slots swapped: the same code, another order
    vidx = rx.ldpc_vidx.clone()
    vidx[0, :2] = vidx[0, :2].flip(0)
    rx.load_tables({"ldpc_vidx": vidx})
    want_chk, want_edges = ldpc.edge_tables(vidx.numpy(), rx.ldpc_vmask.numpy(), 128)
    np.testing.assert_array_equal(dec.chk_vars.numpy(), want_chk)
    np.testing.assert_array_equal(dec.var_edges.numpy(), want_edges)
    assert not torch.equal(dec.chk_vars, fresh.chk_vars)
    fresh.set_tables(vidx, rx.ldpc_vmask, rx.ldpc_h)
    llr = torch.from_numpy(_noisy_codewords(30, 6)[0])
    for got, want in zip(dec.decode(llr), fresh.decode(llr)):
        assert torch.equal(got, want)


def test_header_decoder_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ldpc.HeaderLdpcDecoder(25)  # device defaults to cuda
