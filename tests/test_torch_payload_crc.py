"""The payload pass's CRC check (``ops/crc.py::payload_crc``) on CPU tensors,
where it runs its plain version, against the JAX package.

Rows of payload symbols are made in numpy from chosen bytes (each LLR's
sign set through the keystream), then given lengths that meet every edge
of the check: 0, 1, a row of ``max_len`` (where the received CRC sits at
``s_pay / 4 - 4``), a garbage header's length past ``max_len`` up to
65,535, and negative; some symbols are exactly +0.0, -0.0 or NaN. The
plain version's bytes are held to numpy's slicing of the same values, its
CRC words to the JAX ``CrcEngine`` and to ``crc32_ref``, its received CRC
to the bytes after each row's length. ``Receiver.decode_payloads`` is held
field by field to the chain it ran before the check moved into
``ops/crc.py``. The kernel itself is held to this plain version on the
card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.ops import crc as jcrc  # noqa: E402
from gr4_packet_modem_tpu_torch.models import receiver as receiver_mod  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import tables_from_numpy  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import crc  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.packing import binary_slice, pack_bits  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.scramble import descramble_soft, keystream_np  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples  # noqa: E402

SCALE = np.float32(2.0 / C.LLR_NOISE_SIGMA**2)


def _crc_tables(max_len: int) -> tuple:
    """The CRC engine's tables for ``max_len`` as the receiver holds them."""
    t = tables_from_numpy(crc.crc32_tables(max_len))
    return t["g_packed"], t["init_lut"], t["final_xor"]


def _keystream(max_len: int) -> np.ndarray:
    """The payload's keystream bits, as the receiver takes them."""
    s_pay = 4 * (max_len + C.CRC_NUM_BYTES)
    return keystream_np(C.HEADER_LLRS + 2 * s_pay)[C.HEADER_LLRS :]


def _symbols(rows: np.ndarray, ks: np.ndarray, rng) -> np.ndarray:
    """complex64 ``[D, 4 (max_len + 4)]`` whose LLRs slice to ``rows``
    (uint8 ``[D, max_len + 4]``): a bit is 1 where the descrambled LLR is
    negative."""
    bits = np.unpackbits(rows, axis=1)
    sign = 1.0 - 2.0 * (bits ^ ks[None, :])
    v = (sign * rng.uniform(0.05, 2.0, bits.shape)).astype(np.float32)
    return v.view(np.complex64)


def _numpy_bytes(sym: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """numpy's slicing of the same values: float32 product, sign flip,
    ``< 0``, packed MSB first."""
    p = sym.view(np.float32) * SCALE
    d = np.where(ks[None, :] == 1, -p, p)
    return np.packbits((d < 0).astype(np.uint8), axis=1)


@pytest.mark.parametrize("max_len", [1536, 4096])
def test_payload_crc_plain_matches_jax_engine_and_oracle(max_len):
    rng = np.random.default_rng(max_len)
    d = 12
    ks = _keystream(max_len)
    body = rng.integers(0, 256, (d, max_len + C.CRC_NUM_BYTES), dtype=np.uint8)
    lengths = np.array([0, 1, max_len, max_len + 1, 65_535, -3, 17, max_len - 1,
                        *rng.integers(2, max_len, d - 8)], np.int64)
    # rows 2, 6, 8 carry their own CRC after their bytes: they pass
    for i in (2, 6, 8):
        n = min(int(lengths[i]), max_len)
        body[i, n : n + 4] = np.frombuffer(int(jcrc.crc32_ref(body[i, :n])).to_bytes(4, "big"), np.uint8)
    sym = _symbols(body, ks, rng)
    flat = sym.view(np.float32)
    flat[3, 5], flat[3, 9], flat[4, 0] = 0.0, -0.0, np.nan
    flat[9, :16] = np.nan
    flat[10, 8 * 4 : 8 * 5] = -0.0
    want_bytes = _numpy_bytes(sym, ks)

    payload, got, got_rx = crc.payload_crc(
        torch.from_numpy(sym), torch.tensor(SCALE), torch.from_numpy(np.packbits(ks)),
        torch.from_numpy(lengths), *_crc_tables(max_len))
    n = np.clip(lengths, 0, max_len)
    pos = np.arange(max_len)
    want_payload = np.where(pos[None, :] < lengths[:, None], want_bytes[:, :max_len], 0)
    np.testing.assert_array_equal(payload.numpy(), want_payload)
    assert payload.dtype == torch.uint8 and got.dtype == got_rx.dtype == torch.int64
    engine = np.asarray(jcrc.CrcEngine(max_len).compute(jnp.asarray(want_payload), jnp.asarray(n.astype(np.int32))))
    np.testing.assert_array_equal(got.numpy(), engine.astype(np.int64))
    oracle = [jcrc.crc32_ref(want_bytes[i, : n[i]]) for i in range(d)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle, np.int64))
    rx_words = [int.from_bytes(want_bytes[i, n[i] : n[i] + 4].tobytes(), "big") for i in range(d)]
    np.testing.assert_array_equal(got_rx.numpy(), np.asarray(rx_words, np.int64))
    assert [int(i) for i in np.nonzero(got.numpy() == got_rx.numpy())[0]] == [2, 6, 8]
    # +0.0, -0.0 and NaN slice to 0 bits
    assert want_bytes[9, :1].tolist() == [0] and want_bytes[10, 4] == 0


def test_payload_crc_refuses_what_the_kernel_does_not_take():
    sym = torch.zeros(3, 4 * (20 + 4), dtype=torch.complex64)
    args = (torch.tensor(SCALE), torch.zeros(24, dtype=torch.uint8), torch.zeros(3, dtype=torch.int64))
    tables = _crc_tables(20)
    crc.payload_crc(sym, *args, *tables)
    for bad, match in (
        ((sym[:, :-4], *args, *tables), "complex64"),
        ((sym, *args, *_crc_tables(21)), "complex64"),
        ((sym, args[0].double(), *args[1:], *tables), "llr_scale"),
        ((sym, args[0], args[1][:-1], args[2], *tables), "keystream"),
        ((sym, *args[:2], args[2].int(), *tables), "lengths"),
        ((sym, *args, tables[0][:-8], *tables[1:]), "CRC tables"),
        ((sym, *args, *tables[:2], tables[2].int()), "CRC tables"),
        ((sym, *args[:2], args[2].to("meta"), *tables), "several devices"),
    ):
        with pytest.raises(ValueError, match=match):
            crc.payload_crc(*bad)


def _chain_before(rx):
    """The check as ``decode_payloads`` ran it before it moved into
    ``ops/crc.py``, on the receiver's own CRC tables and keystream bits."""
    cfg = rx.config
    ks_bits = torch.from_numpy(_keystream(cfg.max_payload_len).astype(bool))

    def chain(corrected, llr_scale, ks, plen, g_packed, init_lut, final_xor):
        llrs = torch.view_as_real(corrected).reshape(corrected.shape[0], -1) * rx.llr_scale
        bits = binary_slice(descramble_soft(llrs, ks_bits))
        all_bytes = pack_bits(bits, 8).to(torch.uint8)
        pos = torch.arange(cfg.max_payload_len)
        payload = torch.where(pos[None, :] < plen[:, None], all_bytes[:, : cfg.max_payload_len], 0)
        got = crc.crc32_compute(payload, torch.clamp(plen, 0, cfg.max_payload_len),
                                rx.crc_g_packed, rx.crc_init_lut, rx.crc_final_xor)
        plen_c = torch.clamp(plen, 0, all_bytes.shape[1] - C.CRC_NUM_BYTES)
        at = plen_c[:, None] + torch.arange(C.CRC_NUM_BYTES)
        rx_bytes = all_bytes.gather(1, at).to(torch.int64)
        crc_rx = rx_bytes[:, 0] << 24 | rx_bytes[:, 1] << 16 | rx_bytes[:, 2] << 8 | rx_bytes[:, 3]
        return payload, got, crc_rx

    return chain


@pytest.mark.parametrize("max_len", [1536, 4096])
def test_decode_payloads_before_and_after_the_move(max_len, monkeypatch):
    """Two channels of three bursts (one at ``max_len``) and free slots:
    ``decode_payloads`` with the check in ``ops/crc.py`` gives every field
    of the result as the chain it ran before, for kept, suppressed and
    invalid rows alike; on CPU tensors it counts no kernel rows."""
    rng = np.random.default_rng(20)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in (60, max_len, 9)]
    burst = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(pays)])
    rx = Receiver(RxConfig(max_payload_len=max_len, max_detections=6, freq_bins=1, payload_carrier="vv"), "cpu")
    fp = rx.front_pad
    x = torch.zeros(2, fp + burst.size + 4000 + rx.pad_tail(), dtype=torch.complex64)
    for c in range(2):
        x[c, fp + 70 * c : fp + 70 * c + burst.size] = torch.from_numpy(
            (np.exp(0.5j * c) * burst).astype(np.complex64))
    det = rx.acquirer.acquire(x)
    detf, chan = receiver_mod.flatten_detections(det)
    hdr, _ = rx.decode_headers(x, detf, chan)
    keep = rx.filter_detections(det, hdr)[1].reshape(-1)
    before = trace.counters().get("rx.payload.crc_kernel_rows", 0)
    after_move = rx.decode_payloads(x, detf, hdr, keep, chan)
    assert trace.counters().get("rx.payload.crc_kernel_rows", 0) == before
    monkeypatch.setattr(receiver_mod, "payload_crc", _chain_before(rx))
    moved_from = rx.decode_payloads(x, detf, hdr, keep, chan)
    for f in ("data", "lengths", "crc_ok", "accepted", "symbols"):
        a, b = getattr(after_move, f), getattr(moved_from, f)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f
    acc = after_move.accepted
    assert int(acc.sum()) == 6 and not bool(keep.all())
    got = sorted(tuple(after_move.data[i, : after_move.lengths[i]].tolist()) for i in np.nonzero(acc.numpy())[0])
    assert got == sorted(tuple(p.tolist()) for p in pays for _ in range(2))
