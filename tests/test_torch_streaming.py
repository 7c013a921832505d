"""The port's streaming drivers and their wires against the JAX package.

``StreamingReceiver`` and ``StreamingBank`` are fed the same samples as the
JAX drivers, on the configurations of tests/test_runtime.py and
tests/test_streaming_bank.py, and must give the same ``DecodedPacket`` list
in order: ``index``, ``data``, ``packet_type``, ``channel`` and ``arm``
equal, ``esn0_db`` within 1e-3 dB (1e-2 on the fused backend, the tolerance
of tests/test_acquire_fused.py) and ``freq`` within 1e-6 rad/sample (those
of tests/test_torch_acquire.py). The bursts come from the sequential
reference transmitter (tests/reference_impl.py); carrier offset and noise
are applied with numpy from a seed.
"""

import logging
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import reference_impl as ref  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.runtime import streaming as jstreaming  # noqa: E402
from gr4_packet_modem_tpu.utils import cplx as jcplx  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import (  # noqa: E402
    StreamingBank,
    StreamingReceiver,
    pack_result_wire,
    unpack_result_wire,
    wire_bytes,
)
from gr4_packet_modem_tpu_torch.utils.cplx import planes_to_complex, to_transfer_planes  # noqa: E402

BLOCK = 4096


def _bursts(payloads):
    return np.concatenate(
        [ref.burst_samples(p, packet_index=i) for i, p in enumerate(payloads)]
    ).astype(np.complex64)


def _impair(x, cfo, noise, seed):
    rng = np.random.default_rng(seed)
    x = x * np.exp(1j * cfo * np.arange(x.shape[-1]))
    x = x + noise * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _ramp(*lens):
    return [(np.arange(n) % 256).astype(np.uint8) for n in lens]


def _same_packets(got, want, esn0_atol=1e-3):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.packet_type, g.channel, g.arm) == (w.index, w.packet_type, w.channel, w.arm)
        np.testing.assert_array_equal(g.data, w.data)
        assert abs(g.esn0_db - w.esn0_db) <= esn0_atol
        assert abs(g.freq - w.freq) <= 1e-6


def _both(cls_kw, x, chunk=None, **kw):
    """Run the JAX driver and the port's on ``x``; the port gets ``x`` in
    ``chunk``-sample pieces when given. Returns ``(port driver, port packets,
    JAX driver, JAX packets)``."""
    bank = x.ndim == 2
    cfg = cls_kw.pop("cfg")
    jcls = jstreaming.StreamingBank if bank else jstreaming.StreamingReceiver
    tcls = StreamingBank if bank else StreamingReceiver
    jkw = dict(kw)
    if jkw.get("transfer_dtype") is torch.int8:
        jkw["transfer_dtype"] = jnp.int8
    jd = jcls(JConfig(**cfg), **cls_kw, **jkw)
    want = jd.process(x) + jd.flush()
    td = tcls(RxConfig(**cfg), "cpu", **cls_kw, **kw)
    got = []
    step = chunk or x.shape[-1]
    for i in range(0, x.shape[-1], step):
        got += td.process(x[..., i : i + step])
    got += td.flush()
    return td, got, jd, want


# ------------------------------------------------------------------- wires


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "int4"])
def test_transfer_planes_match_jax(wire):
    """Bit-equal wire planes (rounding and clipping included) and equal
    complex samples back on the device side."""
    jd, td = {
        "f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
        "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
    }[wire]
    rng = np.random.default_rng(1)
    for shape in ((3, 4096), (5000,)):
        x = (0.9 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
        x.reshape(-1)[:3] = [3 + 3j, -3 - 3j, 0.5 / 64 + 0.5j / 3.5]  # clipped, rounded to even
        if wire in ("f32", "bf16"):
            x.reshape(-1)[3] = np.nan
        want = np.asarray(jcplx.to_transfer_planes(x, jd))
        got = to_transfer_planes(x, td)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        planes = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16) if wire == "bf16" else torch.from_numpy(got)
        back = planes_to_complex(planes, packed_int4=wire == "int4").numpy()
        np.testing.assert_array_equal(back, np.asarray(jcplx.planes_to_complex(jnp.asarray(want), wire == "int4")))


@pytest.mark.parametrize("budget", [None, 5, 40])
def test_result_wire_matches_jax(budget):
    rng = np.random.default_rng(2)
    rows, max_len = 16, 32
    cols = dict(
        idx=rng.integers(0, 1 << 20, rows), lens=rng.integers(1, max_len, rows),
        types=rng.integers(0, 2, rows), esn0=rng.standard_normal(rows).astype(np.float32),
        freq=rng.standard_normal(rows).astype(np.float32) * 1e-3, arm=rng.integers(0, 32, rows),
        chan=np.arange(rows) // 4, accepted=rng.permutation(rows) < 7,
        data=rng.integers(0, 256, (rows, max_len), dtype=np.uint8),
    )
    jcols = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in cols.items()}
    want = np.asarray(jstreaming.pack_result_wire(**jcols, det_overflow=jnp.bool_(True), budget=budget))
    got = pack_result_wire(
        **{k: torch.from_numpy(v) for k, v in cols.items()},
        det_overflow=torch.tensor(True), budget=budget,
    ).numpy()
    assert got.size == wire_bytes(rows, budget, max_len)
    np.testing.assert_array_equal(got, want)
    k = rows if budget is None else min(budget, rows)
    slots, det_ovf, budget_ovf = unpack_result_wire(got, k, max_len)
    jslots, jdet, jbud = jstreaming.unpack_result_wire(want, k, max_len)
    assert (det_ovf, budget_ovf) == (jdet, jbud) == (True, budget == 5)
    for name in slots:
        np.testing.assert_array_equal(slots[name], jslots[name], err_msg=name)


# ------------------------------------------------------- StreamingReceiver


@pytest.fixture(scope="module")
def six_packets():
    payloads = _ramp(10, 100, 200, 37, 256, 131)
    return payloads, _impair(_bursts(payloads), 0.006, 0.05, seed=0)


@pytest.mark.parametrize("backend", ["fft", "fused"])
def test_receiver_matches_jax(six_packets, backend):
    """tests/test_runtime.py:25-46 on both backends; the port takes the
    samples in odd-sized chunks, which must not change anything."""
    payloads, x = six_packets
    cfg = dict(max_payload_len=256, max_detections=8, acquisition_backend=backend)
    td, got, _, want = _both(dict(cfg=cfg, block=BLOCK), x, chunk=3000)
    _same_packets(got, want, esn0_atol=1e-3 if backend == "fft" else 1e-2)
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]
    assert got[0].index == 0
    assert td.overflow_blocks == 0 and td.stats["blocks"] > 0


def test_receiver_flush_on_block_boundary():
    """Input ending exactly on a block boundary keeps its tail packets
    (tests/test_runtime.py:71-93)."""
    payloads = _ramp(64, 128, 200)
    sig = _bursts(payloads)
    x = np.zeros(-(-sig.size // BLOCK) * BLOCK, np.complex64)
    x[x.size - sig.size :] = sig
    cfg = dict(max_payload_len=256, max_detections=8)
    td = StreamingReceiver(RxConfig(**cfg), "cpu", block=BLOCK)
    got = td.process(x)
    assert td._fill == 0  # block-aligned input leaves nothing staged
    got += td.flush()
    jd = jstreaming.StreamingReceiver(JConfig(**cfg), block=BLOCK)
    _same_packets(got, jd.process(x) + jd.flush())
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]


def test_receiver_overflow_warns_once():
    """Twelve short bursts in one block against 4 slots: the overflow flag
    is counted per block as in JAX and warned about once; 16 slots decode
    all twelve (tests/test_runtime.py:95-122). Which 4 of the near-equal
    peaks win the slots is not compared: top-k orders near-ties by
    rounding."""
    payloads = [((np.arange(8) + i) % 256).astype(np.uint8) for i in range(12)]
    x = _bursts(payloads)
    cfg = dict(max_payload_len=16, max_detections=4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        td, _, jd, _ = _both(dict(cfg=cfg, block=1 << 15), x)
    assert td.overflow_blocks == jd.overflow_blocks > 0
    assert sum("max_detections" in str(m.message) for m in w) == 2  # once per driver
    rx = StreamingReceiver(RxConfig(max_payload_len=16, max_detections=16), "cpu", block=1 << 15)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = rx.process(x) + rx.flush()
    assert rx.overflow_blocks == 0
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]


def test_receiver_result_budget_matches_jax():
    """A compacted wire (budget 6) gives JAX's packet list, all four
    packets; a budget of one drops and flags (tests/test_runtime.py:155-191)."""
    payloads = _ramp(60, 90, 128, 33)
    x = _impair(_bursts(payloads), 0.004, 0.03, seed=3)
    cfg = dict(max_payload_len=128, max_detections=8)
    td, got, jd, want = _both(dict(cfg=cfg, block=BLOCK), x, result_budget=6)
    _same_packets(got, want)
    assert [p.data.tobytes() for p in got] == [p.tobytes() for p in payloads]
    assert td.budget_overflow_blocks == jd.budget_overflow_blocks == 0
    one = StreamingReceiver(RxConfig(**cfg), "cpu", block=BLOCK, result_budget=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        few = one.process(x) + one.flush()
    assert one.budget_overflow_blocks >= 1 and 0 < len(few) < len(payloads)
    assert sum("result_budget" in str(m.message) for m in w) == 1


def test_receiver_logs_one_line_per_packet(caplog):
    x = _bursts(_ramp(70))
    rx = StreamingReceiver(RxConfig(max_payload_len=128, max_detections=4), "cpu", block=BLOCK, log=True)
    with caplog.at_level(logging.INFO, logger="gr4_packet_modem_tpu_torch.rx"):
        pkts = rx.process(x) + rx.flush()
    assert len(pkts) == 1
    lines = [r.message for r in caplog.records]
    assert len(lines) == 1 and "len=70" in lines[0] and "esn0=" in lines[0] and "arm=" in lines[0]


# ----------------------------------------------------------- StreamingBank

BANK_CFG = dict(max_payload_len=128, max_detections=4, freq_bins=1)


def test_bank_matches_jax_exactly_once():
    """Two channels, staggered so packets straddle block boundaries
    differently (tests/test_streaming_bank.py:30-59)."""
    rng = np.random.default_rng(5)
    ch_payloads = [[rng.integers(0, 256, n, dtype=np.uint8) for n in lens]
                   for lens in ([100, 77, 128], [55, 120, 33])]
    streams = [_bursts(p) * np.exp(0.4j * c) for c, p in enumerate(ch_payloads)]
    x = np.zeros((2, max(s.size for s in streams) + 3000), np.complex64)
    x[0, 100 : 100 + streams[0].size] = streams[0]
    x[1, 2500 : 2500 + streams[1].size] = streams[1]
    td, got, _, want = _both(dict(cfg=BANK_CFG, block=BLOCK, channels=2, group=0), x, chunk=5000)
    _same_packets(got, want)
    for c in (0, 1):
        datas = [p.data.tobytes() for p in sorted(got, key=lambda p: p.index) if p.channel == c]
        assert datas == [p.tobytes() for p in ch_payloads[c]]


def test_bank_groups_match_jax_and_one_group():
    """group=2 on four channels equals the JAX bank with groups and the
    port's single group (tests/test_streaming_bank.py:120-138)."""
    stream = _bursts([np.random.default_rng(7).integers(0, 256, 64, dtype=np.uint8)])
    x = np.zeros((4, 2 * BLOCK), np.complex64)
    for c in range(4):
        x[c, 200 * c : 200 * c + stream.size] = stream * np.exp(0.3j * c)
    _, got, _, want = _both(dict(cfg=BANK_CFG, block=BLOCK, channels=4, group=2), x)
    assert len(got) == 4
    _same_packets(got, want)
    one = StreamingBank(RxConfig(**BANK_CFG), "cpu", channels=4, block=BLOCK, group=0)
    _same_packets(one.process(x) + one.flush(), got)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_bank_quantised_wire_matches_jax(wire):
    """int8 and packed-int4 wires decode byte-exact, as in JAX
    (tests/test_streaming_bank.py:62-117); int4 with channel noise. The
    port takes odd-sized pieces, so int4 pairs samples across them."""
    rng = np.random.default_rng(6 if wire == "int8" else 8)
    payloads = [rng.integers(0, 256, 90, dtype=np.uint8) for _ in range(2)]
    stream = _bursts(payloads)
    x = np.zeros((2, stream.size + 1000), np.complex64)
    for c in range(2):
        o = (50 + 17 * c) if wire == "int8" else (40 + 13 * c)
        x[c, o : o + stream.size] = stream
    if wire == "int4":
        x = _impair(x, 0.0, 0.05, seed=4)
    dtype = torch.int8 if wire == "int8" else "int4"
    _, got, _, want = _both(
        dict(cfg=BANK_CFG, block=BLOCK, channels=2, group=0), x, chunk=3001, transfer_dtype=dtype
    )
    _same_packets(got, want)
    assert len(got) == 4
    for c in range(2):
        assert [p.data.tobytes() for p in got if p.channel == c] == [p.tobytes() for p in payloads]


def test_drivers_reject_blocks_the_wire_cannot_carry():
    """Indices travel buffer-local as float32, exact below 2**24; int4
    packs sample pairs, so its block must be even."""
    cfg = RxConfig(**BANK_CFG)
    with pytest.raises(ValueError, match="2\\^24"):
        StreamingReceiver(cfg, "cpu", block=1 << 24)
    with pytest.raises(ValueError, match="even"):
        StreamingBank(cfg, "cpu", channels=2, block=4097, transfer_dtype="int4")
