"""The port's channel groups (``Receiver.bank_step(x, group)``) and kept
payload symbols (``RxConfig.keep_payload_symbols``) against the JAX
package.

Grouped bank steps are held bit for bit against the JAX receiver's
grouped step and against the port's own single batch (``group=0``) on
valid rows: ``valid``, ``index``, ``overflow``, ``keep``, ``accepted``,
lengths and bytes. Acquisition and suppression are per channel, so every
group size must give the same rows. The kept payload symbols agree with
JAX's within 1e-4 (the tolerance of the matched filter's and the loop's
float32 sums) on accepted rows. Waveforms come from the JAX transmitter;
carrier offset and noise are applied with numpy from a seed. The JAX side
runs with ``use_pallas=False`` and the fft acquisition backend; the port's
receivers compute from the JAX receivers' own tables.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import Transmitter as JTransmitter  # noqa: E402
from gr4_packet_modem_tpu.models.transmitter import TxConfig as JTxConfig  # noqa: E402
from gr4_packet_modem_tpu.utils.ragged import PacketBatch as JBatch  # noqa: E402
from gr4_packet_modem_tpu.utils.ragged import ragged_concat as j_ragged_concat  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import numpy_tables_of, tables_from_numpy  # noqa: E402

BANK_KW = dict(max_payload_len=128, max_detections=8, freq_bins=1)


def _bursts(payloads, max_len):
    tx = JTransmitter(JTxConfig(max_payload_len=max_len))
    s, n = tx.modulate_bursts(JBatch.from_list(payloads, max_len=max_len))
    stream, _ = j_ragged_concat(s, n, int(np.sum(np.asarray(n))))
    return np.asarray(stream)


def _impair(x, cfo, noise, seed):
    rng = np.random.default_rng(seed)
    x = x * np.exp(1j * cfo * np.arange(x.size))
    x = x + noise * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64)


def _pair(**kw):
    jrx = JReceiver(JConfig(**kw, acquisition_backend="fft", use_pallas=False))
    rx = Receiver(RxConfig(**kw, acquisition_backend="fft"), "cpu")
    rx.load_tables(tables_from_numpy(numpy_tables_of(jrx)))
    return jrx, rx


def _bank(channels, seed):
    """Staggered bursts on ``channels`` channels, each with its own CFO, so
    the same index ranges overlap across channels
    (tests/test_bank_decode.py)."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (50, 96, 128)]
    burst = _bursts(payloads, 128)
    jrx, rx = _pair(**BANK_KW)
    fp, pt, n = rx.front_pad, rx.pad_tail(), 16384
    x = np.zeros((channels, fp + n + pt), np.complex64)
    for c in range(channels):
        sig = np.zeros(n, np.complex64)
        sig[37 + 401 * c : 37 + 401 * c + burst.size] = burst
        x[c, fp : fp + n] = _impair(sig, 0.002 * (c - 1), 0.02, seed=c)
    return jrx, rx, x, payloads


@pytest.fixture(scope="module")
def bank3():
    return _bank(3, 42)


def _rows(det, hdr, res, keep):
    """The compared rows as numpy: valid mask, then the fields."""
    v = np.asarray(det.valid)
    return v, {
        "index": np.asarray(det.index)[v],
        "overflow": bool(np.asarray(det.overflow)),
        "keep": np.asarray(keep),
        "accepted": np.asarray(res.accepted),
        "packet_length": np.asarray(hdr.packet_length)[v],
        "lengths": np.asarray(res.lengths)[v],
        "data": np.asarray(res.data)[v],
    }


def _assert_same(got, want):
    gv, g = _rows(*got)
    wv, w = _rows(*want)
    np.testing.assert_array_equal(gv, wv)
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _port(result):
    det, hdr, res, keep = result
    return det.map(lambda a: a.numpy()), hdr, res, keep.numpy()


@pytest.mark.parametrize("group", [0, 1, 16])
def test_bank_step_groups_match_jax(bank3, group):
    """g=1 runs three groups of one channel; g=16 and g=0 one batch (16
    does not divide 3)."""
    jrx, rx, x, payloads = bank3
    got = rx.bank_step(torch.from_numpy(x), group)
    _assert_same(_port(got), jrx.bank_step(x, group))
    _assert_same(_port(got), _port(rx.bank_step(torch.from_numpy(x), 0)))
    res = got[2]
    assert int(res.accepted.sum()) == x.shape[0] * len(payloads)


def test_bank_step_group2_on_four_channels():
    """Two groups of two on a four-channel bank, against JAX's grouped step
    and the port's one batch, field by field bit for bit (header loop state
    and payload symbols included)."""
    jrx, rx, x, payloads = _bank(4, 7)
    xt = torch.from_numpy(x)
    got = rx.bank_step(xt, 2)
    _assert_same(_port(got), jrx.bank_step(x, 2))
    one = rx.bank_step(xt, 0)
    for a, b in zip(got[:3], one[:3]):
        for name, va in vars(a).items():
            assert torch.equal(va, getattr(b, name)), name
    assert torch.equal(got[3], one[3])
    assert int(got[2].accepted.sum()) == 4 * len(payloads)


def test_bank_step_group_rule_and_default():
    """A group that does not divide the channel count runs one batch; the
    default is the JAX package's 16."""
    assert inspect.signature(Receiver.bank_step).parameters["group"].default == 16
    assert inspect.signature(JReceiver.bank_step).parameters["group"].default == 16
    rx = Receiver(RxConfig(**BANK_KW), "cpu")
    x = torch.zeros(3, rx.front_pad + 4096 + rx.pad_tail(), dtype=torch.complex64)
    calls = []
    acquire = rx.acquirer.acquire
    rx.acquirer.acquire = lambda g: calls.append(g.shape[0]) or acquire(g)
    for group, sizes in ((2, [3]), (3, [3]), (0, [3]), (-1, [3]), (1, [1, 1, 1])):
        calls.clear()
        rx.bank_step(x, group)
        assert calls == sizes, group


@pytest.fixture(scope="module")
def symbol_pair():
    kw = dict(max_payload_len=128, max_detections=8, keep_payload_symbols=True)
    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in (30, 128, 77)]
    x = _impair(_bursts(payloads, 128), 0.004, 0.05, seed=11)
    jrx, rx = _pair(**kw)
    return jrx, rx, x, kw


def test_payload_symbols_match_jax(symbol_pair):
    """``PayloadResult.symbols`` ``[D, S, 2]`` float32 within 1e-4 of JAX's
    on accepted rows."""
    jrx, rx, x, _ = symbol_pair
    want = jrx.receive(x)
    got = rx.receive(x)
    acc = np.asarray(want.accepted)
    np.testing.assert_array_equal(got.accepted.numpy(), acc)
    assert acc.sum() == 3
    s = rx.config.max_payload_syms
    assert got.symbols.shape == (acc.size, s, 2) and got.symbols.dtype == torch.float32
    np.testing.assert_allclose(got.symbols.numpy()[acc], np.asarray(want.symbols)[acc], atol=1e-4, rtol=0)


def test_payload_symbols_off_and_in_bank(symbol_pair):
    """Off by default: ``[D, 0, 2]``, as in JAX. On, a grouped bank step
    carries them for every row."""
    _, _, x, kw = symbol_pair
    off = Receiver(RxConfig(**{**kw, "keep_payload_symbols": False}), "cpu").receive(x)
    assert off.symbols.shape == (off.accepted.shape[0], 0, 2) and off.symbols.dtype == torch.float32
    rx = Receiver(RxConfig(**kw, acquisition_backend="fft"), "cpu")
    bank = torch.from_numpy(np.stack([rx.pad(x).numpy()] * 2))
    _, _, res, _ = rx.bank_step(bank, 1)
    assert res.symbols.shape == (2 * kw["max_detections"], rx.config.max_payload_syms, 2)
    one = rx.receive(x)
    np.testing.assert_array_equal(res.symbols[: kw["max_detections"]].numpy(), one.symbols.numpy())
