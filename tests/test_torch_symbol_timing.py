"""Symbol timing at the fractional-sample boundaries, on the port.

tests/test_symbol_timing.py's three tests on the port's receiver, with the
same delays, bounds and stimulus (symbol_filter.hpp:141-202): the PFB arm
only goes forward in time, so a negative ``time_est`` adds one to the
clock phase, shifts the base sample back one and takes ``-freq`` off the
syncword phase. A dropped or sign-flipped adjustment is a half-sample
timing error that costs about 10 dB of syncword EVM. Beside the bounds,
the port's ``time_est`` and ``_timing`` (arm, base sample, phase) are held
against the JAX receiver's on the same samples: arm and base sample
exact, the phase to rtol 1e-6. Both ``round`` half to even, so the
contract's ``te = -0.015625`` (32 * (te + 1) = 31.5) lands on arm 31 on
both.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import Detections as JDetections  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.acquire import Detections  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat  # noqa: E402

PAYLOAD = (np.arange(96) % 256).astype(np.uint8)
OFFSET = 500
BUF = 8192
DELAYS = [-0.499, -0.45, -0.25, -0.05, 0.0, 0.05, 0.26, 0.45, 0.499]
RX_KW = dict(max_payload_len=128, max_detections=4, freq_bins=1)


def _frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    """Delay ``x`` by ``d`` samples (band-limited, exact for the RRC
    signal's < 0.25-Nyquist occupancy)."""
    n = 1 << int(np.ceil(np.log2(x.size + 256)))
    xp = np.zeros(n, np.complex128)
    xp[: x.size] = x
    f = np.fft.fftfreq(n)
    y = np.fft.ifft(np.fft.fft(xp) * np.exp(-2j * np.pi * f * d))
    return y[: x.size].astype(np.complex64)


@pytest.fixture(scope="module")
def rx():
    return Receiver(RxConfig(**RX_KW), "cpu")


@pytest.fixture(scope="module")
def jrx():
    return JReceiver(JConfig(**RX_KW, acquisition_backend="fft", use_pallas=False))


@pytest.fixture(scope="module")
def clean_signal():
    tx = Transmitter(TxConfig(max_payload_len=128), "cpu")
    s, n = tx.modulate_bursts(PacketBatch.from_list([PAYLOAD], 128, "cpu"))
    stream, _ = ragged_concat(s, n, int(n.sum()))
    buf = np.zeros(BUF, np.complex64)
    buf[OFFSET : OFFSET + stream.numel()] = stream.numpy()
    return buf


def _padded(rx, x: np.ndarray) -> np.ndarray:
    return np.concatenate([
        np.zeros(rx.front_pad, np.complex64), x, np.zeros(rx.pad_tail(), np.complex64),
    ])


def _as_port(jdet) -> Detections:
    """JAX detections as the port's (integer fields as int64)."""
    def conv(name):
        a = np.asarray(getattr(jdet, name))
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a.copy())

    return Detections(**{f.name: conv(f.name) for f in dataclasses.fields(Detections)})


def _held_to_jax(rx, jrx, xp, det):
    """Row 0 against the JAX receiver on the same padded samples: the
    detection (index exact, ``time_est`` within 1e-5, phase within 1e-6
    rad, two FFTs apart), ``_timing`` of each receiver's own detection
    (arm and base sample exact), and the port's ``_timing`` of the JAX
    detection against the JAX ``_timing`` (arm and base sample exact,
    phase to rtol 1e-6). Row 0 is the syncword; on this noiseless capture
    the later rows are hits at the float rounding floor (amplitude about
    1e-8), which each FFT places differently."""
    jdet = jrx.acquirer.acquire(jnp.asarray(xp), index0=0)
    assert bool(det.valid[0]) and bool(jdet.valid[0])
    assert int(det.index[0]) == int(jdet.index[0])
    np.testing.assert_allclose(float(det.time_est[0]), float(jdet.time_est[0]), atol=1e-5)
    np.testing.assert_allclose(float(det.phase[0]), float(jdet.phase[0]), atol=1e-6)
    want = [np.asarray(t)[0] for t in jrx._timing(jdet)]
    own = [t[0].item() for t in rx._timing(det)]
    assert own[:2] == [int(want[0]), int(want[1])]  # arm, base sample
    got = [t[0].item() for t in rx._timing(_as_port(jdet))]
    assert got[:2] == [int(want[0]), int(want[1])]
    np.testing.assert_allclose(got[2], float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("delay", DELAYS)
def test_fractional_delay_decode_and_evm(rx, jrx, clean_signal, delay):
    xp = _padded(rx, _frac_delay(clean_signal, delay))
    x = torch.from_numpy(xp)
    det = rx.acquirer.acquire(x)
    # the true syncword start is the earliest detection (row 0); later rows
    # may hold in-packet false hits that filter_detections suppresses
    assert bool(det.valid[0])
    te = float(det.time_est[0])
    # the sub-sample estimate reproduces the injected fraction (mod 1
    # sample; at +-0.5 either side of the boundary is fine)
    err = (te - delay + 0.5) % 1.0 - 0.5
    assert abs(err) < 0.06, f"time_est {te} vs injected {delay}"
    _held_to_jax(rx, jrx, xp, det)
    hdr, corrected = rx.decode_headers(x, det)
    assert bool(hdr.header_ok[0])
    # the wiped-off syncword after the arm's matched filter, Costas and
    # amplitude normalisation is a unit pilot; a half-sample timing error
    # costs about 10 dB of EVM and fails this bound
    sync = corrected[0, : C.SYNCWORD_LEN].numpy()
    evm = float(np.mean(np.abs(sync - 1.0) ** 2))
    assert evm < 0.005, f"syncword EVM {evm:.4f} at delay {delay}"
    _, keep = rx.filter_detections(det, hdr)
    res = rx.decode_payloads(x, det, hdr, keep)
    assert bool(res.accepted[0])
    np.testing.assert_array_equal(res.data[0, : PAYLOAD.size].numpy(), PAYLOAD)


def test_negative_time_est_with_cfo(rx, jrx, clean_signal):
    """The negative branch's phase adjustment (syncword_phase -=
    syncword_freq, symbol_filter.hpp:152-156) under a CFO that matters."""
    cfo = 0.006
    x = _frac_delay(clean_signal, -0.45)
    x = (x * np.exp(1j * cfo * np.arange(x.size))).astype(np.complex64)
    xp = _padded(rx, x)
    xt = torch.from_numpy(xp)
    det = rx.acquirer.acquire(xt)
    assert bool(det.valid[0]) and float(det.time_est[0]) < 0
    _held_to_jax(rx, jrx, xp, det)
    hdr, corrected = rx.decode_headers(xt, det)
    assert bool(hdr.header_ok[0])
    # the pilot loop pulls in the residual frequency over the syncword, so
    # only the tail after it converges is bounded
    sync = corrected[0, : C.SYNCWORD_LEN].numpy()
    tail_evm = float(np.mean(np.abs(sync[48:] - np.mean(sync[48:])) ** 2))
    assert tail_evm < 0.02
    _, keep = rx.filter_detections(det, hdr)
    res = rx.decode_payloads(xt, det, hdr, keep)
    assert bool(res.accepted[0])


def test_timing_contract():
    """``_timing`` against the reference's rule (symbol_filter.hpp:160-202)
    and against the JAX receiver's ``_timing`` on the same detections:
    arm = clamp(round(32 te'), 0, 31) with te' = te + 1, a one-sample base
    shift and phase -= freq where te < 0."""
    rx = Receiver(RxConfig(max_payload_len=64, max_detections=8, freq_bins=1), "cpu")
    jrx = JReceiver(JConfig(max_payload_len=64, max_detections=8, freq_bins=1, use_pallas=False))
    te = np.array([0.0, 0.2, 0.499, -0.2, -0.015625, -0.5, 0.5, -0.499], np.float32)
    d = te.size
    fields = dict(
        index=np.full(d, 1000), valid=np.ones(d, bool), amplitude=np.ones(d, np.float32),
        phase=np.full(d, 0.3, np.float32), freq=np.full(d, 0.01, np.float32),
        freq_bin=np.zeros(d), time_est=te, noise_power=np.zeros(d, np.float32),
        esn0_db=np.zeros(d, np.float32), overflow=np.asarray(False),
    )
    det = Detections(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()})
    jdet = JDetections(**{
        k: jnp.asarray(v, jnp.int32 if k in ("index", "freq_bin") else None)
        for k, v in fields.items()
    })
    arm, n_base, phase0 = (t.numpy() for t in rx._timing(det))
    neg = te < 0
    te_adj = np.where(neg, te + 1.0, te)
    np.testing.assert_array_equal(arm, np.clip(np.round(32 * te_adj), 0, 31).astype(np.int64))
    assert arm[4] == 31  # 31.5 rounds half to even
    np.testing.assert_array_equal(n_base, 1000 + rx.filter_delay - neg.astype(np.int64))
    np.testing.assert_allclose(phase0, np.where(neg, 0.3 - 0.01, 0.3), rtol=1e-6)
    jarm, jn_base, jphase0 = map(np.asarray, jrx._timing(jdet))
    np.testing.assert_array_equal(arm, jarm)
    np.testing.assert_array_equal(n_base, jn_base)
    np.testing.assert_allclose(phase0, jphase0, rtol=1e-6)
