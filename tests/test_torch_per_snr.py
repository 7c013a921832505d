"""The statistical PER check of tests/test_per_snr.py on the port.

``entry.per_curve`` runs the port's transmitter, ``rotate``, ``awgn`` at
``esn0_db_to_noise_sigma`` and one ``Receiver.bank_step`` at that file's
sizes (24 random 200-byte packets a row, ``max_payload_len=256``, 48
detection slots), and must meet its four brackets, no wider. Torch's
generator is not JAX's, so those cases compare statistics; the last case
feeds the same numpy-made noisy samples to the JAX receiver and the port's
(CPU, plain versions) and compares the decoded bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.entry import (  # noqa: E402
    PER_PACKETS,
    PER_PAYLOAD_LEN,
    per_config,
    per_curve,
    per_sets,
    per_signal,
)
from gr4_packet_modem_tpu_torch.models.channel import esn0_db_to_noise_sigma  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver  # noqa: E402


def _per(esn0, carrier="costas", channels=1):
    return per_curve("cpu", esn0, carrier=carrier, channels=channels, seed=0)[0]["per"]


def _mean_per(esn0, carrier="costas"):
    """PER over 10 rows of 24 packets, each row its own payloads and noise:
    the reference's 10 seeds of 24 packets as one bank step."""
    return _per(esn0, carrier, channels=10)


def test_operating_point_error_free():
    assert _per(20.0) == 0.0


def test_monotonic_degradation():
    pers = [p["per"] for p in per_curve("cpu", [20.0, 8.0, 2.0], channels=1, seed=0)]
    assert pers[0] == 0.0
    assert pers[2] > 0.5
    assert pers[0] <= pers[1] <= pers[2] + 1e-9


def test_uncoded_qpsk_theory_midpoint():
    """Es/N0 = 11 dB, 10 x 24 packets: the reference's bracket [0.17,
    0.38] around the uncoded-QPSK PER of about 0.27."""
    mean_per = _mean_per(11.0)
    assert 0.17 <= mean_per <= 0.38, f"PER@11dB = {mean_per}"


def test_vv_costas_per_parity():
    """V&V error-free at 20 dB; at 11 dB the two carriers' PER over 10 x 24
    packets within 0.09 of each other."""
    assert _per(20.0, carrier="vv") == 0.0
    mc, mv = _mean_per(11.0, "costas"), _mean_per(11.0, "vv")
    assert abs(mc - mv) < 0.09, f"costas {mc} vs vv {mv}"


@pytest.mark.parametrize("esn0", [8.0, 11.0])
def test_same_samples_as_jax(esn0):
    """Two rows of 24 packets with noise made by numpy, through the JAX
    receiver and the port's: the decoded payloads (every accepted row's
    bytes) are equal, but for at most one packet a point, which a soft
    decision within rounding of its threshold may flip; any packet that
    differs is named. Below the payload's limit the header (rate 1/8)
    still decodes: both receivers find every packet's length."""
    from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver
    from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig

    cfg = per_config("costas")
    x, payloads, power = per_signal("cpu", channels=2, seed=5)
    rng = np.random.default_rng(int(esn0))
    sigma = esn0_db_to_noise_sigma(esn0, power)
    x = x.numpy()
    noisy = (x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(
        np.complex64
    )

    rx = Receiver(cfg, "cpu")
    jrx = JReceiver(JConfig(max_payload_len=cfg.max_payload_len, max_detections=cfg.max_detections,
                            payload_carrier=cfg.payload_carrier))
    names = {p.tobytes(): f"row {c} packet {i}" for c, row in enumerate(payloads) for i, p in enumerate(row)}
    differ, decoded = [], 0
    for c in range(2):
        res = rx.receive(noisy[c])
        _, (got,) = per_sets(res, [payloads[c]])
        jres = jrx.receive(noisy[c])
        acc, lens, data = (np.asarray(a) for a in (jres.accepted, jres.lengths, jres.data))
        want = [data[i, : lens[i]].tobytes() for i in np.nonzero(acc)[0]]
        decoded += len(want)
        n_hdr = int((res.lengths == PER_PAYLOAD_LEN).sum())
        assert n_hdr == int((np.asarray(jres.lengths) == PER_PAYLOAD_LEN).sum()) == PER_PACKETS
        for side, a, b in (("port", got, want), ("JAX", want, got)):
            differ += [f"{names.get(p, 'a foreign packet')} decoded by the {side} receiver only"
                       for p in sorted(set(a) - set(b))]
        assert sorted(got) == sorted(set(got)) and sorted(want) == sorted(set(want))
    print(f"{esn0} dB: {decoded} of {2 * PER_PACKETS} packets decoded by JAX; differing: {differ}")
    assert len(differ) <= 1, differ
