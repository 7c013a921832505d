"""The frozen copies in ``reference/`` equal the port's modules they were
taken from, so the stimulus is the port's stimulus bit for bit."""

import filecmp

import numpy as np

from gr4_packet_modem_tpu_torch.utils import constants as PC, firdes as PF, lfsr as PL, stimulus as PS
from h100_bench.reference import constants as C, firdes as F, lfsr as L, stimulus as S

from .conftest import BENCH, ROOT


def test_data_files_equal():
    for name in ("header_ldpc.alist", "header_ldpc_generator.npy", "rrc_taps_golden.npz"):
        assert filecmp.cmp(BENCH / "reference" / "data" / name,
                           ROOT / "gr4_packet_modem_tpu_torch" / "data" / name, shallow=False)


def test_constants_taps_and_sequences_equal():
    for name in ("SYNCWORD", "BPSK_CONSTELLATION", "QPSK_CONSTELLATION"):
        assert np.array_equal(getattr(C, name), getattr(PC, name))
    assert np.array_equal(F.tx_rrc_taps(4), PF.tx_rrc_taps(4))
    assert np.array_equal(F.rx_pfb_taps(4, 32), PF.rx_pfb_taps(4, 32))
    assert np.array_equal(L.additive_scrambler_keystream(500), PL.additive_scrambler_keystream(500))
    assert np.array_equal(L.glfsr_bits(300), PL.glfsr_bits(300))


def test_stimulus_bit_for_bit():
    rng = np.random.default_rng(3)
    for i, n in enumerate((1, 37, 1500)):
        p = rng.integers(0, 256, n, dtype=np.uint8)
        a, b = S.burst_samples(p, i), PS.burst_samples(p, i)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
