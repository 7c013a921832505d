"""The two public names of the JAX package that its examples and scripts
use outside the package, on the port:

- ``CrcEngine`` / ``make_crc32_engine`` (examples/crc.py): CRC words equal
  to the JAX engine's on random rows and lengths, 0 and ``max_len``
  included, and to ``CrcRef``;
- ``SyncwordAcquirer.correlate`` (tests/test_acquire.py,
  scripts/roofline.py): within 1e-4 of the largest correlation of the JAX
  acquirer's fft backend, on one capture and on a bank.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.ops import acquire as jacquire  # noqa: E402
from gr4_packet_modem_tpu.ops import crc as jcrc  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import acquire, crc  # noqa: E402


@pytest.mark.parametrize("max_len", [1, 32, 200])
def test_crc_engine_equals_jax_engine(max_len):
    rng = np.random.default_rng(max_len)
    b = 24
    data = rng.integers(0, 256, (b, max_len), dtype=np.uint8)
    lengths = rng.integers(0, max_len + 1, b).astype(np.int32)
    lengths[:2] = [0, max_len]
    want = np.asarray(jcrc.make_crc32_engine(max_len).compute(jnp.asarray(data), jnp.asarray(lengths)))
    engine = crc.make_crc32_engine(max_len)
    assert engine is crc.make_crc32_engine(max_len) and engine.max_len == max_len
    got = engine.compute(torch.from_numpy(data), torch.from_numpy(lengths))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    ref = crc.CrcRef()
    assert [ref.compute(data[i, : lengths[i]]) for i in range(b)] == got.tolist()


def test_crc_engine_refuses_other_widths():
    with pytest.raises(ValueError, match=r"\[B, 32\]"):
        crc.CrcEngine(32).compute(torch.zeros(2, 16, dtype=torch.uint8), torch.zeros(2))


@pytest.mark.parametrize("bank", [False, True])
def test_correlate_equals_jax_fft_backend(bank):
    rng = np.random.default_rng(7)
    t = 3 * 2048 + 123
    x = (rng.standard_normal((2, t)) + 1j * rng.standard_normal((2, t))).astype(np.complex64)
    jacq = jacquire.SyncwordAcquirer(jacquire.AcquisitionConfig(freq_bins=2, backend="fft"))
    want = np.stack([np.asarray(jacq.correlate(jnp.asarray(row))) for row in x])
    acq = acquire.SyncwordAcquirer(acquire.AcquisitionConfig(freq_bins=2), "cpu")
    assert acq.backend == "fft"
    got = (acq.correlate(torch.from_numpy(x)) if bank
           else torch.stack([acq.correlate(torch.from_numpy(row)) for row in x])).numpy()
    assert got.shape == want.shape == (2, 5, want.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
