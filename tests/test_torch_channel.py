"""The port's channel models against the JAX package's.

``rotate`` within 1e-5 of JAX's (float32 cos/sin of the same split phase)
at stream offsets 0 and 10**6, and accurate to 5e-3 rad over 2**20
samples as tests/test_costas_channel.py requires of JAX's. A negative
offset is the port's conjugated mirror (``rotate``'s docstring), held to
the conjugate of JAX's rotation of ``conj(x)`` by ``-w`` from ``-phase0``,
and accurate to 5e-4 rad at -0.006 rad/sample over 2**20 samples, where
JAX's loses ~3e-3;
a bank's per-row offsets and phases give each row the scalar call's
samples bit for bit; the resampler's
prototype ``pfb_arb_taps`` bit for bit; ``sfo`` within 1e-4 abs of JAX's
on a unit-power stream (the same float32 time base, sums in another
order). torch's generators and JAX's differ, so ``awgn`` is held to its
statistics at 10**6 samples: mean within 5 standard errors of 0, each
component's standard deviation within 1 %, I/Q correlation below 0.01;
one seed gives one noise, two seeds two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.models import channel as jchannel  # noqa: E402
from gr4_packet_modem_tpu_torch.models import channel  # noqa: E402


def _unit_stream(n, seed):
    rng = np.random.default_rng(seed)
    return (np.exp(2j * np.pi * rng.random(n))).astype(np.complex64)


@pytest.mark.parametrize("n0", [0, 10**6])
@pytest.mark.parametrize("w", [0.005, -0.02, 7.5])
def test_rotate_matches_jax(n0, w):
    x = _unit_stream(1 << 16, 1)
    if w % (2 * np.pi) > np.pi:  # a negative offset: the conjugated mirror
        want = np.conj(np.asarray(jchannel.rotate(jnp.asarray(np.conj(x)), -w, phase0=-0.3, n0=n0)))
    else:
        want = np.asarray(jchannel.rotate(jnp.asarray(x), w, phase0=0.3, n0=n0))
    got = channel.rotate(torch.from_numpy(x), w, phase0=0.3, n0=n0)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_rotate_phase_accuracy():
    n, w = 1 << 20, 0.006
    y = channel.rotate(torch.ones(n, dtype=torch.complex64), w).numpy()
    expected = np.exp(1j * w * np.arange(n))
    err = np.angle(y[-1000:] * np.conj(expected[-1000:]))
    assert np.abs(err).max() < 5e-3


def test_rotate_negative_offset_accuracy():
    n, w = 1 << 20, -0.006
    y = channel.rotate(torch.ones(n, dtype=torch.complex64), w, phase0=-2.0).numpy()
    err = np.angle(y * np.conj(np.exp(1j * (-2.0 + w * np.arange(n)))))
    assert np.abs(err).max() < 5e-4


def test_rotate_rows_equal_scalar():
    """Per-row offsets and phases (a bank's links, both signs, one offset
    past 2*pi) against the scalar call on each row, bit for bit, at stream
    offsets 0 and 10**6. One thread: the CPU's vector and scalar sin and
    cos differ in the last bit, and threads cut rows where they like."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _rows_equal_scalar()
    finally:
        torch.set_num_threads(threads)


def _rows_equal_scalar():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.stack([_unit_stream(1 << 14, s) for s in range(5)]))
    w = np.array([0.006, -0.006, -0.004, 0.0, 7.5])
    p = rng.uniform(-np.pi, np.pi, 5)
    for n0 in (0, 10**6):
        got = channel.rotate(x, torch.from_numpy(w), torch.from_numpy(p), n0=n0)
        for i in range(5):
            assert torch.equal(got[i], channel.rotate(x[i], float(w[i]), float(p[i]), n0=n0)), (n0, i)


def test_pfb_arb_taps_bit_equal():
    taps = channel.pfb_arb_taps()
    want = jchannel.pfb_arb_taps()
    assert taps.dtype == want.dtype == np.float32 and taps.shape == want.shape == (1280,)
    assert taps.tobytes() == want.tobytes()
    assert not taps.flags.writeable


@pytest.mark.parametrize("ppm,num_out", [(1.2, None), (100.0, 8000)])
def test_sfo_matches_jax(ppm, num_out):
    x = _unit_stream(8192, 2)
    want = np.asarray(jchannel.sfo(jnp.asarray(x), ppm, num_out))
    got = channel.sfo(torch.from_numpy(x), ppm, num_out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_sfo_resamples_a_tone():
    """tests/test_costas_channel.py's tone through 100 ppm."""
    n, f0 = 8192, 0.01
    x = torch.from_numpy(np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64))
    y = channel.sfo(x, ppm=100.0, num_out=n - 64).numpy()[64:-64]
    f_out = (np.angle(y[1:] * np.conj(y[:-1])) / (2 * np.pi)).mean()
    assert abs(f_out - f0 / (1 + 1e-4)) < 1e-5


def test_awgn_statistics():
    n, amp = 10**6, 0.5
    g = torch.Generator().manual_seed(3)
    y = channel.awgn(torch.zeros(n, dtype=torch.complex64), amp, g).numpy()
    assert y.dtype == np.complex64
    for part in (y.real, y.imag):
        assert abs(part.mean()) < 5 * amp / np.sqrt(n)
        assert abs(part.std() / amp - 1) < 0.01
    assert abs(np.corrcoef(y.real, y.imag)[0, 1]) < 0.01
    x = torch.from_numpy(_unit_stream(1000, 4))
    a = channel.awgn(x, 0.05, torch.Generator().manual_seed(9))
    b = channel.awgn(x, 0.05, torch.Generator().manual_seed(9))
    c = channel.awgn(x, 0.05, torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.allclose(a, x, atol=0.5)


@pytest.mark.parametrize("esn0,power,sps", [(20.0, 0.25, 4), (3.5, 1.0, 2), (-2.0, 0.1, 8)])
def test_esn0_to_sigma_equal(esn0, power, sps):
    assert channel.esn0_db_to_noise_sigma(esn0, power, sps) == jchannel.esn0_db_to_noise_sigma(esn0, power, sps)
