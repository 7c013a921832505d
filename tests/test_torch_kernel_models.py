"""Numpy models of the schedules of the K1 and K3 CUDA kernels.

The kernels run only on the card; their schedules are tested here. K1's
model runs the kernel's passes (radices, each thread's 16 points, the
inter-pass twiddles built from the wrapper's float64 bases as the kernel
builds them, the exchanges between passes) from the wrapper's own tables
(``kernel_plan``), and is held against ``numpy.fft`` at every transform
size the kernel takes, so a fault in the tables or the replica permutation
shows here. The exchange buffers' swizzle is checked free of bank
conflicts. K3's phase-split model (``phase_split_reference``, the
kernel's order of sums) is held against the plain version that the CPU
route runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.ops.acquire_cuda import (  # noqa: E402
    KERNEL_FFT_SIZES,
    POINTS,
    fused_best_power_plain,
    kernel_passes,
    kernel_plan,
    kernel_positions,
    replica_table,
)
from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter_plain  # noqa: E402


def _twiddle_powers(b1, b2, b4, b8):
    """W^k, k < 16, from the bases W, W^2, W^4, W^8 by the kernel's
    products (csrc/correlate.cu, butterflies)."""
    w = [np.ones_like(b1), b1, b2, b1 * b2, b4]
    w += [b4 * w[1], b4 * w[2], b4 * w[3], b8]
    w += [b8 * w[k] for k in range(1, 8)]
    return np.stack(w)  # [16, T]


def _run(n: int, regs: np.ndarray, inverse: bool) -> np.ndarray:
    """The kernel's transform on ``regs`` [16, N/16] (register j of thread
    t), in complex64 as on the card. Forward: passes 0.., butterfly then
    twiddle; inverse: passes ..0, conj twiddle then butterfly. Between
    passes the points go through an N-point array at each pass's
    positions."""
    plan, passes = kernel_plan(n), kernel_passes(n)
    t = np.arange(n // POINTS)
    order = list(range(len(passes)))[::-1] if inverse else list(range(len(passes)))
    regs = regs.astype(np.complex64)
    for i, p in enumerate(order):
        r, length, m = passes[p]
        sign = 1 if inverse else -1
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r).astype(np.complex64)
        v = regs.reshape(POINTS // r, r, -1)
        tw = None
        if m > 1:
            base = plan["twiddles"][plan["offsets"][p]:]
            tw = _twiddle_powers(*(base[e * m + t % m] for e in range(4)))[None]
            if inverse:
                v = v * np.conj(tw)
        v = np.einsum("kr,urt->ukt", dft, v)
        if tw is not None and not inverse:
            v = v * tw
        regs = v.reshape(POINTS, -1).astype(np.complex64)
        if i + 1 < len(order):
            buf = np.empty(n, np.complex64)
            buf[kernel_positions(n, p)] = regs
            regs = buf[kernel_positions(n, order[i + 1])]
    return regs


@pytest.mark.parametrize("n", KERNEL_FFT_SIZES)
def test_k1_schedule_matches_numpy_fft(n):
    """Forward: the spectrum at ``freq_of``; inverse of spectrum x R (R in
    the wrapper's register order) in natural order; float32 tolerance."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    plan = kernel_plan(n)
    freq_of = plan["freq_of"]
    assert sorted(freq_of.ravel()) == list(range(n))
    spec = _run(n, x[kernel_positions(n, 0)], inverse=False)
    want = np.fft.fft(x.astype(np.complex128))
    np.testing.assert_allclose(spec, want[freq_of], rtol=0, atol=2e-6 * np.abs(want).max())
    rep = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = _run(n, spec * rep[freq_of], inverse=True)
    want_y = np.fft.ifft(want * rep) * n
    np.testing.assert_allclose(y, want_y[kernel_positions(n, 0)], rtol=0,
                               atol=2e-6 * np.abs(want_y).max())


@pytest.mark.parametrize("n", KERNEL_FFT_SIZES)
def test_k1_model_best_power_matches_plain(n):
    """The whole kernel on two frames and three bins (the wrapper's
    prescaled replica layout from ``replica_table``) against the plain
    version."""
    rng = np.random.default_rng(1)
    s = n - 296
    x = rng.standard_normal((2, 3 * s)).astype(np.float32)
    views = [torch.from_numpy(np.ascontiguousarray(v)) for v in (
        x[0, : 2 * s].reshape(2, s), x[1, : 2 * s].reshape(2, s),
        x[0, s:].reshape(2, s), x[1, s:].reshape(2, s))]
    rf = rng.standard_normal((2, 3, n)).astype(np.float32)
    pp, pb = fused_best_power_plain(*views, torch.from_numpy(rf[0]), torch.from_numpy(rf[1]), n)
    table = replica_table(torch.from_numpy(rf[0]), torch.from_numpy(rf[1]), n).numpy()
    rep = (table[..., 0] + 1j * table[..., 1]).astype(np.complex64)  # [nb, 16*T]
    for f in range(2):
        frame = x[0, f * s : f * s + n] + 1j * x[1, f * s : f * s + n]  # body, then lookahead
        spec = _run(n, frame.astype(np.complex64)[kernel_positions(n, 0)], inverse=False)
        best, arg = np.full(spec.shape, -1.0, np.float32), np.zeros(spec.shape, np.int64)
        for b in range(3):
            y = _run(n, spec * rep[b].reshape(spec.shape), inverse=True)
            p = (y.real**2 + y.imag**2).astype(np.float32)
            arg = np.where(p > best, b, arg)
            best = np.maximum(p, best)
        got_p = np.empty(n, np.float32)
        got_b = np.empty(n, np.int64)
        got_p[kernel_positions(n, 0)] = best
        got_b[kernel_positions(n, 0)] = arg
        np.testing.assert_allclose(got_p, pp[f].numpy(), rtol=1e-4, atol=1e-5 * pp.max().item())
        assert (got_b == pb[f].numpy()).mean() >= 0.999


def _swizzle(p):
    """csrc/correlate.cu: swizzle (float2 addresses)."""
    return p ^ ((p >> 4) & 15)


@pytest.mark.parametrize("n", KERNEL_FFT_SIZES)
def test_k1_exchanges_are_free_of_bank_conflicts(n):
    """Each pass's stores and loads of 8-byte points: within each half-warp
    (the unit of a 64-bit shared-memory access) the 16 addresses fall on
    16 distinct 8-byte bank pairs. The swizzle is a permutation."""
    assert sorted(_swizzle(np.arange(n))) == list(range(n))
    for p in range(len(kernel_passes(n))):
        addr = _swizzle(kernel_positions(n, p))  # [16, T]
        halves = addr.reshape(POINTS, -1, 16) % 16
        assert all(len(set(h)) == 16 for row in halves for h in row), p


def phase_split_reference(
    z: np.ndarray, taps: np.ndarray, sps: int, num_syms: int
) -> np.ndarray:
    """K3's arithmetic on one plane (csrc/matched.cu): the zero-extended
    region split by phase, ``ph[p][m] = z[sps*m + p]``, and
    ``out[s] = sum_p sum_q ph[p][s + q] * taps[sps*q + p]`` with the taps
    zero past ``K``. ``z`` ``[D, R]``, ``taps`` ``[D, K]``; float32 sums."""
    d, k = taps.shape
    kq = -(-k // sps)
    m = num_syms + kq - 1
    w = np.zeros((d, sps * m), np.float32)
    n = min(z.shape[1], sps * m)
    w[:, :n] = z[:, :n]
    ph = w.reshape(d, m, sps).transpose(0, 2, 1)  # [D, sps, m]
    tq = np.zeros((d, kq * sps), np.float32)
    tq[:, :k] = taps
    out = np.zeros((d, num_syms), np.float32)
    for p in range(sps):
        for q in range(kq):
            out += ph[:, p, q : q + num_syms] * tq[:, q * sps + p, None]
    return out


@pytest.mark.parametrize(
    "d,k,sps,s,short",
    [(5, 44, 4, 192, 0), (3, 44, 4, 300, 43), (4, 13, 2, 50, 3), (2, 7, 3, 9, 20), (6, 44, 4, 7, 0)],
)
def test_k3_phase_split_equals_plain(d, k, sps, s, short):
    """K3's order of sums (phase, then tap within the phase), with zeros
    past the region and past K, against the plain version: float32
    rounding (rtol 1e-5, atol 1e-4, the card tests' tolerance)."""
    rng = np.random.default_rng(s)
    r = max(sps * (s - 1) + k - short, 1)
    z = rng.standard_normal((d, r)).astype(np.float32)
    taps = rng.standard_normal((d, k)).astype(np.float32)
    got = phase_split_reference(z, taps, sps, s)
    zt = torch.from_numpy(z)
    want = matched_filter_plain(zt, zt, torch.from_numpy(taps), sps, s)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
