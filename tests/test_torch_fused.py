"""The port's fused acquisition (K1's plain route, the fused backend of
``acquire``, the fresh window, K2b) against the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU (tests/test_acquire_fused.py, tests/test_fetch_pallas.py). The
inputs are made with numpy from a seed: noise, and bursts from the
sequential reference transmitter (tests/reference_impl.py). Tolerances are
those of tests/test_acquire_fused.py, cited at each use.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import reference_impl as ref  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import AcquisitionConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import SyncwordAcquirer as JAcquirer  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import chunked_peak_detect as j_detect  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire_pallas import fused_best_power as j_fused  # noqa: E402
from gr4_packet_modem_tpu.ops.fetch_pallas import fetch_rows as j_fetch_rows  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.acquire import (  # noqa: E402
    AcquisitionConfig,
    SyncwordAcquirer,
    chunked_peak_detect,
)
from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_rows  # noqa: E402
from test_acquire import _brute_force_detect  # noqa: E402


def _noise(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)


def _bursts_at(starts, lengths, total, seed, cfo=0.0, noise=0.0):
    """Reference-transmitter bursts of random payloads at ``starts``, with
    a carrier offset and complex white noise, all from ``seed``."""
    rng = np.random.default_rng(seed)
    x = np.zeros(total, np.complex128)
    for i, (s, n) in enumerate(zip(starts, lengths)):
        b = ref.burst_samples(rng.integers(0, 256, n, dtype=np.uint8), packet_index=i)
        x[s : s + b.size] += b
    x = x * np.exp(1j * cfo * np.arange(total))
    x = x + noise * (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    return x.astype(np.complex64)


def _j_views(fft_size, x):
    """The JAX acquirer's kernel inputs for ``x``: its frame views and
    replica spectra (numpy), and the valid frame count and stride."""
    a = JAcquirer(JConfig(freq_bins=4, max_detections=8, fft_size=fft_size, backend="fused"))
    n, s = fft_size, a.stride
    f = (x.size - n) // s + 1
    fpad = -(-f // 16) * 16
    views = [np.array(v) for v in a._frames_planes(jnp.asarray(x), fpad)]
    rf = [np.array(v) for v in a._replica_fft_conj()]
    return views, rf, f, s


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("fft_size", [2048, 4096])
def test_fused_best_power_matches_jax(fft_size, wide):
    """K1's plain route against both JAX kernel layouts on 2**14 noise
    samples. Narrow: test_acquire_fused.py:55-56 (rtol 1e-4, atol 1e-5,
    bins equal); wide: :80-83 (atol 1e-3, bins equal on > 99.9 %)."""
    x = _noise(1 << 14, seed=5 if wide else 0)
    views, rf, f, s = _j_views(fft_size, x)
    jp, jb = j_fused(*map(jnp.asarray, views + rf), fft_size, interpret=True, wide=wide)
    tp, tb = fused_best_power(*map(torch.from_numpy, views + rf), fft_size)
    assert tp.shape == tuple(jp.shape) and tb.dtype == torch.int32
    got_p, got_b = tp.numpy()[:f, :s], tb.numpy()[:f, :s]
    want_p, want_b = np.asarray(jp)[:f, :s], np.asarray(jb)[:f, :s]
    if wide:
        np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-3)
        assert (got_b == want_b).mean() > 0.999
    else:
        np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got_b, want_b)


@pytest.mark.parametrize(
    "call",
    [
        lambda z: fused_best_power(z(32, 1752), z(32, 1752), z(32, 1752), z(32, 1752), z(9, 2048), z(9, 2048), 2048, block_frames=24),
        lambda z: fused_best_power(z(32, 1000), z(32, 1000), z(32, 1000), z(32, 1000), z(9, 2048), z(9, 2048), 2048),
        lambda z: fused_best_power(z(32, 1752), z(32, 1752), z(32, 1752), z(32, 1752), z(9, 4096), z(9, 4096), 2048),
    ],
    ids=["fpad", "stride", "replica"],
)
def test_fused_best_power_rejects(call):
    """The JAX function's ValueErrors (acquire_pallas.py:342-347)."""
    with pytest.raises(ValueError):
        call(lambda *shape: torch.zeros(shape))


FUSED_TOL = [  # field, atol; rtol 2e-3 (test_acquire_fused.py:148-160)
    ("amplitude", 1e-3), ("phase", 1e-3), ("freq", 1e-6), ("time_est", 1e-3),
    ("esn0_db", 1e-2),
]


def _compare(got, want, fields=FUSED_TOL):
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_array_equal(got.index.numpy()[v], np.asarray(want.index)[v])
    np.testing.assert_array_equal(got.freq_bin.numpy()[v], np.asarray(want.freq_bin)[v])
    for field, atol in fields:
        np.testing.assert_allclose(
            getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v],
            rtol=2e-3, atol=atol, err_msg=field,
        )


def _pair(**kw):
    cfg = dict(freq_bins=4, max_detections=8, backend="fused")
    cfg.update(kw)
    return JAcquirer(JConfig(**cfg)), SyncwordAcquirer(AcquisitionConfig(**cfg), "cpu")


def test_fused_acquire_matches_jax_multi_burst():
    """Three bursts at a carrier offset in noise (the signal of
    test_acquire_fused.py:22-33, made with numpy)."""
    x = _bursts_at((2000, 3700, 6900), (40, 64, 25), 1 << 15, seed=3, cfo=0.004, noise=0.05)
    jacq, acq = _pair()
    want = jacq.acquire(jnp.asarray(x))
    got = acq.acquire(torch.from_numpy(x))
    assert int(np.asarray(want.valid).sum()) == 3
    _compare(got, want)


def test_fused_acquire_at_clipped_noise_region():
    """A syncword at 771, inside [w, w+16): its noise region clips at the
    buffer start, and the syncword window is carved at an offset below
    w+16 (test_acquire_fused.py:86-120)."""
    x = _bursts_at((771,), (30,), 1 << 14, seed=9, noise=0.03)
    jacq, acq = _pair(max_detections=4)
    want = jacq.acquire(jnp.asarray(x))
    got = acq.acquire(torch.from_numpy(x))
    assert bool(got.valid[0]) and int(got.index[0]) == 771
    _compare(got, want, [("phase", 1e-3), ("freq", 1e-6), ("esn0_db", 1e-2), ("amplitude", 1e-3)])


def test_fused_bank_matches_jax_per_channel_and_fft():
    """[C, T] fused acquisition equals C single-channel JAX fused calls, and
    the port's own fft backend on index, valid and freq_bin; a silent
    channel between two busy ones detects nothing."""
    xs = np.stack([
        _bursts_at((2500, 14000), (60, 30), 16384, seed=1, cfo=0.003, noise=0.02),
        np.zeros(16384, np.complex64),
        _bursts_at((900,), (100,), 16384, seed=2, cfo=-0.005, noise=0.02),
    ])
    jacq, acq = _pair(freq_bins=2, max_detections=4)
    got = acq.acquire(torch.from_numpy(xs))
    for c in range(xs.shape[0]):
        _compare(got.map(lambda a, c=c: a[c]), jacq.acquire(jnp.asarray(xs[c])))
    assert not got.valid[1].any()
    fft = SyncwordAcquirer(AcquisitionConfig(freq_bins=2, max_detections=4, backend="fft"), "cpu")
    ref_det = fft.acquire(torch.from_numpy(xs))
    v = ref_det.valid
    assert torch.equal(got.valid, v)
    assert torch.equal(got.index[v], ref_det.index[v])
    assert torch.equal(got.freq_bin[v], ref_det.freq_bin[v])


def test_fused_valid_candidates_keep_their_margin():
    """Fault (b): every valid candidate satisfies pos_ok (w <= ti < T' - w),
    so its neighbour powers never come from padding; and the neighbour
    powers equal clamped gathers, at the row ends too."""
    x = _bursts_at((800, 5000, 9000), (20, 20, 20), 12000, seed=4, noise=0.05)
    acq = SyncwordAcquirer(AcquisitionConfig(freq_bins=4, max_detections=8, backend="fused"), "cpu")
    det = acq.acquire(torch.from_numpy(x))
    w = acq.config.time_threshold
    tlen = ((x.size - acq.config.fft_size) // acq.stride + 1) * acq.stride
    idx = det.index[det.valid]
    assert idx.numel() == 3 and bool(((idx >= w) & (idx < tlen - w)).all())
    bp = torch.rand(2, 500, generator=torch.Generator().manual_seed(0))
    ti = torch.tensor([[0, 1, 250, 498, 499], [499, 0, 7, 3, 2]])
    pa, pc = acq._neighbour_powers(bp, ti)
    assert torch.equal(pa, bp.gather(1, (ti - 1).clamp(min=0)))
    assert torch.equal(pc, bp.gather(1, (ti + 1).clamp(max=499)))


def test_fused_rejects_syncword_longer_than_its_carve():
    """Fault (a): the syncword window must fit the noise region at every
    offset, sync_len <= time_threshold + 17; fft never carves."""
    with pytest.raises(ValueError, match="sync_len"):
        SyncwordAcquirer(AcquisitionConfig(time_threshold=279, backend="fused"), "cpu")
    SyncwordAcquirer(AcquisitionConfig(time_threshold=280, backend="fused"), "cpu")
    SyncwordAcquirer(AcquisitionConfig(time_threshold=279, backend="fft"), "cpu")


def test_backend_resolution():
    cfg = AcquisitionConfig()
    assert cfg.resolved_backend("cpu") == "fft"
    assert cfg.resolved_backend("cuda") == "fused"
    assert AcquisitionConfig(fft_size=6144).resolved_backend("cuda") == "fft"
    assert AcquisitionConfig(backend="fused").resolved_backend("cpu") == "fused"
    with pytest.raises(ValueError):
        AcquisitionConfig(fft_size=3000, backend="fused")
    with pytest.raises(ValueError):
        RxConfig(acquisition_fft_size=3000, acquisition_backend="fused")
    assert Receiver(RxConfig(max_payload_len=64), "cpu").acquirer.backend == "fft"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo,hi", [(300, 1000), (0, 2500), (1200, 4090), (None, 2000), (700, None)])
def test_chunked_peak_detect_fresh_window(seed, lo, hi):
    """The fresh-window restriction against JAX chunked_peak_detect and the
    brute-force definition of tests/test_acquire.py."""
    rng = np.random.default_rng(seed)
    w, d, thr = 32, 4, 9.5
    tlen = 4096 + int(rng.integers(0, w))
    bp = rng.random(tlen).astype(np.float32) * 0.1
    for t in [40, 100, 400, 529, 900, 1200, 1500, 2000, 2000 + w, 3000, tlen - 10]:
        bp[t] = 4.0 + rng.random()
    jl = None if lo is None else jnp.int32(lo)
    jh = None if hi is None else jnp.int32(hi)
    jp, ji, jo = j_detect(jnp.asarray(bp), w, d, thr, jl, jh)
    tp, tidx, to = chunked_peak_detect(torch.from_numpy(bp)[None], w, d, thr, lo, hi)
    got = sorted((float(p), int(i)) for p, i in zip(tp[0].numpy(), tidx[0].numpy()) if p > 0)
    want = sorted((float(p), int(i)) for p, i in zip(np.asarray(jp), np.asarray(ji)) if p > 0)
    assert got == want
    assert bool(to[0]) == bool(jo)
    brute, brute_ovf = _brute_force_detect(bp, w, d, thr, lo, hi)
    assert sorted(i for _, i in got) == sorted(brute)
    assert bool(to[0]) == brute_ovf


@pytest.mark.parametrize("backend", ["fft", "fused"])
def test_acquire_fresh_window_matches_jax(backend):
    """acquire(fresh_lo, fresh_hi) keeps only starts in the window, as the
    JAX acquirer does: the burst outside it takes no slot."""
    x = _bursts_at((1500, 7000, 12000), (40, 40, 40), 1 << 14, seed=6, noise=0.03)
    jacq, acq = _pair(max_detections=4, backend=backend)
    want = jacq.acquire(jnp.asarray(x), 0, jnp.int32(4000), jnp.int32(13000))
    got = acq.acquire(torch.from_numpy(x), 0, 4000, 13000)
    _compare(got, want)
    assert got.index[got.valid].tolist() == [7000, 12000]


@pytest.mark.parametrize("r", [297, 1569, 3])
def test_fetch_rows_exact(r):
    """K2b's plain route against fetch_rows (interpret): bit-exact at odd
    starts and at both edge starts."""
    rng = np.random.default_rng(r)
    t = 3 * r + 4099
    x = rng.standard_normal(t).astype(np.float32)
    starts = np.concatenate([[0, t - r], 2 * rng.integers(0, (t - r) // 2, 6) + 1]).astype(np.int32)
    want = j_fetch_rows(jnp.asarray(x), jnp.asarray(starts), r, interpret=True)
    got = fetch_rows(torch.from_numpy(x), torch.from_numpy(starts).long(), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
