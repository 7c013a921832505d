"""Port acquisition (fft backend) vs the JAX SyncwordAcquirer.

On the signals of tests/test_acquire.py (a JAX-transmitted burst with
scale, CFO, fractional delay and noise made with numpy from a seed), the
port's Detections equal the JAX ones on valid rows: ``index``, ``valid``,
``freq_bin`` and ``overflow`` exactly, the float fields within stated
tolerances (those of tests/test_acquire.py:150-160 where it has one).
Invalid slots are don't-care: ``lax.top_k`` and ``torch.topk`` order ties
differently.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import AcquisitionConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import SyncwordAcquirer as JAcquirer  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import chunked_peak_detect as j_detect  # noqa: E402
from gr4_packet_modem_tpu.utils.ragged import PacketBatch  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.acquire import (  # noqa: E402
    AcquisitionConfig,
    SyncwordAcquirer,
    chunked_peak_detect,
)

# field -> (rtol, atol) on valid rows
FLOAT_TOL = {
    "amplitude": (1e-4, 0.0),
    "freq": (0.0, 1e-6),
    "time_est": (0.0, 1e-4),
    "phase": (0.0, 1e-4),
    "noise_power": (1e-4, 0.0),
    "esn0_db": (0.0, 1e-3),
}


def _burst(payload_len=32, max_len=64):
    tx = Transmitter(TxConfig(max_payload_len=max_len))
    payload = np.arange(payload_len, dtype=np.uint8)
    s, l = tx.modulate_bursts(PacketBatch.from_list([payload], max_len=max_len))
    return np.asarray(s)[0, : int(l[0])]


def _signal(scale=1.0, cfo=0.0, offsets=(3000,), total=16384, noise=0.0,
            frac=0.0, seed=0):
    burst = _burst()
    x = np.zeros(total, np.complex64)
    for off in offsets:
        x[off : off + burst.size] += burst * scale
    if frac:
        freqs = np.fft.fftfreq(total)
        x = np.fft.ifft(np.fft.fft(x) * np.exp(-2j * np.pi * freqs * frac))
    x = x * np.exp(1j * cfo * np.arange(total))
    rng = np.random.default_rng(seed)
    x = x + noise * (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    return x.astype(np.complex64)


CASES = {
    "clean": (dict(scale=0.7), dict()),
    "cfo+0.006": (dict(cfo=0.006, noise=0.02), dict()),
    "cfo-0.02": (dict(cfo=-0.02, noise=0.02, seed=1), dict()),
    "frac-0.3": (dict(frac=-0.3), dict(freq_bins=0)),
    "frac+0.25": (dict(frac=0.25), dict(freq_bins=0)),
    "noise_only": (dict(scale=0.0, noise=1.0, seed=5), dict(max_detections=8)),
    "esn0": (dict(noise=0.05, seed=2), dict()),
    "fft4096": (dict(cfo=0.003, offsets=(4000,), total=1 << 15, noise=0.03), dict(fft_size=4096)),
    "several": (dict(offsets=(2100, 9000, 21000), total=1 << 15, noise=0.02, seed=3), dict(max_detections=8)),
    "overflow": (dict(offsets=(2100, 9000, 21000), total=1 << 15, noise=0.02, seed=4), dict(max_detections=2)),
}


def _compare(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert bool(got.overflow) == bool(want.overflow)
    np.testing.assert_array_equal(got.index.numpy()[valid], np.asarray(want.index)[valid])
    np.testing.assert_array_equal(got.freq_bin.numpy()[valid], np.asarray(want.freq_bin)[valid])
    for name, (rtol, atol) in FLOAT_TOL.items():
        np.testing.assert_allclose(
            getattr(got, name).numpy()[valid], np.asarray(getattr(want, name))[valid],
            rtol=rtol, atol=atol, err_msg=name,
        )


@pytest.mark.parametrize("case", sorted(CASES))
def test_detections_match_jax(case):
    sig_kw, cfg_kw = CASES[case]
    x = _signal(**sig_kw)
    cfg = dict(freq_bins=4, max_detections=4, backend="fft")
    cfg.update(cfg_kw)
    want = JAcquirer(JConfig(**cfg)).acquire(jnp.asarray(x))
    got = SyncwordAcquirer(AcquisitionConfig(**cfg), "cpu").acquire(torch.from_numpy(x))
    _compare(got, want)
    if case in ("clean", "esn0", "several"):
        assert got.valid.any()
    if case == "overflow":
        assert bool(got.overflow)


def test_bank_acquisition_matches_per_channel():
    """[C, T] acquisition equals C single-channel calls of the JAX acquirer."""
    xs = np.stack([
        _signal(cfo=0.004 * c, offsets=(2500 + 700 * c,), noise=0.02, seed=c)
        for c in range(3)
    ])
    cfg = dict(freq_bins=2, max_detections=4, backend="fft")
    got = SyncwordAcquirer(AcquisitionConfig(**cfg), "cpu").acquire(torch.from_numpy(xs))
    jacq = JAcquirer(JConfig(**cfg))
    for c in range(xs.shape[0]):
        _compare(got.map(lambda a, c=c: a[c]), jacq.acquire(jnp.asarray(xs[c])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_peak_detect_matches_jax(seed):
    """Event positions, powers and overflow on the planted-peak inputs of
    tests/test_acquire.py::test_chunked_peak_detect_matches_brute_force."""
    rng = np.random.default_rng(seed)
    w, d, thr = 32, 6, 9.5
    tlen = 4096 + rng.integers(0, w)
    bp = rng.random(tlen).astype(np.float32) * 0.1
    for t in [40, 500, 529, 1200, 2000, 2000 + w, 3000, tlen - 10]:
        if t < tlen:
            bp[t] = 5.0 + rng.random()
    jp, ji, jo = j_detect(jnp.asarray(bp), w, d, thr)
    tp, tidx, to = chunked_peak_detect(torch.from_numpy(bp)[None], w, d, thr)
    want = sorted((float(p), int(i)) for p, i in zip(np.asarray(jp), np.asarray(ji)) if p > 0)
    got = sorted((float(p), int(i)) for p, i in zip(tp[0].numpy(), tidx[0].numpy()) if p > 0)
    assert got == want
    assert bool(to[0]) == bool(jo)
