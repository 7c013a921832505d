"""The acquisition backends ``fused_bf16``, ``conv`` and ``conv_bf16`` of the
port against the JAX acquirer on the CPU.

The JAX side runs its K1 Pallas kernel in interpret mode, as its own tests
do (tests/test_acquire_fused.py). Inputs are made with numpy from a seed
(noise; bursts of the port's numpy stimulus, held bit for bit against
tests/reference_impl.py elsewhere) or taken from the JAX tests' own signal
helpers as numpy arrays, and the same arrays go to both packages. Held to:

- the carried tables (the conv kernel, the four-step DFT factors) bit for
  bit, and the bf16 kernel's host tables read back through the mma
  fragment layouts;
- K1's bf16 form, the plain version of ``csrc/correlate_bf16.cu``, against
  the JAX kernel with ``bf16=True`` on one block of frames (FPAD=16,
  N=2048, 9 bins): best power within rtol 1e-2 and atol 1e-4 x max, best
  bin equal wherever the JAX kernel's best bin beats its second best by
  more than 5 % (each bin's power from the JAX kernel run on that replica
  alone);
- ``correlate`` for all five backends, shape included, within 1e-4 of the
  largest correlation (products of bf16 values are exact in float32, so
  ``conv_bf16`` is held to the same);
- ``acquire`` for the three backends on tests/test_acquire_fused.py's
  multi-burst signal: valid, index and freq_bin equal; the conv estimates
  within 1e-4 relative; the fused_bf16 estimates within that JAX test's
  bf16 tolerances (test_acquire_fused.py:146-160);
- one ``Receiver.receive`` a bf16 backend against the JAX receiver on the
  same samples: flags, lengths and bytes equal, and the payloads;
- a bank of bursts followed by exact silence through both fused backends:
  every detection equal to the JAX acquirer's, the extra detections that
  the bf16 form makes in the silent tail included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JRxConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import AcquisitionConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire import SyncwordAcquirer as JAcquirer  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire_pallas import _fwd_tables, _inv_tables  # noqa: E402
from gr4_packet_modem_tpu.ops.acquire_pallas import fused_best_power as j_fused  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.acquire import (  # noqa: E402
    BACKENDS,
    AcquisitionConfig,
    SyncwordAcquirer,
    acquirer_tables,
)
from gr4_packet_modem_tpu_torch.ops.acquire_cuda import (  # noqa: E402
    bf16_tables,
    dft_tables,
    fragment_index,
    fused_best_power,
    fused_best_power_bf16_plain,
    replica_table_bf16,
)
from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples  # noqa: E402
from test_acquire_fused import _multi_burst_signal  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("fft_size,bins", [(2048, 4), (4096, 2)])
def test_tables_equal_jax_bit_for_bit(fft_size, bins):
    """The conv kernel of ``acquirer_tables`` and K1's four-step DFT factors
    of ``dft_tables`` against the JAX acquirer's and kernel's."""
    tables = acquirer_tables(AcquisitionConfig(fft_size=fft_size, freq_bins=bins))
    jacq = JAcquirer(JConfig(fft_size=fft_size, freq_bins=bins, backend="fft"))
    f1, twf, f2 = _fwd_tables(fft_size)
    w2c, tw, w1c = _inv_tables(fft_size)
    got_all = {"conv_kernel": tables["conv_kernel"], **dft_tables(fft_size)}
    want = dict(conv_kernel=jacq._conv_kernel, f1=f1, twf=twf, f2=f2, w2c=w2c, tw=tw, w1c=w1c)
    assert got_all.keys() == want.keys()
    for name, w in want.items():
        got = got_all[name]
        assert got.dtype == w.dtype and got.shape == w.shape, name
        np.testing.assert_array_equal(_bits(got), _bits(w), err_msg=name)
    assert tables["conv_kernel"].shape == (jacq.sync_len, 2, 2 * (2 * bins + 1))


def test_bf16_plain_matches_jax_kernel():
    """One block of frames of noise with three syncwords at 10 dB."""
    n, fpad = 2048, 16
    jacq = JAcquirer(JConfig(freq_bins=4, fft_size=n, backend="fused_bf16"))
    s = jacq.stride
    rng = np.random.default_rng(12)
    t = (fpad + 1) * s + n
    x = 0.1 * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    for start, b in ((3 * s + 100, 1), (7 * s + 1500, 4), (12 * s + 17, 8)):
        x[start : start + jacq.sync_len] += 0.3 * jacq.replicas[b]
    x = x.astype(np.complex64)
    views = [np.array(v) for v in jacq._frames_planes(jnp.asarray(x), fpad)]
    rf = [np.array(v) for v in jacq._replica_fft_conj()]
    jp, jb = (np.asarray(v) for v in j_fused(*map(jnp.asarray, views + rf), n, interpret=True, bf16=True))
    # each bin's power: the JAX kernel on that replica alone
    per_bin = np.stack([
        np.asarray(j_fused(*map(jnp.asarray, views), jnp.asarray(rf[0][b : b + 1]),
                           jnp.asarray(rf[1][b : b + 1]), n, interpret=True, bf16=True)[0])
        for b in range(rf[0].shape[0])
    ])
    np.testing.assert_array_equal(per_bin.max(axis=0), jp)
    tp, tb = fused_best_power(*map(torch.from_numpy, views + rf), n, bf16=True)
    assert tp.shape == jp.shape == (fpad, n) and tb.dtype == torch.int32
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-2, atol=1e-4 * jp.max())
    top2 = np.sort(per_bin, axis=0)[-2:]
    clear = top2[1] > 1.05 * top2[0]
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tb.numpy()[clear], jb[clear])
    np.testing.assert_array_equal(jb[clear], per_bin.argmax(axis=0)[clear])
    # the wrapper's CPU route is the plain version
    pp, pb = fused_best_power_bf16_plain(*map(torch.from_numpy, views + rf), n)
    assert torch.equal(pp, tp) and torch.equal(pb, tb)


@pytest.mark.parametrize("n", [2048, 8192])
def test_bf16_kernel_tables_layout(n):
    """The host tables of ``csrc/correlate_bf16.cu`` read back through the
    mma.m16n8k16 fragment layouts give the TPU kernel's bf16-rounded
    factors, and the accumulator layout covers every spectrum point once."""
    t = dft_tables(n)
    tab = bf16_tables(n)
    n2 = n // 16

    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()

    for name, mat in (("fwd", t["f2"]), ("inv", t["w2c"])):
        words = tab[name].view(np.uint32)  # [N2/8, N2/16, 32, 4]
        assert words.shape == (n2 // 8, n2 // 16, 32, 4)
        got = np.zeros((2, n2, n2), np.float32)
        for w, (part, r0) in enumerate([(0, 0), (0, 8), (1, 0), (1, 8)]):
            for half in range(2):  # the low half holds the lower row
                vals = ((words[..., w] >> (16 * half)) & 0xFFFF).astype(np.uint32) << 16
                nt, ks, lane = np.indices(words.shape[:3])
                row = 16 * ks + 2 * (lane & 3) + r0 + half
                got[part, row, 8 * nt + (lane >> 2)] = vals.view(np.float32)
        np.testing.assert_array_equal(got[0], bf16(mat.real), err_msg=name)
        np.testing.assert_array_equal(got[1], bf16(mat.imag), err_msg=name)
    small = tab["small"]
    np.testing.assert_array_equal(small[0, ..., 0] + 1j * small[0, ..., 1], bf16(t["f1"].real) + 1j * bf16(t["f1"].imag))
    np.testing.assert_array_equal(small[1, ..., 0] + 1j * small[1, ..., 1], bf16(t["w1c"].real) + 1j * bf16(t["w1c"].imag))
    np.testing.assert_array_equal(tab["tw"][0, ..., 0] + 1j * tab["tw"][0, ..., 1], t["twf"][:, 0])
    np.testing.assert_array_equal(tab["tw"][1, ..., 0] + 1j * tab["tw"][1, ..., 1], t["tw"][:, 0])
    idx = fragment_index(n)
    assert idx.shape == (n2 // 8, 32, 4)
    np.testing.assert_array_equal(np.sort(idx.ravel()), np.arange(n))
    rf = np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32)
    table = replica_table_bf16(torch.from_numpy(rf[0]), torch.from_numpy(rf[1]), n).numpy()
    assert table.shape == (3, n2 // 8, 2, 32, 4)
    np.testing.assert_array_equal(table[:, :, 0], rf[0][:, idx])
    np.testing.assert_array_equal(table[:, :, 1], rf[1][:, idx])


@pytest.mark.parametrize("backend", BACKENDS[1:])
def test_correlate_equals_jax(backend):
    """``correlate`` of a bank of two noise captures against the JAX
    acquirer's, row by row: conv output length T-L+1 for every backend but
    fft (frames x stride)."""
    rng = np.random.default_rng(7)
    t = 3 * 2048 + 123
    x = (rng.standard_normal((2, t)) + 1j * rng.standard_normal((2, t))).astype(np.complex64)
    jacq = JAcquirer(JConfig(freq_bins=2, backend=backend))
    want = np.stack([np.asarray(jacq.correlate(jnp.asarray(row))) for row in x])
    acq = SyncwordAcquirer(AcquisitionConfig(freq_bins=2, backend=backend), "cpu")
    got = acq.correlate(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    length = t - acq.sync_len + 1 if backend != "fft" else (t - 2048) // acq.stride * acq.stride + acq.stride
    assert want.shape == (2, 5, length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    one = acq.correlate(torch.from_numpy(x[1])).numpy()
    np.testing.assert_allclose(one, want[1], rtol=0, atol=1e-4 * np.abs(want).max())


BF16_TOL = [  # field, atol; rtol 1e-2 (test_acquire_fused.py:146-160)
    ("amplitude", 1e-2), ("phase", 2e-2), ("freq", 1e-4), ("time_est", 5e-2), ("esn0_db", 1e-1),
]


@pytest.mark.parametrize("backend", ["fused_bf16", "conv", "conv_bf16"])
def test_acquire_equals_jax(backend):
    x = np.array(_multi_burst_signal())
    cfg = dict(freq_bins=4, max_detections=8, backend=backend)
    want = JAcquirer(JConfig(**cfg)).acquire(jnp.asarray(x))
    got = SyncwordAcquirer(AcquisitionConfig(**cfg), "cpu").acquire(torch.from_numpy(x))
    v = np.asarray(want.valid)
    assert v.sum() == 3  # the three bursts
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert bool(got.overflow) == bool(want.overflow)
    for field in ("index", "freq_bin"):
        np.testing.assert_array_equal(getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v])
    if backend == "fused_bf16":
        for field, atol in BF16_TOL:
            np.testing.assert_allclose(getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v],
                                       rtol=1e-2, atol=atol, err_msg=field)
    else:
        for field in ("amplitude", "phase", "freq", "time_est", "noise_power", "esn0_db"):
            np.testing.assert_allclose(getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v],
                                       rtol=1e-4, atol=0, err_msg=field)


@pytest.mark.parametrize("backend", ["fused_bf16", "conv_bf16"])
def test_receive_equals_jax(backend):
    """Three bursts of the numpy stimulus, a carrier offset of 0.003 rad a
    sample and numpy noise, through the JAX receiver and the port's."""
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (40, 64, 25)]
    gap = np.zeros(700, np.complex64)
    x = np.concatenate([np.concatenate([gap, burst_samples(p, packet_index=i)])
                        for i, p in enumerate(payloads)] + [gap])
    x = x * np.exp(1j * 0.003 * np.arange(x.size))
    x = (x + 0.05 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))).astype(np.complex64)
    kw = dict(max_payload_len=64, max_detections=8, freq_bins=2, payload_carrier="vv",
              acquisition_backend=backend)
    want = JReceiver(JRxConfig(**kw, use_pallas=False)).receive(x)
    got = Receiver(RxConfig(**kw), "cpu").receive(x)
    acc = np.asarray(want.accepted)
    np.testing.assert_array_equal(got.accepted.numpy(), acc)
    np.testing.assert_array_equal(got.crc_ok.numpy(), np.asarray(want.crc_ok))
    np.testing.assert_array_equal(got.lengths.numpy()[acc], np.asarray(want.lengths)[acc])
    np.testing.assert_array_equal(got.data.numpy()[acc], np.asarray(want.data)[acc])
    rows = np.nonzero(acc)[0]
    assert rows.size == len(payloads)
    for row, p in zip(rows, payloads):
        np.testing.assert_array_equal(got.data.numpy()[row, : p.size], p)


SILENT_EXTRA = {0: 76328, 2: 76329}  # channel: the bf16 form's detection in the silent tail


@pytest.mark.parametrize("backend", ["fused", "fused_bf16"])
def test_silent_tail_detections_equal_jax(backend):
    """A 4-channel bank of three 1500-byte bursts a channel, channel c
    rotated by 0.1 c rad, then exact silence (tests/test_torch_cuda.py's
    bank without its noise), acquired as ``Receiver.bank_step`` acquires
    it. The JAX kernel's bf16 form, in interpret mode, makes one more
    detection in the silent tail of channels 0 and 2 (bin -4), where the
    correlation is bf16 rounding error of the last burst's frames; the
    port's plain version makes the same ones, and the float32 form none."""
    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(3)]
    stream = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(payloads)])
    kw = dict(max_payload_len=1536, max_detections=8, payload_carrier="vv", acquisition_backend=backend)
    rx = Receiver(RxConfig(**kw), "cpu")
    jrx = JReceiver(JRxConfig(**kw))
    fp, pt = rx.front_pad, rx.pad_tail()
    assert (jrx.front_pad, jrx.pad_tail()) == (fp, pt)
    x = np.zeros((4, fp + stream.size + pt), np.complex64)
    x[:, fp : fp + stream.size] = stream * np.exp(1j * 0.1 * np.arange(4))[:, None].astype(np.complex64)
    got = rx.acquirer.acquire(torch.from_numpy(x))
    want = jax.vmap(jrx.acquirer.acquire)(jnp.asarray(x))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for field in ("index", "freq_bin"):
        np.testing.assert_array_equal(getattr(got, field).numpy()[v], np.asarray(getattr(want, field))[v])
    index = np.asarray(want.index)
    for c in range(4):
        extra = sorted(set(index[c][v[c]].tolist()) - {832, 25744, 50656})
        assert extra == ([SILENT_EXTRA[c]] if backend == "fused_bf16" and c in SILENT_EXTRA else []), (c, extra)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="not in"):
        AcquisitionConfig(backend="conv_f16")
    for backend in ("fused", "fused_bf16"):
        with pytest.raises(ValueError, match="2048"):
            AcquisitionConfig(fft_size=3000, backend=backend)
    assert AcquisitionConfig(backend="fused_bf16").resolved_backend("cuda") == "fused_bf16"
