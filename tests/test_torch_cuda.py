"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU (Hopper,
sm_90a) and nvcc; elsewhere they skip. They import no JAX, so they also run
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.ops import _build, ldpc  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas_cuda import (  # noqa: E402
    costas_track, costas_track_plain, skipped_rows,
)
from gr4_packet_modem_tpu_torch.ops.crc import crc32_ref, crc32_tables, payload_crc, payload_crc_plain  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_regions, fetch_regions_plain  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.matched_cuda import (  # noqa: E402
    extract_symbols, extract_symbols_plain, matched_filter, matched_filter_plain,
)

pytestmark = pytest.mark.cuda

# the kernels of a receive with fused acquisition (all but K1's bf16 form)
RECEIVE_KERNELS = tuple(k for k in _build.KERNELS if k != "correlate_bf16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [37, 1536])
@pytest.mark.parametrize("r", [3, 808, 809, 1569, 24680])
def test_fetch_bit_exact(dev, r, d):
    """K2 on the complex bank at odd and even starts, 0 and T - R, and on a
    bank that starts one sample past a 16-byte boundary (so the start
    parity that takes the float4 loads flips)."""
    g = torch.Generator(device=dev).manual_seed(r + d)
    t = 100_001
    bank = torch.randn(t + 1, generator=g, device=dev, dtype=torch.complex64)
    for x in (bank[:t], bank[1:]):
        starts = torch.randint(0, t - r + 1, (d,), generator=g, device=dev)
        starts[:4] = torch.tensor([0, 1, t - r, t - r - 1])
        kr, ki = fetch_regions(x, starts, r)
        pr, pi = fetch_regions_plain(x, starts, r)
        assert torch.equal(kr, pr) and torch.equal(ki, pi)


@pytest.mark.parametrize(
    "d,s,short,k,sps",
    [
        (130, 192, 0, 44, 4),
        (130, 300, 7, 44, 4),  # 300 outputs: not a multiple of the 9 a thread
        (37, 901, 43, 44, 4),  # a tail K - 1 samples short, a ragged chunk
        (3, 5, 20, 44, 4),  # fewer outputs than a warp's
        (1536, 192, 0, 44, 4),  # the header pass
        (1536, 6160, 0, 44, 4),  # the payload pass
        (50, 333, 5, 13, 2),  # sps and K read at run time
        (20, 97, 0, 44, 3),
    ],
)
def test_matched_filter(dev, d, s, short, k, sps):
    g = torch.Generator(device=dev).manual_seed(s)
    r = sps * (s - 1) + k - short  # short: the tail reads zeros
    zr = torch.randn(d, r, generator=g, device=dev)
    zi = torch.randn(d, r, generator=g, device=dev)
    taps = torch.randn(d, k, generator=g, device=dev)
    for a, b in zip(matched_filter(zr, zi, taps, sps, s), matched_filter_plain(zr, zi, taps, sps, s)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_matched_filter_unaligned_rows(dev):
    """Planes that start one float past a 16-byte boundary take the
    scalar staging path."""
    g = torch.Generator(device=dev).manual_seed(5)
    d, s, k, sps = 40, 500, 44, 4
    r = sps * (s - 1) + k
    z = torch.randn(2, d * r + 1, generator=g, device=dev)
    zr, zi = z[0, 1:].view(d, r), z[1, 1:].view(d, r)
    taps = torch.randn(d, k, generator=g, device=dev)
    for a, b in zip(matched_filter(zr, zi, taps, sps, s), matched_filter_plain(zr, zi, taps, sps, s)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("offset", [0, 192])
@pytest.mark.parametrize("s", [192, 700, 6160])
@pytest.mark.parametrize("b", [70, 1537])
def test_costas(dev, b, s, offset):
    """A locked loop on noisy QPSK with residual CFO; B and S not multiples
    of the kernel's 32-packet, 32-symbol tiles. Bit for bit, [B, S]
    contiguous."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols

    sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(b, s, offset, seed=s + b))
    out, ph, fr = costas_track(sym, ph0, fr0, offset=offset)
    ref, ph_ref, fr_ref = costas_track_plain(sym, ph0, fr0, offset=offset)
    assert out.shape == (b, s) and out.is_contiguous() and ref.is_contiguous()
    assert torch.equal(out, ref)
    assert torch.equal(ph, ph_ref) and torch.equal(fr, fr_ref)


def _masked_costas(dev, b, s, offset, inactive, seed):
    """The locked loop's symbols for ``b`` rows, the ``inactive`` ones
    scaled by 1e9 as a slot with no detection comes to K4, and the mask."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols

    sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(b, s, offset, seed=seed))
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[inactive] = False
    sym[~active] *= 1e9
    return sym, ph0, fr0, active


# (B, S, offset, inactive rows): the dense cells' payload pass, 2 of every
# 24 slots empty; the mixed cell's, the last 17 of every 56; a ragged B
# with two whole warps (rows 64-127) and scattered rows inactive
MASKS = {
    "dense": (1536, 6160, 192, [i for i in range(1536) if i % 24 >= 22]),
    "mixed": (3584, 16400, 192, [i for i in range(3584) if i % 56 >= 39]),
    "ragged": (1000, 700, 0, [*range(64, 128), *range(5, 1000, 37)]),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_costas_masked_matches_plain(dev, name):
    """K4 with a row mask against the plain route with the same mask, bit
    for bit: the active rows tracked, the inactive ones (scaled by 1e9)
    zeros with their state as it came; ``skipped_rows`` grows by the
    inactive rows."""
    b, s, offset, inactive = MASKS[name]
    sym, ph0, fr0, active = _masked_costas(dev, b, s, offset, inactive, seed=b + s)
    before = skipped_rows(dev)
    out, ph, fr = costas_track(sym, ph0, fr0, offset=offset, active=active)
    assert skipped_rows(dev) - before == len(set(inactive))
    ref, ph_ref, fr_ref = costas_track_plain(sym, ph0, fr0, offset, active)
    assert torch.equal(out, ref) and torch.equal(ph, ph_ref) and torch.equal(fr, fr_ref)
    assert not bool(out[~active].any()) and bool(out[active].abs().gt(0).all())


def test_costas_masked_in_a_cuda_graph(dev):
    """K4 with a mask captured into a CUDA graph: each replay, with the
    symbols and the mask changed in place between replays, is bit-identical
    to the plain route on the inputs of that moment, and adds that moment's
    inactive rows to ``skipped_rows``."""
    b, s, offset, inactive = MASKS["ragged"]
    sym, ph0, fr0, active = _masked_costas(dev, b, s, offset, inactive, seed=3)
    costas_track(sym, ph0, fr0, offset=offset, active=active)  # the library and counter outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = costas_track(sym, ph0, fr0, offset=offset, active=active)
    for i in range(3):
        if i:
            fresh = _masked_costas(dev, b, s, offset, list(range(i, b, 5 + i)), seed=10 + i)
            for t, f in zip((sym, ph0, fr0, active), fresh):
                t.copy_(f)
        torch.cuda.synchronize()
        before = skipped_rows(dev)
        graph.replay()
        torch.cuda.synchronize()
        assert skipped_rows(dev) - before == int((~active).sum())
        for got, want in zip(out, costas_track_plain(sym, ph0, fr0, offset, active)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 300, 1537])  # one warp and block a codeword
def test_ldpc_bit_exact(dev, b):
    from gr4_packet_modem_tpu_torch.utils.stimulus import ldpc_encode_bytes

    rng = np.random.default_rng(3)
    headers = rng.integers(0, 256, (b, 4), dtype=np.uint8)
    cw = np.unpackbits(np.stack([ldpc_encode_bytes(h)[:16] for h in headers]), axis=1)
    sigma = np.sqrt(1.0 / (2 * 10 ** (rng.uniform(-6, 4, (b, 1)) / 10)))
    llr = (2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))
    llr = torch.from_numpy(llr.astype(np.float32)).to(dev)
    t = ldpc.decoder_tables()
    cv, ve = (torch.from_numpy(a).to(dev) for a in ldpc.edge_tables(t["vidx"], t["vmask"], 128))
    before = _build.launch_counts()["ldpc"]
    total = ldpc_totals(llr, cv, ve)
    assert _build.launch_counts()["ldpc"] == before + 1
    assert torch.equal(total, ldpc.ldpc_totals_plain(llr, cv, ve))


@pytest.mark.parametrize(
    "n,fpad,nb",
    [
        (2048, 48, 9), (4096, 32, 9), (8192, 16, 3),
        (2048, 16, 1), (2048, 16, 9),  # one block of frames
        (2048, 5, 9), (4096, 5, 9), (4096, 7, 1), (8192, 3, 9),  # a ragged last block
    ],
)
def test_correlate_matches_plain(dev, n, fpad, nb):
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power, fused_best_power_plain

    g = torch.Generator(device=dev).manual_seed(n)
    s = n - 296
    x = torch.randn(2, (fpad + 1) * s, generator=g, device=dev)
    views = (x[0, : fpad * s].view(fpad, s), x[1, : fpad * s].view(fpad, s),
             x[0, s:].view(fpad, s), x[1, s:].view(fpad, s))
    rf = torch.randn(2, nb, n, generator=g, device=dev)
    before = _build.launch_counts()["correlate"]
    kp, kb = fused_best_power(*views, rf[0], rf[1], n, block_frames=1)
    assert _build.launch_counts()["correlate"] == before + 1
    pp, pb = fused_best_power_plain(*views, rf[0], rf[1], n)
    torch.testing.assert_close(kp, pp, rtol=1e-4, atol=1e-5 * pp.max().item())
    assert (kb == pb).float().mean().item() >= 0.999


@pytest.mark.parametrize(
    "n,fpad,nb",
    [(2048, 48, 9), (2048, 16, 1), (2048, 5, 9), (4096, 7, 9), (4096, 6, 1), (8192, 3, 9)],
)
def test_correlate_bf16_matches_plain(dev, n, fpad, nb):
    """K1's bf16 form against its plain version: best power within 2e-2 of
    itself plus 1e-4 of the largest, best bin equal wherever the plain
    version's best bin beats its second best by more than 5 %."""
    _bf16_against_plain(dev, n, fpad, nb)


@pytest.mark.parametrize("fpad", [1, 3, 5, 67, "beyond"])
def test_correlate_bf16_ragged_frames(dev, fpad):
    """K1's bf16 form at N=2048 (the persistent wgmma kernel) on frame
    counts whose last group of four is ragged or alone, and on more frames
    than the card holds in flight at once ("beyond": twice its resident
    frames plus 3, from ``bf16_kernel_resources``), under the gate of
    ``test_correlate_bf16_matches_plain``."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import bf16_kernel_resources

    if fpad == "beyond":
        res = bf16_kernel_resources(2048)
        resident = res["frames_per_sm"] * torch.cuda.get_device_properties(dev).multi_processor_count
        assert resident > 0
        fpad = 2 * resident + 3
    _bf16_against_plain(dev, 2048, fpad, 9)


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("fpad", [1, 3, "resident-1", "resident+3"])
def test_correlate_bf16_stream_ragged_frames(dev, n, fpad):
    """K1's bf16 form at N=4096 and 8192 (the streaming wgmma kernel) on
    frame counts whose last group of four is ragged or alone, and one fewer
    and three more than the card holds in flight at once (its frames an SM
    from ``bf16_kernel_resources`` times the SMs), under the gate of
    ``test_correlate_bf16_matches_plain``."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import bf16_kernel_resources

    if isinstance(fpad, str):
        res = bf16_kernel_resources(n)
        resident = res["frames_per_sm"] * torch.cuda.get_device_properties(dev).multi_processor_count
        assert resident > 0
        fpad = resident - 1 if fpad == "resident-1" else resident + 3
    _bf16_against_plain(dev, n, fpad, 9)


def _bf16_against_plain(dev, n, fpad, nb):
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import bf16_bin_powers, fused_best_power

    g = torch.Generator(device=dev).manual_seed(n + nb)
    s = n - 296
    x = torch.randn(2, (fpad + 1) * s, generator=g, device=dev)
    views = (x[0, : fpad * s].view(fpad, s), x[1, : fpad * s].view(fpad, s),
             x[0, s:].view(fpad, s), x[1, s:].view(fpad, s))
    rf = torch.randn(2, nb, n, generator=g, device=dev)
    before = _build.launch_counts()["correlate_bf16"]
    kp, kb = fused_best_power(*views, rf[0], rf[1], n, block_frames=1, bf16=True)
    assert _build.launch_counts()["correlate_bf16"] == before + 1
    powers = bf16_bin_powers(*views, rf[0], rf[1], n)
    pp, pb = powers.max(dim=0)
    assert ((kp - pp).abs() <= 2e-2 * pp + 1e-4 * pp.max()).all()
    top2 = powers.topk(min(nb, 2), dim=0).values
    clear = top2[0] > 1.05 * top2[-1] if nb > 1 else torch.ones_like(kb, dtype=torch.bool)
    assert torch.equal(kb[clear], pb.to(torch.int32)[clear])


def test_bank_step_fused_bf16_decodes(dev):
    """A 4-channel bank of three 1500-byte bursts a channel, channel c
    rotated by 0.1 c rad, in complex noise of 0.05 a component from numpy
    (in exact silence the bf16 form also detects its own rounding error in
    the tail, as the JAX kernel does: the next test), through
    ``bank_step`` with fused_bf16 acquisition: every packet byte-exact,
    the fused backend's detections, K1's bf16 form launched and its
    float32 form not."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(3)]
    stream = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(payloads)])
    rows = {}
    for backend in ("fused", "fused_bf16"):
        rx = Receiver(RxConfig(max_payload_len=1536, max_detections=8, payload_carrier="vv",
                               acquisition_backend=backend), dev)
        fp, pt = rx.front_pad, rx.pad_tail()
        x = torch.zeros(4, fp + stream.size + pt, dtype=torch.complex64, device=dev)
        rot = torch.exp(1j * 0.1 * torch.arange(4, dtype=torch.float64)).to(torch.complex64)
        x[:, fp : fp + stream.size] = torch.from_numpy(stream).to(dev) * rot.to(dev)[:, None]
        noise = np.random.default_rng(5).standard_normal((2, *x.shape)).astype(np.float32)
        x += 0.05 * torch.complex(*torch.from_numpy(noise).to(dev))
        _build.reset_launch_counts()
        det, _, res, _ = rx.bank_step(x, 0)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        rows[backend] = det
        acc = res.accepted.view(4, -1).cpu().numpy()
        data = res.data.view(4, acc.shape[1], -1).cpu().numpy()
        for c in range(4):
            got = [data[c, i, :1500] for i in np.nonzero(acc[c])[0]]
            assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, payloads))
    assert launches["correlate_bf16"] == 1 and launches["correlate"] == 0, launches
    a, b = rows["fused"], rows["fused_bf16"]
    assert torch.equal(a.valid, b.valid)
    for f in ("index", "freq_bin"):
        assert torch.equal(getattr(a, f)[a.valid], getattr(b, f)[b.valid])


def test_bank_step_fused_bf16_fft4096_decodes(dev):
    """``test_bank_step_fused_bf16_decodes``'s noisy bank through
    ``bank_step`` with ``acquisition_fft_size=4096`` (K1's bf16 form in the
    streaming kernel): every packet byte-exact, the fused backend's
    detections at the same size, K1's bf16 form launched once and its
    float32 form not."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(3)]
    stream = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(payloads)])
    rows, launches = {}, {}
    for backend in ("fused", "fused_bf16"):
        rx = Receiver(RxConfig(max_payload_len=1536, max_detections=8, payload_carrier="vv",
                               acquisition_backend=backend, acquisition_fft_size=4096), dev)
        fp, pt = rx.front_pad, rx.pad_tail()
        x = torch.zeros(4, fp + stream.size + pt, dtype=torch.complex64, device=dev)
        rot = torch.exp(1j * 0.1 * torch.arange(4, dtype=torch.float64)).to(torch.complex64)
        x[:, fp : fp + stream.size] = torch.from_numpy(stream).to(dev) * rot.to(dev)[:, None]
        noise = np.random.default_rng(5).standard_normal((2, *x.shape)).astype(np.float32)
        x += 0.05 * torch.complex(*torch.from_numpy(noise).to(dev))
        _build.reset_launch_counts()
        det, _, res, _ = rx.bank_step(x, 0)
        torch.cuda.synchronize()
        launches[backend] = _build.launch_counts()
        rows[backend] = det
        acc = res.accepted.view(4, -1).cpu().numpy()
        data = res.data.view(4, acc.shape[1], -1).cpu().numpy()
        for c in range(4):
            got = [data[c, i, :1500] for i in np.nonzero(acc[c])[0]]
            assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, payloads))
    got = launches["fused_bf16"]
    assert got["correlate_bf16"] == 1 and got["correlate"] == 0, got
    assert launches["fused"]["correlate"] == 1, launches["fused"]
    a, b = rows["fused"], rows["fused_bf16"]
    assert torch.equal(a.valid, b.valid)
    for f in ("index", "freq_bin"):
        assert torch.equal(getattr(a, f)[a.valid], getattr(b, f)[b.valid])


def test_silent_tail_fused_bf16_matches_plain(dev):
    """The previous test's bank without its noise: three bursts, then exact
    silence. Acquired with fused_bf16 on the card (K1's bf16 form) and on
    CPU tensors (its plain version), every detection is equal, the extra
    ones in the silent tail of channels 0 and 2 (76328 and 76329, bin -4)
    included: the JAX kernel makes the same ones
    (tests/test_torch_acquire_backends.py::test_silent_tail_detections_equal_jax)."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(3)]
    stream = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(payloads)])
    cfg = RxConfig(max_payload_len=1536, max_detections=8, payload_carrier="vv",
                   acquisition_backend="fused_bf16")
    dets = {}
    for where in (dev, torch.device("cpu")):
        rx = Receiver(cfg, where)
        fp, pt = rx.front_pad, rx.pad_tail()
        x = np.zeros((4, fp + stream.size + pt), np.complex64)
        x[:, fp : fp + stream.size] = stream * np.exp(1j * 0.1 * np.arange(4))[:, None].astype(np.complex64)
        _build.reset_launch_counts()
        dets[where.type] = rx.acquirer.acquire(torch.from_numpy(x).to(where)).map(lambda t: t.cpu())
        assert _build.launch_counts()["correlate_bf16"] == (1 if where.type == "cuda" else 0)
    card, plain = dets["cuda"], dets["cpu"]
    assert torch.equal(card.valid, plain.valid)
    for f in ("index", "freq_bin"):
        assert torch.equal(getattr(card, f)[plain.valid], getattr(plain, f)[plain.valid])
    tail = {c: card.index[c][card.valid[c]].tolist()[3:] for c in range(4)}
    assert tail == {0: [76328], 1: [], 2: [76329], 3: []}, tail


@pytest.mark.parametrize("d", [37, 1536])
def test_fetch_rows_bit_exact(dev, d):
    from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_rows, fetch_rows_plain

    g = torch.Generator(device=dev).manual_seed(d)
    t = 100_000
    x = torch.randn(t, generator=g, device=dev)
    for r in (3, 297, 1569):
        starts = 2 * torch.randint(0, (t - r) // 2, (d,), generator=g, device=dev) + 1
        starts[0], starts[1] = 0, t - r
        assert torch.equal(fetch_rows(x, starts, r), fetch_rows_plain(x, starts, r))


@pytest.mark.parametrize("stream", [False, True])
def test_transmitter_card_matches_cpu(dev, stream):
    """The TX entry at 8 x 1500 B with PyTorch's default TF32 flags: the
    card's samples within 1e-5 of the same transmitter on CPU tensors,
    lengths equal."""
    from gr4_packet_modem_tpu_torch.entry import tx_entry

    fn, (b,) = tx_entry(dev, stream=stream, batch=8)
    cfn, (cb,) = tx_entry("cpu", stream=stream, batch=8)
    samples, lens = fn(b)
    want, want_lens = cfn(cb)
    assert torch.equal(lens.cpu(), want_lens)
    torch.testing.assert_close(samples.cpu(), want, rtol=0, atol=1e-5)


def test_bank_step_groups_on_card(dev):
    """Four channels of the bench stimulus in groups of two and as one
    batch: equal detections, flags and bytes, every packet decoded."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (60, 128, 9)]
    burst = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(payloads)])
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1), dev)
    fp = rx.front_pad
    x = torch.zeros(4, fp + 16384 + rx.pad_tail(), dtype=torch.complex64, device=dev)
    for c in range(4):
        rot = np.exp(0.3j * c) * burst
        x[c, fp + 50 * c : fp + 50 * c + burst.size] = torch.from_numpy(rot.astype(np.complex64)).to(dev)
    g2, g0 = rx.bank_step(x, 2), rx.bank_step(x, 0)
    for name in ("index", "valid", "freq_bin", "overflow"):
        assert torch.equal(getattr(g2[0], name), getattr(g0[0], name)), name
    for name in ("accepted", "crc_ok", "lengths", "data"):
        assert torch.equal(getattr(g2[2], name), getattr(g0[2], name)), name
    assert torch.equal(g2[3], g0[3])
    assert int(g2[2].accepted.sum()) == 4 * len(payloads)


def test_bank_step_tracing_adds_no_device_operation(dev):
    """The port's spans (``utils/trace.py``) under torch.profiler: a
    ``bank_step`` of a four-channel bank launches the same device
    operations and synchronises as often with program tracing on as off,
    gives the same outputs (each session on a copy of the bank that the
    receiver has not seen, so that both steps run eagerly: a bank seen
    before replays CUDA graphs, held to the eager step in
    ``test_bank_step_graphs_bit_identical``). Every ``rx.*`` stage span has a device time
    from its events, and every span that launches device work itself (the
    sub-spans, ``rx.suppress``, and ``rx.step`` for the flattening between
    stages) has a GPU-side annotation: the profiler puts each kernel in the
    innermost span that launched it, so a stage whose work all lies in its
    sub-spans has none of its own."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils import trace
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    burst = np.concatenate([burst_samples(rng.integers(0, 256, n, dtype=np.uint8), packet_index=i)
                            for i, n in enumerate((60, 128, 9))])
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier="vv"), dev)
    fp = rx.front_pad
    x = torch.zeros(4, fp + 16384 + rx.pad_tail(), dtype=torch.complex64, device=dev)
    for c in range(4):
        x[c, fp + 50 * c : fp + 50 * c + burst.size] = torch.from_numpy(
            (np.exp(0.3j * c) * burst).astype(np.complex64)).to(dev)
    rx.bank_step(x, 0)
    cuda = torch.autograd.DeviceType.CUDA
    stages = ("rx.step", "rx.acquire", "rx.headers", "rx.suppress", "rx.payload")
    launching = {"span:rx." + s for s in (
        "step", "suppress", "acquire.correlate", "acquire.peaks", "acquire.estimate", "headers.extract",
        "headers.costas", "headers.ldpc", "payload.extract", "payload.carrier", "payload.crc")}

    banks = {False: x.clone(), True: x.clone()}

    def session(on):
        trace.enable(on)
        trace.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = rx.bank_step(banks[on], 0)
            torch.cuda.synchronize()
        trace.enable(False)
        evs = list(prof.events())
        ops = Counter(e.name for e in evs if e.device_type == cuda
                      and not (getattr(e, "is_user_annotation", False) or e.name.startswith("span:")))
        gpu_spans = {e.name for e in evs if e.device_type == cuda and e.name.startswith("span:")}
        syncs = sum("Synchronize" in e.name for e in evs if e.device_type != cuda)
        return ops, gpu_spans, syncs, out

    try:
        ops_off, spans_off, syncs_off, out_off = session(False)
        ops_on, spans_on, syncs_on, out_on = session(True)
        tot = trace.totals()["spans"]
    finally:
        trace.enable(False)
        trace.reset()
    assert sum(ops_off.values()) > 0 and ops_on == ops_off
    assert syncs_on == syncs_off
    assert not spans_off and spans_on == launching, spans_on
    assert all(tot[s]["device_ms"] > 0 for s in stages), tot
    assert int(out_on[2].accepted.sum()) == 12
    for a, b in zip(out_off[:3], out_on[:3]):
        for f in vars(a):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def _graph_bank(rx, channels, seed):
    """``channels`` channels of three bursts each, channel c rotated by
    0.3 (c + seed) rad and starting 50 c + 97 seed samples in."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(4)
    burst = np.concatenate([burst_samples(rng.integers(0, 256, n, dtype=np.uint8), packet_index=i)
                            for i, n in enumerate((60, 128, 9))])
    fp = rx.front_pad
    x = torch.zeros(channels, fp + 16384 + rx.pad_tail(), dtype=torch.complex64)
    for c in range(channels):
        at = fp + 50 * (c % 8) + 97 * seed
        x[c, at : at + burst.size] = torch.from_numpy((np.exp(0.3j * (c + seed)) * burst).astype(np.complex64))
    return x.to(rx.arm_taps.device)


def _same_step(a, b):
    from dataclasses import fields

    for u, v in zip(a[:3], b[:3]):
        for f in fields(u):
            p, q = getattr(u, f.name), getattr(v, f.name)
            assert p.dtype == q.dtype and p.shape == q.shape and torch.equal(p, q), f.name
    assert torch.equal(a[3], b[3])


def _cloned(out):
    from dataclasses import fields, replace

    return (*(replace(o, **{f.name: getattr(o, f.name).clone() for f in fields(o)}) for o in out[:3]),
            out[3].clone())


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_bank_step_graphs_bit_identical(dev, carrier):
    """``bank_step`` replaying its stages from CUDA graphs: four banks
    cycled three times (eager, captured, replayed), every step bit-
    identical to the eager stages on its bank, with the launch counts of
    the eager step; captures only at each bank's second sight; the results
    of a replayed step unchanged after the eight steps after it; with
    program tracing on, every step eager."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils import trace

    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier=carrier), dev)
    banks = [_graph_bank(rx, 4, s) for s in range(4)]
    want = []
    for x in banks:  # the stages outside a step: eager
        _build.reset_launch_counts()
        want.append(rx.decode_bank(x, rx.acquirer.acquire(x)))
        eager_launches = _build.launch_counts()
    assert rx.graph_counts() == {"captured": 0, "replayed": 0, "eager": 0, "evicted": 0}
    got = []
    for i in range(12):
        _build.reset_launch_counts()
        got.append(rx.bank_step(banks[i % 4], 0))
        assert _build.launch_counts() == eager_launches, i
        kind = ("eager", "captured", "replayed")[i // 4]
        assert rx.graph_counts()[kind] == i % 4 + 1, (i, rx.graph_counts())
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        _same_step(out, want[i % 4])
    assert int(got[-1][2].accepted.sum()) == 4 * 3
    kept = _cloned(got[8])
    for i in range(8):
        rx.bank_step(banks[(i + 1) % 4], 0)
    torch.cuda.synchronize()
    _same_step(got[8], kept)
    assert rx.graph_counts() == {"captured": 4, "replayed": 12, "eager": 4, "evicted": 0}
    trace.enable(True)
    try:
        for x, w in zip(banks[:2], want):
            _same_step(rx.bank_step(x, 0), w)
    finally:
        trace.enable(False)
        trace.reset()
    assert rx.graph_counts() == {"captured": 4, "replayed": 12, "eager": 6, "evicted": 0}


MIXED_LENGTHS = (10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34, 4096)


def _mixed_bank(rx, channels):
    """Two runs of upstream's 15 loopback lengths (test/qa_loopback.cpp:31-49)
    back to back on each channel of a 2^19-sample block, each packet whole,
    channel c at upstream's carrier offset 0, +0.006 or -0.02 rad/sample
    (c mod 3) and noise 0.05 a component."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(19)
    run = np.concatenate([burst_samples(rng.integers(0, 256, n, dtype=np.uint8), packet_index=i)
                          for i, n in enumerate(MIXED_LENGTHS)])
    block, fp = 1 << 19, rx.front_pad
    t = np.arange(block)
    x = np.zeros((channels, fp + block + rx.pad_tail()), np.complex64)
    for c in range(channels):
        row = np.zeros(block, np.complex64)
        at = 500 + 3000 * c
        row[at : at + 2 * run.size] = np.tile(run, 2)
        noise = 0.05 * (rng.standard_normal(block) + 1j * rng.standard_normal(block))
        x[c, fp : fp + block] = row * np.exp(1j * ((0.0, 0.006, -0.02)[c % 3] * t + 0.4 * c)) + noise
    return torch.from_numpy(x).to(rx.arm_taps.device)


def test_bank_step_graphs_mixed4k(dev):
    """The configuration ``rx_costas_mixed4k`` (4096-byte slots of 16,400
    symbols, extracted in nine 2048-symbol chunks; 56 slots; Costas) on
    four channels of upstream's loopback mix: the captured and the replayed
    steps are bit-identical to the eager step, every packet decodes, the
    4096-byte ones included, and every step adds the same work counters,
    eager or replayed: ``rx.extract.chunks`` 1 + 9,
    ``rx.payload.slot_symbols`` 4 x 56 x 16,400,
    ``rx.payload.crc_kernel_rows`` 4 x 56 and ``rx.extract.fused_rows``
    2 x 4 x 56 (both passes' rows through the fused extraction)."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils import trace

    rx = Receiver(RxConfig(max_payload_len=4096, max_detections=56, freq_bins=4, acquisition_backend="fused",
                           acquisition_fft_size=2048, payload_carrier="costas"), dev)
    x = _mixed_bank(rx, 4)
    names = ("rx.extract.chunks", "rx.payload.slot_symbols", "rx.payload.crc_kernel_rows",
             "rx.extract.fused_rows")
    steps, added = [], []
    for _ in range(4):  # eager, captured, replayed, replayed
        before = trace.counters()
        steps.append(rx.bank_step(x, 0))
        after = trace.counters()
        added.append({n: after.get(n, 0) - before.get(n, 0) for n in names})
    torch.cuda.synchronize()
    for out in steps[1:]:
        _same_step(out, steps[0])
    assert rx.graph_counts() == {"captured": 1, "replayed": 2, "eager": 1, "evicted": 0}
    assert added == [dict(zip(names, (10, 4 * 56 * 16400, 4 * 56, 2 * 4 * 56)))] * 4, added
    res = steps[-1][2]
    lengths = res.lengths[res.accepted]
    assert len(lengths) == 4 * 2 * len(MIXED_LENGTHS) and int((lengths == 4096).sum()) == 4 * 2


def test_bank_step_graphs_grouped(dev):
    """``bank_step(x, 16)`` on 32 channels: a chain of five graphs a group,
    the captured and the replayed step bit-identical to the eager one."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier="vv"), dev)
    x = _graph_bank(rx, 32, 1)
    steps = [rx.bank_step(x, 16) for _ in range(3)]
    torch.cuda.synchronize()
    for out in steps[1:]:
        _same_step(out, steps[0])
    assert int(steps[0][2].accepted.sum()) == 32 * 3
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
    # a group's graphs: the peak search, the estimates, headers, suppression, payload
    assert sum(len(s.stages) for s in rx.step_graphs.chains.values()) == 2 * 5


@pytest.mark.parametrize("carrier,group", [("vv", 0), ("costas", 0), ("vv", 16)])
def test_bank_step_graphs_follow_new_contents(dev, carrier, group):
    """One bank overwritten in place with other samples before every step:
    the captured step and each replay recompute from the bank's current
    contents, bit-identical to the eager step on those samples (the same
    samples at another address, seen once, so run eagerly)."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier=carrier), dev)
    channels = 32 if group else 4
    contents = [_graph_bank(rx, channels, s) for s in range(3)]
    want = [rx.bank_step(c, group) for c in contents]
    for w in want:
        assert int(w[2].accepted.sum()) == channels * 3
    x = torch.empty_like(contents[0])
    got = []
    for i in range(7):
        x.copy_(contents[i % 3])
        got.append(rx.bank_step(x, group))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        _same_step(out, want[i % 3])
    assert rx.graph_counts() == {"captured": 1, "replayed": 5, "eager": 4, "evicted": 0}


def test_bank_step_graphs_on_another_device():
    """A receiver on a card that is not the current device: its steps
    capture and replay on that card's stream, bit-identical to the eager
    step, and the current device is left as it was."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    torch.cuda.set_device(0)
    other = torch.device("cuda", 1)
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier="vv"), other)
    contents = [_graph_bank(rx, 4, s) for s in range(2)]
    assert contents[0].device == other
    want = [rx.bank_step(c, 0) for c in contents]
    x = torch.empty_like(contents[0])
    got = []
    for i in range(6):
        x.copy_(contents[i % 2])
        got.append(rx.bank_step(x, 0))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    for i, out in enumerate(got):
        _same_step(out, want[i % 2])
    assert rx.graph_counts() == {"captured": 1, "replayed": 4, "eager": 3, "evicted": 0}


def test_sharded_bank_world_one_nccl(dev):
    """``StreamingShardedBank`` on a 1 x 1 NCCL mesh (one process, a
    ``tcp://`` store on localhost) gives ``StreamingBank``'s packets on the
    card in the same order, at tests/test_torch_serving.py's configuration."""
    import socket

    import torch.distributed as dist

    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.parallel.bank import make_mesh
    from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(12)
    x = np.zeros((2, 3 * 4096 + 9000), np.complex64)
    for c in range(2):
        pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in rng.integers(20, 128, 4)]
        b = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(pays)])
        x[c, 150 + 731 * c : 150 + 731 * c + b.size] = b * np.exp(0.3j * c)
    cfg = RxConfig(max_payload_len=128, max_detections=4, freq_bins=1)
    ref = StreamingBank(cfg, dev, channels=2, block=4096, group=0, transfer_dtype=torch.int8)
    want = ref.process(x) + ref.flush()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        bank = StreamingShardedBank(make_mesh(1), cfg, channels=2, block=4096, group=0,
                                    transfer_dtype=torch.int8)
        got = bank.process(x) + bank.flush()
    finally:
        dist.destroy_process_group()
    assert len(want) == 8
    assert [(p.channel, p.index, p.data.tobytes(), p.arm) for p in got] == \
        [(p.channel, p.index, p.data.tobytes(), p.arm) for p in want]


@pytest.mark.parametrize("b", [1, 300, 1537])
def test_header_decoder_card_matches_cpu(dev, b):
    """``HeaderLdpcDecoder`` on the card (one K5 launch a call) gives the
    CPU decoder's bits and flags bit for bit, failing codewords included."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import ldpc_encode_bytes

    rng = np.random.default_rng(b)
    headers = rng.integers(0, 256, (b, 4), dtype=np.uint8)
    cw = np.unpackbits(np.stack([ldpc_encode_bytes(h)[:16] for h in headers]), axis=1)
    sigma = np.sqrt(1.0 / (2 * 10 ** (rng.uniform(-6, 4, (b, 1)) / 10)))
    llr = ((2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))).astype(np.float32)
    before = _build.launch_counts()["ldpc"]
    bits, ok = ldpc.HeaderLdpcDecoder(25, device=dev).decode(torch.from_numpy(llr).to(dev))
    assert _build.launch_counts()["ldpc"] == before + 1
    cbits, cok = ldpc.HeaderLdpcDecoder(25, device="cpu").decode(torch.from_numpy(llr))
    assert torch.equal(bits.cpu(), cbits) and torch.equal(ok.cpu(), cok)


def test_transceiver_app_burst_loopback_on_card(dev):
    """The transceiver app in burst mode on the card (CFO 0.005, SFO 1.2
    ppm): every packet sent is received byte-exact, through every kernel
    of a receive."""
    from gr4_packet_modem_tpu_torch.apps import packet_transceiver

    _build.reset_launch_counts()
    res = packet_transceiver.run(
        ["--device", "cuda", "--seconds", "1", "--cfo", "0.005", "--sfo", "1.2", "--samp-rate", "1e12"],
        echo=lambda *a: None,
    )
    launches = _build.launch_counts()
    assert res["sent"] >= 4 and res["received"] == res["sent"] == len(res["sent_payloads"])
    assert all(np.array_equal(p.data, q) for p, q in zip(res["decoded"], res["sent_payloads"]))
    assert all(launches[k] > 0 for k in RECEIVE_KERNELS), launches


def test_u16_max_costas_decodes_on_card(dev):
    """tests/test_large_payload.py's 65,535-byte payload with the Costas
    carrier on the card (its CPU plain loop is out of Tier-1's reach): the
    port's transmitter, ``rotate`` by 0.001, noise of 0.02 a component
    from numpy, ``Receiver.receive``; accepted byte-exact at its length,
    K4 on the header and the 262,156-symbol payload, the fused extraction
    once a pass (the payload's 129 chunks in one launch)."""
    from gr4_packet_modem_tpu_torch.models.channel import rotate
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat

    max_len = 65535
    payload = np.random.default_rng(11).integers(0, 256, max_len, dtype=np.uint8)
    s, n = Transmitter(TxConfig(max_payload_len=max_len), dev).modulate_bursts(
        PacketBatch.from_list([payload], max_len, dev))
    x = rotate(ragged_concat(s, n, int(n.sum()))[0], 0.001).cpu().numpy()
    rng = np.random.default_rng(111)
    x = (x + 0.02 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))).astype(np.complex64)
    rx = Receiver(RxConfig(max_payload_len=max_len, max_detections=2, freq_bins=1,
                           payload_carrier="costas"), dev)
    _build.reset_launch_counts()
    res = rx.receive(x)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    acc = res.accepted.cpu().numpy()
    assert acc.sum() == 1
    row = int(np.nonzero(acc)[0][0])
    assert int(res.lengths[row]) == max_len
    np.testing.assert_array_equal(res.data[row, :max_len].cpu().numpy(), payload)
    assert launches["costas"] == 2 and launches["matched"] == 2 and launches["fetch"] == 1, launches
    assert all(launches[k] > 0 for k in RECEIVE_KERNELS), launches


def _crc_pass_rows(d):
    """The rows of :func:`_crc_rows` that carry their own CRC."""
    return sorted({2 % d, d // 2, (d // 2 + 1) % d, d - 1})


def _crc_rows(dev, d, max_len, seed):
    """Payload symbols ``[d, 4 (max_len + 4)]`` of random bytes with ragged
    lengths (0, 1, ``max_len``, past it up to 65,535, negative, the rest
    random), a few rows carrying their own CRC after their bytes, and some
    symbols exactly +0.0, -0.0 and NaN; with the LLR scale, the packed
    keystream and the CRC tables of a receiver of ``max_len``: the
    arguments of ``payload_crc``."""
    from gr4_packet_modem_tpu_torch.models.tables import tables_from_numpy
    from gr4_packet_modem_tpu_torch.ops.scramble import keystream_np
    from gr4_packet_modem_tpu_torch.utils import constants as C

    s_pay = 4 * (max_len + 4)
    ks = keystream_np(C.HEADER_LLRS + 2 * s_pay)[C.HEADER_LLRS :]
    scale = np.float32(2.0 / C.LLR_NOISE_SIGMA**2)
    g = torch.Generator(device=dev).manual_seed(seed)
    sym = torch.randn(d, s_pay, generator=g, device=dev, dtype=torch.complex64)
    rng = np.random.default_rng(seed)
    plen = rng.integers(0, max_len + 1, d)
    edges = (0, 1, max_len, max_len + 1, 65_535, -2)
    plen[: min(d, 6)] = edges[:d]
    if d > 9:
        plen[6 : max(6, d // 4)] = rng.integers(max_len + 1, 65_536, max(0, d // 4 - 6))  # garbage headers
    flat = torch.view_as_real(sym).view(d, 2 * s_pay)
    flat[7 % d, :40] = 0.0
    flat[8 % d, 3::5] = -0.0
    flat[9 % d, 11::7] = float("nan")
    for row in _crc_pass_rows(d):  # CRC after the bytes: these pass
        n = min(max(int(plen[row]), 0), max_len)
        v = flat[row].cpu().numpy()
        p = v * scale
        msg = np.packbits((np.where(ks == 1, -p, p) < 0).astype(np.uint8))[:n]
        bits = np.unpackbits(np.frombuffer(crc32_ref(msg).to_bytes(4, "big"), np.uint8))
        at = slice(8 * n, 8 * n + 32)
        sign = 1.0 - 2.0 * (bits ^ ks[at])
        flat[row, at] = torch.from_numpy((0.5 * sign).astype(np.float32)).to(dev)
    ks_bytes = torch.from_numpy(np.packbits(ks)).to(dev)
    t = tables_from_numpy(crc32_tables(max_len))
    tables = tuple(t[k].to(dev) for k in ("g_packed", "init_lut", "final_xor"))
    return (sym, torch.tensor(scale, device=dev), ks_bytes, torch.from_numpy(plen).to(dev), *tables)


def _same_check(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v)
    assert torch.equal(a[1] == a[2], b[1] == b[2])


@pytest.mark.parametrize("d,max_len", [(1536, 1536), (3584, 4096), (37, 128), (5, 65535)])
def test_payload_crc_kernel_matches_plain(dev, d, max_len):
    """The payload CRC kernel bit-identical to its plain version on every
    row: payload bytes, the CRC words computed and received, and their
    equality, at the dense cells' [1536, 6160] / 1536 B and the mixed
    cell's [3584, 16400] / 4096 B, a small bound and the u16 bound (16
    tiles a row). One launch; ``rx.payload.crc_kernel_rows`` counts D."""
    from gr4_packet_modem_tpu_torch.utils import trace

    args = _crc_rows(dev, d, max_len, seed=d + max_len)
    before_l, before_c = _build.launch_counts()["crc"], trace.counters().get("rx.payload.crc_kernel_rows", 0)
    got = payload_crc(*args)
    assert _build.launch_counts()["crc"] == before_l + 1
    assert trace.counters()["rx.payload.crc_kernel_rows"] == before_c + d
    torch.cuda.synchronize()
    want = payload_crc_plain(*args)
    _same_check(got, want)
    assert set(_crc_pass_rows(d)) <= set(torch.nonzero(got[1] == got[2]).flatten().tolist())


@pytest.mark.parametrize("d,max_len", [(1536, 1536), (3584, 4096)])
def test_payload_crc_kernel_in_a_cuda_graph(dev, d, max_len):
    """The kernel captured into a CUDA graph: each replay, with the lengths
    and the symbols changed in place between replays, is bit-identical to
    the plain version on the inputs of that moment."""
    args = _crc_rows(dev, d, max_len, seed=3)
    sym, plen = args[0], args[3]
    payload_crc(*args)  # the library loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = payload_crc(*args)
    rng = np.random.default_rng(4)
    for i in range(3):
        if i:
            plen.copy_(torch.from_numpy(rng.integers(-5, 70_000, d)).to(dev))
            sym.copy_(_crc_rows(dev, d, max_len, seed=10 + i)[0])
        graph.replay()
        torch.cuda.synchronize()
        _same_check(out, payload_crc_plain(*args))


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_bank_step_graphs_check_payloads_in_one_kernel(dev, carrier, monkeypatch):
    """A graphed ``bank_step`` (eager, captured, replayed) checks its
    payloads with the kernel alone: one ``crc`` launch a step,
    ``rx.payload.crc_kernel_rows`` D a step, and ``crc32_compute`` never
    called; the replayed step bit-identical to the eager one."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.ops import crc
    from gr4_packet_modem_tpu_torch.utils import trace

    def refused(*a, **k):
        raise AssertionError("crc32_compute called on the card's path")

    monkeypatch.setattr(crc, "crc32_compute", refused)
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier=carrier), dev)
    x = _graph_bank(rx, 4, 2)
    steps = []
    for _ in range(3):
        _build.reset_launch_counts()
        before = trace.counters().get("rx.payload.crc_kernel_rows", 0)
        steps.append(rx.bank_step(x, 0))
        assert _build.launch_counts()["crc"] == 1
        assert trace.counters()["rx.payload.crc_kernel_rows"] - before == 4 * 8
    torch.cuda.synchronize()
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
    for out in steps[1:]:
        _same_step(out, steps[0])
    assert int(steps[-1][2].accepted.sum()) == 4 * 3


# the fused extraction's shapes: rows, symbols, chunk, first symbol, channels
# and samples a channel (the cells' banks: 64 x 553,396 dense, 594,356 mixed)
EXTRACT_SHAPES = {
    "header": (1536, 192, 192, 0, 64, 553_396),
    "dense_payload": (1536, 6160, 6160, 192, 64, 553_396),
    "mixed_payload": (3584, 16400, 2048, 192, 64, 594_356),
    "u16_envelope": (2, 262_156, 2048, 192, 1, 1_100_000),
}


def _extract_args(dev, name, seed, shift=0):
    """The fused extraction's arguments at ``EXTRACT_SHAPES[name]``: a
    random complex64 bank (flattened, starting ``shift`` samples into its
    allocation, so that a start's sample parity and its 16-byte alignment
    trade places), rows on random channels with starts of both parities,
    two of them near the row's end (their chunks clamped to
    ``row_len - R``) and two near its start; CFOs to 0.03 rad/sample,
    random arm taps and amplitude scales."""
    d, s, chunk, off, chans, row_len = EXTRACT_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(chans * row_len + shift, generator=g, device=dev, dtype=torch.complex64)
    x = flat[shift:]
    chan = torch.randint(0, chans, (d,), generator=g, device=dev)
    span = 4 * (off + s)
    n_base = torch.randint(0, max(1, row_len - span), (d,), generator=g, device=dev)
    n_base[: min(d, 4)] = torch.tensor([row_len - 3001, 20, row_len - 500, 7], device=dev)[: min(d, 4)]
    n_base[4:] += torch.arange(d - min(d, 4), device=dev) % 2  # both parities
    arm_taps = 0.3 * torch.randn(32, 44, generator=g, device=dev)
    arm = torch.randint(0, 32, (d,), generator=g, device=dev)
    freq = 0.06 * torch.rand(d, generator=g, device=dev) - 0.03
    n0 = n_base - torch.randint(0, 60, (d,), generator=g, device=dev)
    amp = 0.5 + 1.5 * torch.rand(d, generator=g, device=dev)
    return (x, row_len, n_base, chan if chans > 1 else None, arm, arm_taps, freq, n0, amp, 4, off, s, chunk)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("name", list(EXTRACT_SHAPES))
def test_fused_extraction_matches_plain_chain(dev, name, shift):
    """The fused extraction kernel (one launch, ``rx.extract.fused_rows``
    counting its rows) against the unfused chain run on the card (K2's,
    the derotation's and K3's plain passes, the scaling, chunk by chunk):
    within K3's tolerance at the header, dense-payload, mixed-payload
    (nine chunks, rows clamped at the row's end) and u16-envelope shapes,
    on a bank aligned to 16 bytes and one shifted by a sample."""
    from gr4_packet_modem_tpu_torch.utils import trace

    args = _extract_args(dev, name, seed=len(name) + shift, shift=shift)
    before_l = _build.launch_counts()["matched"]
    before_c = trace.counters().get("rx.extract.fused_rows", 0)
    got = extract_symbols(*args)
    assert _build.launch_counts()["matched"] == before_l + 1
    assert trace.counters()["rx.extract.fused_rows"] == before_c + args[2].shape[0]
    torch.cuda.synchronize()
    want = extract_symbols_plain(*args)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("name", ["header", "dense_payload", "mixed_payload"])
def test_fused_extraction_equals_unfused_kernel_chain(dev, name, shift):
    """The fused extraction bit for bit against the chain of kernels it
    replaced: a chunk at a time K2 (``fetch_regions``), the derotation in
    PyTorch, K3's plane entry (``matched_filter``) and the scaling, the
    chunks joined and cut (``extract_symbols_plain`` given K2's and K3's
    wrappers), at the header, dense-payload and mixed-payload shapes, on a
    bank aligned to 16 bytes and one shifted by a sample."""
    args = _extract_args(dev, name, seed=3 + len(name) + shift, shift=shift)
    chunks = -(-args[11] // args[12])
    got = extract_symbols(*args)
    before = _build.launch_counts()
    want = extract_symbols_plain(*args, fetch=fetch_regions, filt=matched_filter)
    after = _build.launch_counts()
    assert (after["fetch"] - before["fetch"], after["matched"] - before["matched"]) == (chunks, chunks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["header", "mixed_payload"])
def test_fused_extraction_in_a_cuda_graph(dev, name):
    """The fused extraction captured into a CUDA graph: each replay, with
    the bank, the starts and the CFOs changed in place between replays, is
    bit-identical to an eager launch on the inputs of that moment and
    within K3's tolerance of the plain chain."""
    args = _extract_args(dev, name, seed=11)
    x, n_base, freq = args[0], args[2], args[6]
    extract_symbols(*args)  # the library loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = extract_symbols(*args)
    for i in range(3):
        if i:
            fresh = _extract_args(dev, name, seed=20 + i)
            x.copy_(fresh[0])
            n_base.copy_(fresh[2])
            freq.copy_(fresh[6])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, extract_symbols(*args))
        torch.testing.assert_close(out, extract_symbols_plain(*args), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_bank_step_graphs_extract_in_one_launch_a_pass(dev, carrier, monkeypatch):
    """A graphed ``bank_step`` (eager, captured, replayed) extracts each
    pass's symbols with one launch of the fused kernel: two ``matched``
    launches a step and one ``fetch`` (acquisition's noise window),
    ``rx.extract.fused_rows`` 2 x D a step, and neither the plain chain nor
    ``torch.cos``/``torch.sin`` called inside an extraction; the replayed
    step bit-identical to the eager one."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.ops import matched_cuda
    from gr4_packet_modem_tpu_torch.utils import trace

    inside = []

    def refused(*a, **k):
        raise AssertionError("the plain extraction ran on the card's path")

    def guarded(fn):
        def call(*a, **k):
            if inside:
                raise AssertionError(f"{fn.__name__} called inside an extraction")
            return fn(*a, **k)
        return call

    extract = Receiver._extract_symbols

    def traced_extract(self, *a, **k):
        inside.append(1)
        try:
            return extract(self, *a, **k)
        finally:
            inside.pop()

    monkeypatch.setattr(matched_cuda, "extract_symbols_plain", refused)
    monkeypatch.setattr(torch, "cos", guarded(torch.cos))
    monkeypatch.setattr(torch, "sin", guarded(torch.sin))
    monkeypatch.setattr(Receiver, "_extract_symbols", traced_extract)
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier=carrier), dev)
    x = _graph_bank(rx, 4, 3)
    steps = []
    for _ in range(3):
        _build.reset_launch_counts()
        before = trace.counters().get("rx.extract.fused_rows", 0)
        steps.append(rx.bank_step(x, 0))
        launches = _build.launch_counts()
        assert launches["matched"] == 2 and launches["fetch"] == 1, launches
        assert trace.counters()["rx.extract.fused_rows"] - before == 2 * 4 * 8
    torch.cuda.synchronize()
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
    for out in steps[1:]:
        _same_step(out, steps[0])
    assert int(steps[-1][2].accepted.sum()) == 4 * 3


def test_bank_step_graphs_skip_empty_slots_in_k4(dev):
    """A graphed Costas ``bank_step`` (eager, captured, replayed) hands K4
    every row twice a step (``rx.costas.rows`` 2 x D) and K4 skips the
    slots with no detection in both passes (``skipped_rows`` 2 x the
    invalid slots), replayed steps included; the replayed step
    bit-identical to the eager one."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.utils import trace

    rx = Receiver(RxConfig(max_payload_len=128, max_detections=8, freq_bins=1, payload_carrier="costas"), dev)
    x = _graph_bank(rx, 4, 3)
    steps = []
    for _ in range(3):
        _build.reset_launch_counts()
        rows, skipped = trace.counters().get("rx.costas.rows", 0), skipped_rows(dev)
        steps.append(rx.bank_step(x, 0))
        assert _build.launch_counts()["costas"] == 2
        assert trace.counters()["rx.costas.rows"] - rows == 2 * 4 * 8
        invalid = int((~steps[-1][0].valid).sum())
        assert 0 < invalid < 4 * 8
        assert skipped_rows(dev) - skipped == 2 * invalid
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
    for out in steps[1:]:
        _same_step(out, steps[0])
    assert int(steps[-1][2].accepted.sum()) == 4 * 3


def test_transceiver_bank_step(dev):
    """The transceiver bank on the card (``models/transceiver.py``): four
    links of a 2**17-sample block, four 1500-byte bursts a link a step, the
    Costas carrier, inputs staged from pinned host memory. Five steps of
    new payloads, offsets, carrier offsets and phases: the receive stages
    run eager, captured, then replayed (the bank keeps its address); every
    payload decodes byte-exact; each TX bank lies within 1e-5 of the plain
    reference TX (``h100_bench/reference/transmitter.py``) at the link's
    carried GLFSR index, and each received bank within 1e-4 of the
    reference channel of that TX bank; ``tx.packets`` counts once a step."""
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank
    from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig
    from gr4_packet_modem_tpu_torch.utils import constants as C
    from gr4_packet_modem_tpu_torch.utils import trace
    from h100_bench.reference.transmitter import ReferenceTransmitter, channel

    links, bursts, block, n = 4, 4, 1 << 17, 1500
    burst_len = 4 * C.burst_symbols(n)
    rx = RxConfig(max_payload_len=1536, max_detections=8, freq_bins=4, acquisition_backend="fused",
                  acquisition_fft_size=2048, payload_carrier="costas")
    loop = TransceiverBank(TxConfig(max_payload_len=1536), rx, links, bursts, block, dev,
                           generator=torch.Generator(device=dev).manual_seed(9))
    ref = ReferenceTransmitter(dev)
    rng = np.random.default_rng(31)
    fp, d = loop.rx.front_pad, rx.max_detections
    for s in range(5):
        data = np.zeros((links, bursts, 1536), np.uint8)
        data[..., :n] = rng.integers(0, 256, (links, bursts, n))
        offset = rng.integers(0, block - bursts * burst_len + 1, links)
        cfo, phase = rng.uniform(-0.006, 0.006, links), rng.uniform(-np.pi, np.pi, links)
        inputs = [torch.from_numpy(a).pin_memory() for a in (data, np.full((links, bursts), n), offset, cfo, phase)]
        state = loop.generator.get_state()
        before = trace.counters().get("tx.packets", 0)
        out, host = loop.step(*inputs)
        torch.cuda.synchronize()
        assert trace.counters()["tx.packets"] - before == links * bursts
        kind = ("eager", "captured", "replayed", "replayed", "replayed")[s]
        assert loop.rx.graph_counts()[kind] == max(1, s - 1), (s, loop.rx.graph_counts())
        frames = [[ref.data_symbols(p[:n]) for p in row] for row in data]
        want = ref.bank(frames, np.full(links, s * bursts), offset, block)
        assert float((loop.tx_bank - want).abs().max()) < 1e-5, s
        want = channel(loop.tx_bank, cfo, phase, loop.noise, state, fp, loop.rx.pad_tail())
        assert float((loop.bank - want).abs().max()) < 1e-4, s
        got = {(int(r) // d, int(i)): host.data[j, : int(host.length[j])].numpy()
               for j, (r, i) in enumerate(zip(host.row, host.index))}
        assert len(got) == links * bursts and bool(host.crc_ok.all())
        for c in range(links):
            for k in range(bursts):
                start = fp + int(offset[c]) + k * burst_len
                near = [v for (ch, i), v in got.items() if ch == c and abs(i - start) <= 24]
                assert len(near) == 1 and np.array_equal(near[0], data[c, k, :n]), (s, c, k)


def test_transceiver_stream_graphed_equals_eager(dev):
    """The transceiver bank in stream mode on the card (``models/
    transceiver.py``: ``stream_step``): four links of a 2**17-sample block,
    back-to-back 1500-byte user packets and 256-byte IDLE packets, the
    Costas carrier, inputs staged from pinned host memory. Two banks with
    the same seeds take the same six steps, one with its receive stages
    from CUDA graphs (eager, captured, then replayed: the bank and the
    suppression state keep their addresses), the other eager throughout:
    every step's rows, packets, received bank and handed-on state are
    equal, as are the stream row counts the graphed steps added on the
    card; every user packet whose syncword lies in a fresh window is
    delivered once, and no IDLE packet."""
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank
    from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig
    from gr4_packet_modem_tpu_torch.utils import constants as C

    links, block, slots, sps = 4, 1 << 17, 16, 4
    syms, idle = block // sps, int(C.PacketType.IDLE)
    rx = RxConfig(max_payload_len=1536, max_detections=slots, freq_bins=4, acquisition_backend="fused",
                  acquisition_fft_size=2048, payload_carrier="costas")
    rng = np.random.default_rng(41)
    packets = []  # per link: (start symbol, payload, type)
    for _ in range(links):
        row, pos, seq = [], 0, 0
        while pos < 7 * syms:
            for t in rng.permutation([0] * 9 + [idle] * 7):
                p = (((np.arange(256) + seq) % 255).astype(np.uint8) if t == idle
                     else rng.integers(0, 256, 1500, dtype=np.uint8))
                seq += t == idle
                row.append((pos, p, int(t)))
                pos += C.stream_symbols(p.size)
        packets.append(row)
    cfo, phase = torch.from_numpy(rng.uniform(-0.006, 0.006, links)), torch.from_numpy(rng.uniform(-np.pi, np.pi, links))
    banks = []
    for graphed in (True, False):
        loop = TransceiverBank(TxConfig(max_payload_len=1536, stream_mode=True), rx, links, slots, block, dev,
                               generator=torch.Generator(device=dev).manual_seed(13))
        loop.tune(cfo, phase)
        if not graphed:
            loop.rx.step_graphs.engages = lambda x: False
        banks.append(loop)
    d, keep = rx.max_detections, banks[0].bank.shape[1] - block
    delivered = set()
    for i in range(6):
        data = np.zeros((links, slots, 1536), np.uint8)
        lengths, types = np.zeros((links, slots), np.int64), np.zeros((links, slots), np.int64)
        for c, row in enumerate(packets):
            for k, (_, p, t) in enumerate(x for x in row if i * syms <= x[0] < (i + 1) * syms):
                data[c, k, : p.size], lengths[c, k], types[c, k] = p, p.size, t
        inputs = [torch.from_numpy(a).pin_memory() for a in (data, lengths, types)]
        (g_out, g_host), (e_out, e_host) = (loop.stream_step(*inputs) for loop in banks)
        torch.cuda.synchronize()
        kind = ("eager", "captured", "replayed", "replayed", "replayed", "replayed")[i]
        assert banks[0].rx.graph_counts()[kind] == max(1, i - 1), (i, banks[0].rx.graph_counts())
        assert banks[1].rx.graph_counts()["eager"] == i + 1
        assert torch.equal(banks[0].bank, banks[1].bank) and torch.equal(banks[0].busy, banks[1].busy), i
        for a, b in zip(g_out, e_out):
            for f in dataclasses.fields(a) if dataclasses.is_dataclass(a) else [None]:
                x, y = (a, b) if f is None else (getattr(a, f.name), getattr(b, f.name))
                assert torch.equal(x, y), (i, f)
        for f in dataclasses.fields(g_host):
            assert torch.equal(getattr(g_host, f.name), getattr(e_host, f.name)), (i, f.name)
        for j in range(g_host.row.numel()):
            n = int(g_host.length[j])
            delivered.add((int(g_host.row[j]) // d, i * block + int(g_host.index[j]) - keep,
                           g_host.data[j, :n].numpy().tobytes()))
    assert banks[0].rx.stream_rows() == banks[1].rx.stream_rows()
    assert banks[0].rx.stream_rows()["idle"] > 0
    want = {(c, sps * s, p.tobytes()) for c, row in enumerate(packets) for s, p, t in row
            if t != idle and sps * s < 6 * block - banks[0].rx.pad_tail()}
    assert delivered == want
