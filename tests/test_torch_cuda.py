"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU (Hopper,
sm_90a) and nvcc; elsewhere they skip. They import no JAX, so they also run
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.ops import _build, ldpc  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_regions, fetch_regions_plain  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter, matched_filter_plain  # noqa: E402

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
    ppm): every packet sent is received byte-exact, through all six
    kernels."""
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
    K4 on the header and the 262,156-symbol payload, K2 and K3 on 129
    payload chunks."""
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
    assert launches["costas"] == 2 and launches["matched"] == 1 + 129, launches
    assert all(launches[k] > 0 for k in RECEIVE_KERNELS), launches
