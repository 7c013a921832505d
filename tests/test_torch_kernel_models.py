"""Numpy models of the schedules of the K1, K2, K2b, K3 and K5 CUDA kernels.

The kernels run only on the card; their schedules are tested here. K1's
model runs the kernel's passes (radices, each thread's 16 points, the
inter-pass twiddles built from the wrapper's float64 bases as the kernel
builds them, the exchanges between passes) from the wrapper's own tables
(``kernel_plan``), and is held against ``numpy.fft`` at every transform
size the kernel takes, so a fault in the tables or the replica permutation
shows here. The exchange buffers' swizzle is checked free of bank
conflicts. K3's phase-split model (``phase_split_reference``, the
kernel's order of sums) is held against the plain version that the CPU
route runs, and so is the fused extraction's (``fused_extraction_model``:
the grid of ``extraction_plan``, the C entry's grid written out here and
its constants read from the kernel's source, each chunk's clamped start,
each staged sample derotated with its products rounded apart, K3's sums,
the scaling, every output written once). K5's model runs BP along the wrapper's warp plan
(``ldpc_cuda.warp_plan``: lane ownership, per-warp publish slots) and is
held bit for bit against the plain version; the plan's limits are checked
against the kernel's source. K2's model copies along the wrapper's thread
plan (``fetch_cuda.fetch_plan``: items of four samples, the float4 and
float2 load branches, the vector or scalar stores, the scalar tail, the
grid) and K2b's along ``fetch_cuda.rows_plan``; both are held bit for bit
against the plain versions, with every output element written once.
K1's bf16 form at N=2048: the register-A step (``bf16(Y * R_b)`` packed
from the forward accumulators' fragments straight into wgmma's A
fragments) is held against the ``[16, N2]`` product, and the persistent
walk (``acquire_cuda.persistent_walk``, its constants read from the
kernel's source) against every frame once. At N=4096 and 8192 the
streaming kernel's walk and table loads (``acquire_cuda.stream_plan``,
its constants and loop bounds read from the kernel's source): every
frame's forward pass once and every (frame, bin) once, every table block
once a pass and in order, each product finding its own block in the
stages at its barrier parity, and no copy started after a block's last
product. The payload CRC kernel (``csrc/crc.cu``): its walk over the
right-aligned frame (tiles of 4096 bytes, 16-byte spans folded a thread,
the warp and block trees joined by the shift matrices, the running
register shifted a tile) is held against the host oracle, and its shift
matrices against zero bytes clocked one at a time.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.ops.acquire_cuda import (  # noqa: E402
    KERNEL_FFT_SIZES,
    POINTS,
    STREAM_CHUNK_K,
    STREAM_COLS,
    STREAM_FFT_SIZES,
    STREAM_FRAMES,
    WG_FRAMES,
    WG_GROUPS,
    WGMMA_FFT_SIZES,
    fragment_index,
    fused_best_power_plain,
    kernel_passes,
    kernel_plan,
    kernel_positions,
    persistent_walk,
    replica_table,
    replica_table_bf16,
    stream_plan,
)
from gr4_packet_modem_tpu_torch.ops import crc, fetch_cuda, ldpc, ldpc_cuda, matched_cuda  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.matched_cuda import (  # noqa: E402
    extract_symbols, extract_symbols_plain, matched_filter_plain,
)
from gr4_packet_modem_tpu_torch.utils.stimulus import ldpc_encode_bytes  # noqa: E402


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


# the fused extraction's grid (csrc/matched.cu: pm_extract_symbols and
# block_threads), for the model below
Q = 9  # consecutive outputs a thread computes (kQ)
THREADS = 128  # most threads a block (kThreads)


def extraction_plan(d: int, num_syms: int, chunk: int) -> dict:
    """The fused extraction's grid for ``d`` rows of ``num_syms`` symbols in
    chunks of ``chunk``: blocks of ``threads`` (enough warps for a chunk,
    at most ``THREADS``), each covering ``block_syms`` = ``Q * threads``
    consecutive symbols of one chunk of one row; ``blocks_per_chunk`` of
    them a chunk, ``chunks`` a row; block ``b`` is row ``b // (chunks *
    blocks_per_chunk)``, chunk ``b // blocks_per_chunk % chunks``, and
    symbols ``b % blocks_per_chunk * block_syms`` on of that chunk."""
    want = -(-chunk // Q)
    threads = THREADS if want >= THREADS else -(-want // 32) * 32
    per_chunk = -(-chunk // (Q * threads))
    chunks = -(-num_syms // chunk)
    return {"threads": threads, "block_syms": Q * threads, "blocks_per_chunk": per_chunk,
            "chunks": chunks, "blocks": d * chunks * per_chunk}


def fused_extraction_model(
    x: np.ndarray, row_len: int, n_base: np.ndarray, chan: np.ndarray | None, arm: np.ndarray,
    arm_taps: np.ndarray, freq: np.ndarray, n0: np.ndarray, amp: np.ndarray, sps: int,
    sym_offset: int, num_syms: int, chunk: int,
) -> np.ndarray:
    """The fused extraction kernel's walk (csrc/matched.cu, kFromBank) in
    float32: block by block of ``extraction_plan``, the chunk's start
    clamped to the row, the window its written outputs need staged from
    the bank (zeros past the region), each sample derotated by
    ``-freq * float32(start + j - n0)`` with every product and sum rounded
    apart, split by phase, summed over p then q with the row's arm
    reversed, scaled, written once into ``[D, num_syms]``."""
    d, k = n_base.shape[0], arm_taps.shape[1]
    plan = extraction_plan(d, num_syms, chunk)
    kq, cs = -(-k // sps), plan["block_syms"]
    per, nch = plan["blocks_per_chunk"], plan["chunks"]
    r = sps * (chunk - 1) + k
    f32 = np.float32
    out = np.zeros((d, num_syms), np.complex64)
    written = np.zeros((d, num_syms), np.int64)
    for b in range(plan["blocks"]):
        row, c, s0 = b // (nch * per), b // per % nch, b % per * cs
        valid = min(cs, min(chunk, num_syms - c * chunk) - s0)
        if valid <= 0:
            continue
        st = min(max(int(n_base[row]) + sps * (sym_offset + c * chunk) - (k - 1), 0), row_len - r)
        base = sps * s0
        i = np.arange(sps * (valid + kq - 1))
        inside = base + i < r
        at = (0 if chan is None else int(chan[row]) * row_len) + st + base + np.where(inside, i, 0)
        v = np.where(inside, x[at], 0).astype(np.complex64)
        ph = f32(-freq[row]) * (st + base + i - int(n0[row])).astype(f32)
        cph, sph = np.cos(ph).astype(f32), np.sin(ph).astype(f32)
        re, im = v.real.astype(f32), v.imag.astype(f32)
        dr = re * cph - im * sph
        di = re * sph + im * cph
        tq = np.zeros(kq * sps, f32)
        tq[:k] = arm_taps[int(arm[row])][::-1]
        acc_r = np.zeros(valid, f32)
        acc_i = np.zeros(valid, f32)
        for p in range(sps):
            pr, pi = dr[p::sps], di[p::sps]
            for q in range(kq):
                acc_r = acc_r + pr[q : q + valid] * tq[q * sps + p]
                acc_i = acc_i + pi[q : q + valid] * tq[q * sps + p]
        cols = slice(c * chunk + s0, c * chunk + s0 + valid)
        out[row, cols] = (acc_r * f32(amp[row])) + 1j * (acc_i * f32(amp[row]))
        written[row, cols] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize(
    "case",
    ["header", "chunked_clamped", "one_capture", "run_time_sps", "ragged_last_chunk"],
)
def test_fused_extraction_model_equals_plain(case):
    """The fused extraction's order (derotate each sample once with
    unfused products, K3's sums over p then q, scale, each chunk's own
    clamped start) against the plain chain of the CPU route (K2's and K3's
    plain versions, the derotation between them, the chunks joined and
    cut): float32 rounding, rtol 1e-5, atol 1e-4. Rows start near the
    row's end (the clamp holds later chunks at ``row_len - R``) and before
    its start (the first chunk clamped to 0); starts of both parities."""
    sps, k, arms = 4, 44, 32
    chans, row_len, sym_offset, num_syms, chunk = 3, 6000, 192, 700, 64
    if case == "header":
        sym_offset, num_syms, chunk = 0, 192, 192
    elif case == "run_time_sps":
        sps, k, arms = 2, 13, 5
    elif case == "ragged_last_chunk":
        num_syms, chunk = 611, 100
    rng = np.random.default_rng(len(case))
    d = 7
    chan = None if case == "one_capture" else rng.integers(0, chans, d)
    if chan is None:
        chans = 1
    x = (rng.standard_normal(chans * row_len) + 1j * rng.standard_normal(chans * row_len)).astype(np.complex64)
    n_base = rng.integers(0, row_len, d)
    n_base[:3] = (3, row_len - 400, row_len - 7)  # clamped at 0, and at the row's end
    n_base[3] = n_base[3] | 1
    arm_taps = (0.3 * rng.standard_normal((arms, k))).astype(np.float32)
    arm = rng.integers(0, arms, d)
    freq = rng.uniform(-0.05, 0.05, d).astype(np.float32)
    n0 = n_base - rng.integers(0, 60, d)
    amp = rng.uniform(0.5, 2.0, d).astype(np.float32)
    got = fused_extraction_model(x, row_len, n_base, chan, arm, arm_taps, freq, n0, amp,
                                 sps, sym_offset, num_syms, chunk)
    args = (torch.from_numpy(x), row_len, torch.from_numpy(n_base),
            None if chan is None else torch.from_numpy(chan), torch.from_numpy(arm),
            torch.from_numpy(arm_taps), torch.from_numpy(freq), torch.from_numpy(n0),
            torch.from_numpy(amp), sps, sym_offset, num_syms, chunk)
    want = extract_symbols_plain(*args)
    assert torch.equal(extract_symbols(*args), want)  # the CPU route is the plain chain
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


def test_fused_extraction_plan_covers_every_symbol():
    """The grid at the receiver's shapes: the header pass, the dense
    payload pass in one chunk, the mixed cell's nine chunks of 2,048 and
    the u16 envelope's 129; the kernel's block and output constants are
    the plan's."""
    src = (Path(matched_cuda.__file__).parents[1] / "csrc" / "matched.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert consts == {"kQ": str(Q), "kThreads": str(THREADS)}
    for d, s, chunk, want in ((1536, 192, 192, (32, 1, 1)), (1536, 6160, 6160, (128, 6, 1)),
                              (3584, 16400, 2048, (128, 2, 9)), (2, 262156, 2048, (128, 2, 129))):
        plan = extraction_plan(d, s, chunk)
        assert (plan["threads"], plan["blocks_per_chunk"], plan["chunks"]) == want
        assert plan["blocks"] == d * want[1] * want[2]
        assert plan["chunks"] * chunk >= s and plan["blocks_per_chunk"] * plan["block_syms"] >= chunk


def _header_tables():
    t = ldpc.decoder_tables()
    return ldpc.edge_tables(t["vidx"], t["vmask"], t["h"].shape[1])


def k5_warp_model(llr: np.ndarray, plan: dict, iters: int = 25, alpha: float = 0.75) -> np.ndarray:
    """BP as K5 runs it (csrc/ldpc_warp.cuh), for a batch of warps in
    float32: each lane's registers (its checks' messages, its variables'
    totals) and the warp's two shared arrays with their padding slots,
    phase by phase, each phase's loads before its publishing. Returns the
    final totals ``[B, N]`` gathered from the lanes."""
    f32 = np.float32
    b = llr.shape[0]
    alpha = f32(alpha)
    vars_, own = plan["vars"], plan["vars"] >= 0
    c2v_sh = np.zeros((b, ldpc_cuda.C2V_FLOATS), f32)
    tot_sh = np.zeros((b, ldpc_cuda.TOT_FLOATS), f32)
    tot_sh[:, ldpc_cuda.INF_TOTAL] = np.inf
    c2v = np.zeros((b, *plan["chk_in"].shape), f32)  # [B, lane, check, slot]
    lane_llr = np.where(own, llr[:, vars_.clip(0)], f32(0))  # [B, lane, variable]
    total = np.zeros_like(lane_llr)

    def variable_phase():
        msgs = c2v_sh[:, plan["var_in"]]  # [B, lane, variable, edge]
        acc = np.zeros_like(total)
        for j in range(msgs.shape[-1]):
            acc = acc + msgs[..., j]
        total[:] = lane_llr + acc
        tot_sh[:, plan["var_out"]] = total

    def check_phase():
        x = tot_sh[:, plan["chk_in"]] - c2v
        sg = np.where(x >= 0, f32(1), f32(-1))
        mg = np.abs(x)
        tot_sgn = np.prod(sg, axis=-1, keepdims=True)
        m1 = np.full(mg.shape[:-1], np.inf, f32)
        m2 = m1.copy()
        for j in range(mg.shape[-1]):
            m2 = np.minimum(m2, np.maximum(m1, mg[..., j]))
            m1 = np.minimum(m1, mg[..., j])
        mag = np.minimum(np.where(mg == m1[..., None], m2[..., None], m1[..., None]), f32(1e30))
        c2v[:] = alpha * (tot_sgn * sg) * mag
        c2v_sh[:, plan["chk_out"]] = c2v

    variable_phase()
    for _ in range(iters):
        check_phase()
        variable_phase()
    out = np.zeros_like(llr)
    out[:, vars_[own]] = total[:, own]
    return out


def test_k5_plan_publishes_each_message_once():
    """Every message a check publishes is read by exactly one variable, at
    the slot the variable reads; padding reads only the zero message and
    the +inf total, and writes only the trash slots; each variable's total
    is published once; each warp-wide publish (one owned check or
    variable, one slot) of a real message falls on distinct banks."""
    cv, ve = _header_tables()
    plan = ldpc_cuda.warp_plan(cv, ve)
    real = plan["chk_out"] < ldpc_cuda.ZERO_MSG
    reads = plan["var_in"][plan["var_in"] < ldpc_cuda.ZERO_MSG]
    edges = list(np.nonzero(cv.ravel() >= 0)[0])
    assert sorted(plan["chk_out"][real]) == sorted(reads) == edges
    assert set(plan["chk_out"][~real]) == {ldpc_cuda.TRASH_MSG}
    assert set(plan["chk_in"][~real]) == {ldpc_cuda.INF_TOTAL}
    assert set(plan["var_in"][plan["var_in"] >= ldpc_cuda.ZERO_MSG]) <= {ldpc_cuda.ZERO_MSG}
    assert sorted(plan["var_out"][plan["vars"] >= 0]) == list(range(ve.shape[0]))
    assert sorted(plan["checks"][plan["checks"] >= 0]) == list(range(cv.shape[0]))
    for k in range(ldpc_cuda.CHECKS_PER_LANE):
        for j in range(ldpc_cuda.MAX_CHECK_DEG):
            s = plan["chk_out"][:, k, j][real[:, k, j]]
            assert len(set(s % 32)) == s.size, (k, j)


def test_k5_warp_model_equals_plain():
    """The warp plan's BP, bit for bit, against ``ldpc_totals_plain`` on
    noisy codewords from -6 to +4 dB (some of which do not converge)."""
    rng = np.random.default_rng(11)
    snr_db = np.repeat(np.arange(-6.0, 6.0, 2.0), 16)[:, None]
    b = snr_db.shape[0]
    headers = rng.integers(0, 256, (b, 4), dtype=np.uint8)
    cw = np.unpackbits(np.stack([ldpc_encode_bytes(h)[:16] for h in headers]), axis=1)
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    llr = ((2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))).astype(np.float32)
    cv, ve = _header_tables()
    got = k5_warp_model(llr, ldpc_cuda.warp_plan(cv, ve))
    want = ldpc.ldpc_totals_plain(torch.from_numpy(llr), torch.from_numpy(cv), torch.from_numpy(ve)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ok = ldpc.finish(torch.from_numpy(got), torch.from_numpy(ldpc.decoder_tables()["h"]))[1]
    assert 0 < ok.float().mean().item() < 1


@pytest.mark.parametrize(
    "m,dmax,n,vdeg",
    [(96, ldpc_cuda.MAX_CHECK_DEG + 1, 128, 3), (96, 5, 128, 4), (97, 5, 128, 3), (96, 5, 129, 3)],
)
def test_k5_wrapper_refuses_tables_beyond_the_kernel(m, dmax, n, vdeg):
    """A check of degree kMaxDeg + 1, a variable of degree 4, one check or
    one variable too many: refused on the CPU route too, and by the plan."""
    llr = torch.zeros(2, n)
    cv = torch.zeros(m, dmax, dtype=torch.int32)
    ve = torch.zeros(n, vdeg, dtype=torch.int32)
    with pytest.raises(ValueError, match="ldpc kernel"):
        ldpc_cuda.ldpc_totals(llr, cv, ve)
    with pytest.raises(ValueError, match="ldpc kernel"):
        ldpc_cuda.warp_plan(cv.numpy(), ve.numpy())


def test_k5_plan_limits_are_the_kernels():
    """The plan's constants are the kernel's compile-time constants."""
    src = (Path(ldpc_cuda.__file__).parents[1] / "csrc" / "ldpc_warp.cuh").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        consts[name] = eval(expr, {}, dict(consts))
    python = {
        "kWarp": "WARP", "kVarsPerLane": "VARS_PER_LANE", "kChecksPerLane": "CHECKS_PER_LANE",
        "kVarDeg": "VAR_DEG", "kMaxDeg": "MAX_CHECK_DEG", "kZeroMsg": "ZERO_MSG",
        "kTrashMsg": "TRASH_MSG", "kC2vFloats": "C2V_FLOATS", "kInfTotal": "INF_TOTAL",
        "kTrashTotal": "TRASH_TOTAL", "kTotFloats": "TOT_FLOATS",
    }
    assert sorted(consts) == sorted(python)
    for name, attr in python.items():
        assert consts[name] == getattr(ldpc_cuda, attr), name


def k2_model(x: np.ndarray, base: int, starts: np.ndarray, r: int, plan: dict) -> dict:
    """K2 as its thread plan runs it (csrc/fetch.cu) on the complex64 bank
    ``x`` ``[T]``, whose first sample lies ``base`` samples (0 or 1) past a
    16-byte boundary: each pass of the grid-stride loop over the items of
    the flat output, each item's load branch (in one row: two float4 where
    its run starts 16-byte aligned, else float2 sample by sample; across a
    row's end: float2 sample by sample from each row's window) and store
    branch (one float4 a plane, the output's last item sample by sample
    when it is short). Every load is checked to lie inside its window and
    every float4 to be 16-byte aligned. Returns the planes, the writes per
    output element and the branch counts."""
    f = x.view(np.float32)  # I0 Q0 I1 Q1 ..., as the kernel reads it
    t, run, total = x.size, plan["run"], plan["elements"]
    hi = t - r
    outr = np.zeros(total, np.float32)
    outi = np.zeros(total, np.float32)
    writes = np.zeros(total, np.int64)
    count = dict.fromkeys(("float4 loads", "float2 loads", "crossing items",
                           "float4 stores", "scalar stores"), 0)
    stride = plan["blocks"] * plan["threads"]
    k = np.arange(run)
    for first in range(0, plan["items"], stride):
        item = first + np.arange(stride)
        item = item[item < plan["items"]]
        e0 = item * run
        d0, c0 = e0 // r, e0 % r
        one_row = c0 + run <= r
        src = np.clip(starts[d0], 0, hi) + c0
        vec = one_row & ((base + src) % 2 == 0)
        re = np.zeros((item.size, run), np.float32)
        im = np.zeros((item.size, run), np.float32)
        if vec.any():
            assert ((8 * (base + src[vec])) % 16 == 0).all()
            v = f[2 * src[vec, None] + np.arange(2 * run)]  # two float4
            re[vec], im[vec] = v[:, 0::2], v[:, 1::2]
        # float2 loads: in one row from src on; across a row's end from
        # each sample's own row
        e = e0[:, None] + k
        live = ~vec[:, None] & (e < total)
        dk = e // r
        sk = np.clip(starts[np.minimum(dk, starts.size - 1)], 0, hi) + e % r
        assert (sk[one_row] == src[one_row, None] + k).all()
        rows_, ks = np.nonzero(live)
        assert (sk[rows_, ks] < np.clip(starts[dk[rows_, ks]], 0, hi) + r).all()
        re[rows_, ks] = f[2 * sk[rows_, ks]]
        im[rows_, ks] = f[2 * sk[rows_, ks] + 1]
        count["float4 loads"] += 2 * int(vec.sum())
        count["float2 loads"] += int(live.sum())
        count["crossing items"] += int((~one_row).sum())
        full = e0 + run <= total
        assert (e0 % run == 0).all()  # every float4 store 16-byte aligned
        count["float4 stores"] += 2 * int(full.sum())
        count["scalar stores"] += 2 * int((e[~full] < total).sum())
        keep = e < total
        outr[e[keep]] = re[keep]
        outi[e[keep]] = im[keep]
        np.add.at(writes, e[keep], 1)
    d = starts.size
    return {"outr": outr.reshape(d, r), "outi": outi.reshape(d, r),
            "writes": writes, "count": count}


@pytest.mark.parametrize("base", [0, 1])
@pytest.mark.parametrize("r", [3, 808, 809, 1569, 24680])
def test_k2_model_equals_plain(r, base):
    """K2's thread plan (``fetch_cuda.fetch_plan``) copies bit for bit what
    the plain version copies, at odd and even starts, 0 and T - R and
    starts past either end; every output element is written exactly once;
    both one-row load branches are taken, items cross a row's end only when
    R % 4 != 0, and every store but a short last item's is a float4."""
    rng = np.random.default_rng(r + base)
    t, d = 2 * r + 1001, 9
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    starts = np.concatenate([[0, 1, t - r, t - r - 1, -3, t + 7],
                             2 * rng.integers(0, (t - r) // 2, d - 6) + (np.arange(d - 6) % 2)])
    plan = fetch_cuda.fetch_plan(r, d)
    assert plan["blocks"] * plan["threads"] >= plan["items"] == -(-d * r // fetch_cuda.RUN)
    got = k2_model(x, base, starts, r, plan)
    want = fetch_cuda.fetch_regions_plain(torch.from_numpy(x), torch.from_numpy(starts), r)
    for g, w in zip((got["outr"], got["outi"]), want):
        np.testing.assert_array_equal(g.view(np.int32), w.numpy().view(np.int32))
    assert (got["writes"] == 1).all()
    c = got["count"]
    assert (c["float4 loads"] > 0) == (r >= fetch_cuda.RUN) and c["float2 loads"] > 0
    assert (c["crossing items"] > 0) == (r % fetch_cuda.RUN != 0)
    assert c["float4 stores"] == 2 * (d * r // fetch_cuda.RUN)
    assert c["scalar stores"] == 2 * plan["tail"]


@pytest.mark.parametrize("r", [3, 297, 1569])
def test_k2b_model_equals_plain(r):
    """K2b's plan (``fetch_cuda.rows_plan``): one thread an element of the
    flat ``[D, R]`` output, row ``e // R``; bit for bit against the plain
    version, every element written once."""
    rng = np.random.default_rng(r)
    t, d = 3 * r + 4099, 1536
    x = rng.standard_normal(t).astype(np.float32)
    starts = np.concatenate([[0, t - r, -1, t], rng.integers(0, t - r + 1, d - 4)])
    plan = fetch_cuda.rows_plan(r, d)
    e = np.arange(plan["blocks"] * plan["threads"])
    e = e[e < plan["items"]]
    row = e // r
    out = np.zeros(d * r, np.float32)
    out[e] = x[np.clip(starts[row], 0, t - r) + e - row * r]
    assert np.array_equal(np.bincount(e, minlength=d * r), np.ones(d * r, np.int64))
    want = fetch_cuda.fetch_rows_plain(torch.from_numpy(x), torch.from_numpy(starts), r)
    np.testing.assert_array_equal(out.reshape(d, r), want.numpy())


def test_k2_plan_constants_are_the_kernels():
    """The plans' block size and run length are csrc/fetch.cu's."""
    src = (Path(fetch_cuda.__file__).parents[1] / "csrc" / "fetch.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert consts == {"kThreads": str(fetch_cuda.THREADS), "kRun": str(fetch_cuda.RUN)}


# ------------------------------------------------- K1's bf16 form (wgmma)


def _pack(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Two float32 arrays rounded to bf16 into one word each (cvt.rn
    .bf16x2.f32: ``lo`` in the low half)."""
    bits = torch.from_numpy(np.stack([lo, hi])).to(torch.bfloat16).view(torch.int16).numpy()
    bits = bits.view(np.uint16).astype(np.uint32)
    return bits[0] | (bits[1] << 16)


def register_a_model(y: np.ndarray, table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """csrc/correlate_bf16.cu's register-A step for one frame: ``y`` the
    forward spectrum ``[16, N2]`` (complex64, ``[k1, k2]``) as the
    accumulator fragments hold it (``fragment_index``), ``table`` one bin's
    replica fragments (``replica_table_bf16(...)[b]``, ``[N2/8, 2, 32,
    4]``). For k-step ks and lane ``4 g + q`` the words ``2 t``, ``2 t +
    1`` (t = 0, 1) pack n-tile ``2 ks + t``'s values (0, 1) and (2, 3) of
    ``P = Y * R_b`` rounded to bf16; returns the words read back through
    the m16k16 A fragment layout (word 0 row g, columns 2 q, + 1; word 1
    row g + 8; words 2, 3 the same at columns 2 q + 8, + 9) as float32
    ``[16, N2]`` planes (re, im)."""
    n2 = y.shape[1]
    idx = fragment_index(16 * n2)
    frag = y.T.ravel()[idx]  # the spectrum by k1 + 16 k2, at the fragments
    yr, yi = frag.real.astype(np.float32), frag.imag.astype(np.float32)
    rr, ri = table[:, 0], table[:, 1]
    p_r, p_i = yr * rr - yi * ri, yr * ri + yi * rr  # [N2/8, 32, 4]
    out = np.zeros((2, 16, n2), np.float32)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    for part, v in enumerate((p_r, p_i)):
        for ks in range(n2 // 16):
            words = []
            for t in range(2):
                nt = 2 * ks + t
                words += [_pack(v[nt, :, 0], v[nt, :, 1]), _pack(v[nt, :, 2], v[nt, :, 3])]
            for w, (row, col) in enumerate([(g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8), (g + 8, 2 * q + 8)]):
                for half in range(2):
                    vals = ((words[w] >> (16 * half)) & 0xFFFF) << 16
                    out[part, row, 16 * ks + col + half] = vals.astype(np.uint32).view(np.float32)
    return out[0], out[1]


@pytest.mark.parametrize("n", WGMMA_FFT_SIZES)
def test_k1_bf16_register_a_model(n):
    """P computed on Y's accumulator fragments and packed into A fragments
    is ``bf16(Y * R_b)`` in the ``[16, N2]`` layout, every word once."""
    n2 = n // 16
    rng = np.random.default_rng(n)
    y = (rng.standard_normal((16, n2)) + 1j * rng.standard_normal((16, n2))).astype(np.complex64)
    rf = rng.standard_normal((2, 3, n)).astype(np.float32)
    table = replica_table_bf16(torch.from_numpy(rf[0]), torch.from_numpy(rf[1]), n).numpy()
    for b in range(3):
        got_r, got_i = register_a_model(y, table[b])
        # R_b[k1, k2] = rf[b, k1 + 16 k2]; P in float32 as the plain version
        rr, ri = (rf[i, b].reshape(n2, 16).T for i in range(2))
        for got, p in ((got_r, y.real * rr - y.imag * ri), (got_i, y.real * ri + y.imag * rr)):
            want = torch.from_numpy(np.ascontiguousarray(p)).to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(got, want)


# the H100's SMs at one resident block each (the kernel's shared memory)
H100_RESIDENT = 132


@pytest.mark.parametrize("fpad", [1, 3, 5, 4 * 9 + 3, 8 * H100_RESIDENT - 1, 8 * H100_RESIDENT + 3,
                                  4 * 2 * 8 * H100_RESIDENT + 7, 20480])
def test_k1_bf16_persistent_walk_covers_every_frame(fpad):
    """Every frame is owned by exactly one warp at one step of the walk, no
    more blocks launch than are resident, and every block but a ragged last
    wave's has work."""
    walk = persistent_walk(fpad, H100_RESIDENT)
    blocks, groups, steps, frames = walk.shape
    assert (groups, frames) == (WG_GROUPS, WG_FRAMES) and blocks <= H100_RESIDENT
    owned = walk[walk >= 0]
    np.testing.assert_array_equal(np.sort(owned), np.arange(fpad))
    assert (walk[:, 0, 0, 0] >= 0).all()  # no block launched without a frame
    if fpad > WG_FRAMES * WG_GROUPS * H100_RESIDENT:
        assert blocks == H100_RESIDENT and steps > 1


def test_k1_bf16_walk_constants_are_the_kernels():
    """The walk's warpgroups a block and frames a warpgroup, and the size it
    serves, are csrc/correlate_bf16.cu's."""
    src = (Path(fetch_cuda.__file__).parents[1] / "csrc" / "correlate_bf16.cu").read_text()
    wg = src[src.index("namespace wg {"):src.index("}  // namespace wg")]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", wg))
    assert consts["kGroups"] == str(WG_GROUPS) and consts["kFrames"] == str(WG_FRAMES)
    assert [16 * int(consts["kN2"])] == list(WGMMA_FFT_SIZES)
    assert "const int groups = (fpad + kFrames - 1) / kFrames;" in src
    assert "grp = blockIdx.x * kGroups + (warp >> 2); grp < groups; grp += gridDim.x * kGroups" in src


# ------------------------------------- K1's bf16 form at 4096, 8192 (streamed)


def _stream_source() -> str:
    return (Path(fetch_cuda.__file__).parents[1] / "csrc" / "correlate_bf16.cu").read_text()


# the H100's SMs at the streaming kernel's resident blocks
H100_STREAM_RESIDENT = {4096: 2 * 132, 8192: 132}


@pytest.mark.parametrize("n", STREAM_FFT_SIZES)
@pytest.mark.parametrize("fpad,nb", [(1, 9), (3, 1), (7, 5), (37, 9), (9, 4), (4 * 264 + 5, 9), (5120, 9)])
def test_k1_stream_plan_covers_every_frame_and_table_block(n, fpad, nb):
    """Every frame's forward pass once and every (frame, bin) once in the
    walk, no more blocks than are resident and none without a group; each
    pass takes the table blocks once and in order; each product finds its
    own table block loaded (the kernel's next-block rule gives the next
    product's), waits for its stages' phase of the parity its count gives,
    and the last product of a block starts no copy."""
    resident = H100_STREAM_RESIDENT[n]
    plan = stream_plan(fpad, resident, nb, n)
    blocks_tb = n // 16 // 2 // STREAM_COLS
    assert 0 < len(plan) <= resident and len(plan) == min(resident, -(-fpad // STREAM_FRAMES))
    forward, pairs = [], []
    for block in plan:
        passes, products, loads = block["passes"], block["products"], block["loads"]
        assert passes[0][0] == "forward"
        for kind, frames, bins in passes:
            if kind == "forward":
                forward += frames
                assert len(frames) <= STREAM_FRAMES
            else:
                assert len(frames) == 1 and 0 < len(bins) <= 4
                pairs += [(frames[0], b) for b in bins]
        count = len(passes) * blocks_tb
        np.testing.assert_array_equal(products[:, 0], np.repeat(np.arange(len(passes)), blocks_tb))
        np.testing.assert_array_equal(products[:, 1], np.tile(np.arange(blocks_tb), len(passes)))
        # the stages hold what the last load brought: product p's own block
        assert len(loads) == count
        np.testing.assert_array_equal(loads, products[:, 1])
        # phases: product p is the (p + 1)-th completion of each stage
        np.testing.assert_array_equal(products[:, 2], np.arange(count) & 1)
    np.testing.assert_array_equal(np.sort(forward), np.arange(fpad))
    assert sorted(pairs) == [(f, b) for f in range(fpad) for b in range(nb)]


def test_k1_stream_constants_are_the_kernels():
    """The plan's chunk rows, columns and frames a group are
    csrc/correlate_bf16.cu's, and the kernel walks, loads its table blocks
    and waits on its stages as ``stream_plan`` models them."""
    src = _stream_source()
    ns = src[src.index("namespace st {"):src.index("}  // namespace st")]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", ns))
    assert int(consts["kCols"]) == STREAM_COLS and int(consts["kChunkK"]) == STREAM_CHUNK_K
    assert int(consts["kFrames"]) == STREAM_FRAMES
    for line in (
        "for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {",
        "const int nbg = (nb + 3) / 4;",
        "load_block<N2>(smem_u32(stages), full, table, 0, threadIdx.x == 0);",
        "const uint32_t parity = i & 1;",
        "mbar_wait(&full[kc], parity);",
        "stream_product<N2, true>(acc, a_area, stages_u32, full, i, table, (tb + 1) % S::kBlocks,",
        "stream_product<N2, false>(acc, a_area, stages_u32, full, i, table, (tb + 1) % S::kBlocks,",
        "const bool more = !(last_group && fr == live - 1 && bg == nbg - 1 && tb == S::kBlocks - 1);",
        "const bool last_group = grp + static_cast<int>(gridDim.x) >= groups;",
        "for (int fr = 0; fr < live; ++fr) {",
        "for (int tb = 0; tb < S::kBlocks; ++tb) {",
    ):
        assert line in src, line


# ------------------------------------------------- the payload CRC kernel


def _shift(mat: np.ndarray, r: np.ndarray) -> np.ndarray:
    """csrc/crc.cu's ``shift``: each word of ``r`` through the 32 columns."""
    y = np.zeros_like(r)
    for i in range(32):
        y ^= np.where((r >> np.uint64(i)) & np.uint64(1) == 1, mat[i], np.uint64(0))
    return y


def crc_kernel_walk(msg: np.ndarray, max_len: int) -> int:
    """The CRC that csrc/crc.cu computes for a row whose first ``n`` bytes
    are ``msg``, along its walk: the bytes right-aligned in a frame of
    whole tiles, the tiles from the one that holds byte 0, each thread's
    span folded from a zero register, the warp tree (shifts of 16 << l
    bytes), warp 0's tree over the warps (512 << l), the running register
    shifted a tile; then init_lut[n] and the final XOR."""
    t = crc.payload_crc_tables().astype(np.uint64)
    levels, threads, span, tile_len = crc.SHIFT_LEVELS, crc.THREADS, crc.SPAN, crc.TILE
    byte_table, shifts = t[:256], t[256:].reshape(levels, 32)
    engine = crc.crc32_tables(max_len)
    init, final = engine["init_lut"].astype(np.uint64), np.uint64(engine["final_xor"])
    n = msg.size
    tiles = -(-max_len // tile_len)
    lead = tiles * tile_len - n
    frame = np.zeros(tiles * tile_len, np.uint64)
    frame[lead:] = msg
    log_span = span.bit_length() - 1
    acc = np.zeros(1, np.uint64)
    for k in range(lead // tile_len, tiles):
        spans = frame[k * tile_len : (k + 1) * tile_len].reshape(threads, span)
        r = np.zeros(threads, np.uint64)
        for m in range(span):
            r = byte_table[(r ^ spans[:, m]) & np.uint64(0xFF)] ^ (r >> np.uint64(8))
        r = r.reshape(threads // 32, 32)
        for lv in range(5):
            o = 1 << lv
            left = np.arange(0, 32, 2 * o)
            r[:, left] = _shift(shifts[log_span + lv], r[:, left]) ^ r[:, left + o]
        w = r[:, 0].copy()
        for lv in range(3):
            o = 1 << lv
            left = np.arange(0, w.size, 2 * o)
            w[left] = _shift(shifts[log_span + 5 + lv], w[left]) ^ w[left + o]
        acc = _shift(shifts[levels - 1], acc) ^ w[0]
    return int(acc[0] ^ init[n] ^ final)


@pytest.mark.parametrize("max_len", [1536, 4096, 65535])
def test_crc_kernel_walk_equals_oracle(max_len):
    """The kernel's walk gives the CRC-32 of every row length that meets
    its edges: none, one byte, a span and a byte either side, a warp's
    512, a tile's 4096 and past it, up to ``max_len``."""
    rng = np.random.default_rng(max_len)
    lengths = {0, 1, 15, 16, 17, 511, 512, 513, max_len - 1, max_len, int(rng.integers(2, max_len))}
    lengths |= {n for n in (4095, 4096, 4097, 8193) if n <= max_len}
    for n in sorted(lengths):
        msg = rng.integers(0, 256, n, dtype=np.uint8)
        assert crc_kernel_walk(msg, max_len) == crc.crc32_ref(msg), n


def test_crc_shift_matrices_clock_zero_bytes():
    """Z^(2^m)(r) of the tables is r clocked through 2^m zero bytes one at
    a time through the byte table, for every level the kernel uses."""
    table = crc.CrcRef().table
    mats = crc.zero_shift_matrices().astype(np.uint64)
    assert mats.shape == (crc.SHIFT_LEVELS, 32) and 1 << (crc.SHIFT_LEVELS - 1) == crc.TILE
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 2**32, 3, dtype=np.uint64)
    for m in range(crc.SHIFT_LEVELS):
        for r0 in regs:
            r = int(r0)
            for _ in range(1 << m):
                r = int(table[r & 0xFF]) ^ (r >> 8)
            assert int(_shift(mats[m], np.array([r0], np.uint64))[0]) == r, m


def test_crc_kernel_constants_are_the_wrappers():
    """csrc/crc.cu's block, span, tile and shift levels, and its tables'
    size, are ``ops/crc.py``'s."""
    src = (Path(crc.__file__).parents[1] / "csrc" / "crc.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert consts == {"kThreads": str(crc.THREADS), "kSpan": str(crc.SPAN), "kLogSpan": "4",
                      "kShiftLevels": str(crc.SHIFT_LEVELS), "kShifts": "256"}
    assert "constexpr int kTile = kThreads * kSpan;" in src
    assert "constexpr int kTables = kShifts + 32 * kShiftLevels;" in src
    assert crc.SPAN == 1 << 4 and crc.TILE == crc.THREADS * crc.SPAN
    t = crc.payload_crc_tables()
    assert t.dtype == np.uint32 and t.size == 256 + 32 * crc.SHIFT_LEVELS
