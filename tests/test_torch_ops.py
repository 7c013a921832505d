"""Port ops vs the JAX package: packing, keystream, CRC-32, LDPC decoding,
the Costas loop, the matched filter and the region fetch.

The same numpy inputs (made from a seed) go through the JAX function and
its PyTorch counterpart. Pallas kernels run as the JAX package's own tests
run them on the CPU (``interpret=True``); on CPU tensors the port's kernel
wrappers run their plain versions, which are what is compared here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gr4_packet_modem_tpu.ops import costas as jcostas  # noqa: E402
from gr4_packet_modem_tpu.ops import crc as jcrc  # noqa: E402
from gr4_packet_modem_tpu.ops import ldpc as jldpc  # noqa: E402
from gr4_packet_modem_tpu.ops.costas_pallas import costas_track_pallas  # noqa: E402
from gr4_packet_modem_tpu.ops.fetch_pallas import fetch_regions as j_fetch  # noqa: E402
from gr4_packet_modem_tpu.ops.ldpc_pallas import ldpc_totals_pallas  # noqa: E402
from gr4_packet_modem_tpu.ops.matched_pallas import (  # noqa: E402
    matched_filter_pallas,
    matched_filter_reference,
)
from gr4_packet_modem_tpu.ops.packing import pack_bits as j_pack_bits  # noqa: E402
from gr4_packet_modem_tpu.ops.scramble import keystream as j_keystream  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import ldpc  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas import costas_run, costas_segments  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas_cuda import (  # noqa: E402
    costas_track, costas_track_plain, skipped_rows,
)
from gr4_packet_modem_tpu_torch.ops.crc import crc32_compute, crc32_tables  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_regions  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.packing import pack_bits  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.scramble import keystream  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import tables_from_numpy  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402

LENGTHS = [1, 17, 128, 1536]


@pytest.mark.parametrize("n", LENGTHS)
def test_pack_bits_exact(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (5, 8 * n), dtype=np.uint8)
    want = np.asarray(j_pack_bits(jnp.asarray(bits), 8))
    got = pack_bits(torch.from_numpy(bits), 8).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n", LENGTHS)
def test_keystream_exact(n):
    want = np.asarray(j_keystream(n))
    np.testing.assert_array_equal(keystream(n, "cpu").numpy(), want)


@pytest.mark.parametrize("max_len", LENGTHS)
def test_crc32_exact(max_len):
    """CRC words equal the JAX CrcEngine and the table-driven host oracle
    exactly, for ragged lengths 0..max_len with garbage past each length."""
    rng = np.random.default_rng(max_len)
    b = 9
    data = rng.integers(0, 256, (b, max_len), dtype=np.uint8)
    lengths = np.concatenate(
        [[0, 1, max_len], rng.integers(0, max_len + 1, b - 3)]
    ).astype(np.int32)
    eng = jcrc.CrcEngine(max_len)
    want = np.asarray(eng.compute(jnp.asarray(data), jnp.asarray(lengths)))
    t = tables_from_numpy(crc32_tables(max_len))
    got = crc32_compute(
        torch.from_numpy(data), torch.from_numpy(lengths).long(),
        t["g_packed"], t["init_lut"], t["final_xor"],
    ).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    oracle = [jcrc.crc32_ref(data[i, : lengths[i]]) for i in range(b)]
    np.testing.assert_array_equal(got, np.asarray(oracle, np.int64))


def _noisy_codewords(snr_db, b=96):
    """The inputs of tests/test_ldpc_pallas.py."""
    rng = np.random.default_rng(int(10 + snr_db))
    bits = rng.integers(0, 2, (b, 32), dtype=np.uint8)
    cw = np.asarray(jldpc.encode_header(jnp.asarray(bits)))[:, :128]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    bpsk = 1.0 - 2.0 * cw.astype(np.float32)
    return ((2.0 / sigma**2) * (
        bpsk + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    )).astype(np.float32)


def _port_tables():
    t = ldpc.decoder_tables()
    chk_vars, var_edges = ldpc.edge_tables(t["vidx"], t["vmask"], t["h"].shape[1])
    return torch.from_numpy(chk_vars), torch.from_numpy(var_edges), torch.from_numpy(t["h"])


@pytest.mark.parametrize("snr_db", [-6.0, -2.0, 2.0])
def test_ldpc_plain_matches_scan_and_pallas(snr_db):
    """Decoded bits and parity flags equal the JAX scan decoder's and the
    Pallas kernel's exactly, including codewords that do not converge."""
    llr = _noisy_codewords(snr_db)
    ref_bits, ref_ok = jldpc.HeaderLdpcDecoder(25, use_pallas=False).decode(
        jnp.asarray(llr)
    )
    pal_total = np.asarray(ldpc_totals_pallas(jnp.asarray(llr), 25, 0.75, interpret=True))
    chk_vars, var_edges, h = _port_tables()
    total = ldpc_totals(torch.from_numpy(llr), chk_vars, var_edges, 25, 0.75)
    bits, ok = ldpc.finish(total, h)
    if snr_db <= -5.0:
        assert 0.0 < np.asarray(ref_ok).mean() < 1.0  # failure regime exercised
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(
        (total.numpy() < 0), (pal_total < 0)
    )


def test_ldpc_edge_tables_cover_parity_check():
    chk_vars, var_edges, h = _port_tables()
    m, dmax = chk_vars.shape
    rebuilt = np.zeros(h.shape, np.uint8)
    for v, edges in enumerate(var_edges.numpy()):
        for e in edges[edges >= 0]:
            assert chk_vars.numpy().reshape(-1)[e] == v
            rebuilt[e // dmax, v] = 1
    np.testing.assert_array_equal(rebuilt, h.numpy().astype(np.uint8))


@pytest.mark.parametrize(
    "b,s,offset",
    [(32, 192, 0), (32, 512, 192), (5, 300, 192), (7, 64, 30)],
)
def test_costas_matches_scan_and_pallas(b, s, offset):
    """Port costas_run (the plain version of K4) vs the JAX scan and the
    Pallas kernel, at the atol 1e-5 of tests/test_costas_pallas.py."""
    rng = np.random.default_rng(b + s)
    syms = (rng.standard_normal((b, s)) + 1j * rng.standard_normal((b, s))).astype(np.complex64)
    ph0 = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    fr0 = rng.uniform(-0.01, 0.01, b).astype(np.float32)
    cid, k1, k2 = jcostas.costas_segments(s, offset=offset)
    ref, ph_ref, fr_ref = jcostas.costas_run(
        jnp.asarray(syms), jnp.asarray(ph0), jnp.asarray(fr0), cid, k1, k2
    )
    pal, ph_pal, _ = costas_track_pallas(
        jnp.asarray(syms), jnp.asarray(ph0), jnp.asarray(fr0), offset=offset,
        interpret=True,
    )
    out, ph, fr = costas_track(
        torch.from_numpy(syms), torch.from_numpy(ph0), torch.from_numpy(fr0),
        offset=offset,
    )
    for want, want_ph in ((ref, ph_ref), (pal, ph_pal)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(ph.numpy(), np.asarray(want_ph), atol=1e-5)
    np.testing.assert_allclose(fr.numpy(), np.asarray(fr_ref), atol=1e-6)


def _masked_costas_inputs(b, s, seed):
    """Noisy symbols and loop state for ``b`` rows, every third row
    inactive, and inactive row 1 scaled by 1e9 as a slot with no detection
    comes to K4."""
    rng = np.random.default_rng(seed)
    syms = (rng.standard_normal((b, s)) + 1j * rng.standard_normal((b, s))).astype(np.complex64)
    syms[1] *= np.float32(1e9)
    ph0 = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    fr0 = rng.uniform(-0.01, 0.01, b).astype(np.float32)
    active = np.arange(b) % 3 != 1
    return (torch.from_numpy(syms), torch.from_numpy(ph0), torch.from_numpy(fr0),
            torch.from_numpy(active))


@pytest.mark.parametrize("b,s,offset", [(7, 600, 192), (32, 192, 0)])
def test_costas_track_plain_masked_rows(b, s, offset):
    """With ``active``, the active rows are bit-identical to the unmasked
    call and the inactive ones (the 1e9-scaled one too) are zeros with
    their state as it came; ``active=None`` is the recursion as it was."""
    sym, ph0, fr0, active = _masked_costas_inputs(b, s, seed=b + s)
    want = costas_run(sym, ph0, fr0, *costas_segments(s, "cpu", offset=offset))
    full = costas_track_plain(sym, ph0, fr0, offset)
    for g, w in zip(full, want):
        assert torch.equal(g, w)
    # the 1e9-scaled row runs away unmasked: its phase leaves [-pi, pi)
    assert not bool(full[1][1].abs() <= np.pi)
    out, ph, fr = costas_track_plain(sym, ph0, fr0, offset, active)
    assert out.is_contiguous() and out.shape == (b, s)
    assert torch.equal(out[active], full[0][active])
    assert torch.equal(ph[active], full[1][active]) and torch.equal(fr[active], full[2][active])
    assert torch.equal(out[~active], torch.zeros_like(out[~active]))
    assert torch.equal(ph[~active], ph0[~active]) and torch.equal(fr[~active], fr0[~active])


def test_costas_track_counts_rows_and_skips():
    """``costas_track`` on CPU tensors: the plain route's outputs, the rows
    handed to it in ``rx.costas.rows`` and the inactive ones in
    ``skipped_rows``, with and without a mask; a mask of another dtype or
    shape raises."""
    sym, ph0, fr0, active = _masked_costas_inputs(10, 300, seed=5)
    rows0, skipped0 = trace.counters().get("rx.costas.rows", 0), skipped_rows("cpu")
    got = costas_track(sym, ph0, fr0, offset=192, active=active)
    for g, w in zip(got, costas_track_plain(sym, ph0, fr0, 192, active)):
        assert torch.equal(g, w)
    costas_track(sym, ph0, fr0, offset=192)
    assert trace.counters()["rx.costas.rows"] - rows0 == 20
    assert skipped_rows("cpu") - skipped0 == int((~active).sum()) == 3
    for bad in (active.to(torch.uint8), active[:-1]):
        with pytest.raises(ValueError, match="active"):
            costas_track(sym, ph0, fr0, active=bad)


def test_costas_segments_match():
    for offset in (0, 150):
        want = jcostas.costas_segments(300, offset=offset)
        got = costas_segments(300, "cpu", offset=offset)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_costas_run_bpsk_discriminant():
    """The general recursion's BPSK branch (constellation id 1)."""
    rng = np.random.default_rng(3)
    b, s = 6, 40
    syms = (rng.standard_normal((b, s)) + 1j * rng.standard_normal((b, s))).astype(np.complex64)
    ph0 = rng.uniform(-1, 1, b).astype(np.float32)
    fr0 = np.zeros(b, np.float32)
    cid = np.ones(s, np.int32)
    k1 = np.full(s, 0.03, np.float32)
    k2 = np.full(s, 0.001, np.float32)
    ref = jcostas.costas_run(
        jnp.asarray(syms), jnp.asarray(ph0), jnp.asarray(fr0),
        jnp.asarray(cid), jnp.asarray(k1), jnp.asarray(k2),
    )
    got = costas_run(
        torch.from_numpy(syms), torch.from_numpy(ph0), torch.from_numpy(fr0),
        torch.from_numpy(cid), torch.from_numpy(k1), torch.from_numpy(k2),
    )
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize(
    "d,k,sps,s,short",
    [(5, 297, 4, 50, 0), (12, 44, 4, 300, 0), (130, 33, 4, 260, 0), (7, 44, 4, 192, 10)],
)
def test_matched_filter_matches_pallas_and_reference(d, k, sps, s, short):
    """Plain version of K3 vs matched_filter_pallas (interpret) and the
    sequential oracle, at rtol 1e-5 / atol 1e-4 (tests/test_matched_pallas.py).
    ``short`` cuts the region so the tail reads zeros."""
    rng = np.random.default_rng(d + k)
    r = sps * (s - 1) + k - short
    zr = rng.standard_normal((d, r)).astype(np.float32)
    zi = rng.standard_normal((d, r)).astype(np.float32)
    taps = rng.standard_normal((d, k)).astype(np.float32)
    outr, outi = matched_filter(
        torch.from_numpy(zr), torch.from_numpy(zi), torch.from_numpy(taps), sps, s
    )
    refr, refi = matched_filter_reference(zr, zi, taps, sps, s)
    palr, pali = matched_filter_pallas(
        jnp.asarray(zr), jnp.asarray(zi), jnp.asarray(taps), sps, s, interpret=True
    )
    for wr, wi in ((refr, refi), (np.asarray(palr), np.asarray(pali))):
        np.testing.assert_allclose(outr.numpy(), wr, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(outi.numpy(), wi, rtol=1e-5, atol=1e-4)


def _fetch_against_jax(x: np.ndarray, starts: np.ndarray, r: int) -> None:
    """The port's K2 on the complex64 bank ``x`` against the JAX
    fetch_regions (interpret) on its I and Q planes: bit-exact. The JAX
    function takes starts its caller clipped to ``[0, T - R]``; the port
    clamps them itself."""
    clipped = np.clip(starts, 0, x.size - r).astype(np.int32)
    wr, wi = j_fetch(
        jnp.asarray(x.real), jnp.asarray(x.imag), jnp.asarray(clipped), r, interpret=True,
    )
    gr, gi = fetch_regions(torch.from_numpy(x), torch.from_numpy(starts).long(), r)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("r", [1569, 808, 809, 24680])
def test_fetch_exact_odd_starts(r):
    """Plain version of K2 vs fetch_regions (interpret): bit-exact at odd
    starts, including a window ending at the last sample."""
    rng = np.random.default_rng(r)
    t, d = 3 * r + 4099, 6
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    starts = np.concatenate([[1, t - r], 2 * rng.integers(0, (t - r) // 2, d - 2) + 1])
    _fetch_against_jax(x, starts, r)


@pytest.mark.parametrize("r", [1569, 808, 809, 24680])
def test_fetch_exact_even_starts(r):
    """The same at even starts, start 0 and a window ending at the last
    sample, and beside them starts past either end, which the port
    clamps."""
    rng = np.random.default_rng(r + 1)
    t, d = 3 * r + 4100, 7
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    starts = np.concatenate([[0, t - r, -5, t], 2 * rng.integers(0, (t - r) // 2, d - 4)])
    _fetch_against_jax(x, starts, r)
