"""K1: the fused correlator on the card (``csrc/correlate.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/acquire_pallas.py::
fused_best_power`` with the same public layout: the overlap-save frames come
as two ``[FPAD, S]`` views per I/Q plane (the frame bodies ``a`` and the
one-stride-shifted view ``b`` whose first ``N - S`` samples are each frame's
lookahead), the replica spectra as ``[nb, N]`` planes in natural order, and
the result is ``(best_pow f32 [FPAD, N], best_bin int32 [FPAD, N])`` with
``best_pow = max_b |ifft(fft(frame) * R_b)|^2`` and ``best_bin`` its first
argmax. Only ``[:frames, :S]`` is the linear correlation; the rest is
circular wrap and zero-extended frames. One CUDA kernel serves both of the
TPU kernel's layouts (narrow and wide give the same planes).

:func:`fused_best_power` launches the kernel for CUDA tensors and runs
:func:`fused_best_power_plain` (the same reduction written with
``torch.fft``) for CPU tensors.

With ``bf16=True`` it computes the TPU kernel's bf16 form instead
(``_make_kernel(..., bf16=True)``): both DFTs factored as N = 16 x N2, the
bulk products over N2 with bf16 inputs and float32 accumulation, the
radix-16 DFTs in float32 with their tables rounded to bf16. CUDA tensors
launch ``csrc/correlate_bf16.cu`` (bf16 tensor cores through wgmma in
persistent blocks: at N=2048 from one table resident in shared memory, at
4096 and 8192 from a table streamed into shared memory a block at a time;
:func:`persistent_walk` and :func:`stream_plan` model the two walks,
:func:`bf16_kernel_resources` reads what the card gives each); CPU tensors
run :func:`fused_best_power_bf16_plain`, the same factorization in torch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils.device import kernel_route
from . import _build

__all__ = [
    "fused_best_power", "fused_best_power_plain", "replica_table", "KERNEL_FFT_SIZES",
    "dft_tables", "bf16_tables", "bf16_bin_powers", "fused_best_power_bf16_plain",
    "fragment_index", "replica_table_bf16", "persistent_walk", "bf16_kernel_resources",
    "WGMMA_FFT_SIZES", "STREAM_FFT_SIZES", "stream_kprime", "stream_plan",
]

# the kernel's transform sizes: 16 points a thread, N / 16 threads a frame
# (at most 512), two exchange buffers and the spectrum (3N points) in shared
# memory
KERNEL_FFT_SIZES = (2048, 4096, 8192)
# the kernel keeps each sample's best bin in one byte
MAX_BINS = 256


def _check(ar, ai, br, bi, rfr, rfi, fft_size: int, block_frames: int) -> None:
    """The TPU function's checks (acquire_pallas.py:342-347) and the
    layout's."""
    planes = (ar, ai, br, bi)
    for t in (*planes, rfr, rfi):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"inputs must be float32 matrices, got {t.dtype} {tuple(t.shape)}")
    if any(t.shape != ar.shape for t in planes) or rfr.shape != rfi.shape:
        raise ValueError("the four frame views must be alike, and the two replica planes")
    fpad, s = ar.shape
    n = fft_size
    if rfr.shape[1] != n:
        raise ValueError(f"replica spectra are [nb, {rfr.shape[1]}], fft_size is {n}")
    if fpad % block_frames:
        raise ValueError(f"FPAD={fpad} must be a multiple of {block_frames}")
    if not 0 < n - s <= s:
        raise ValueError(f"stride {s} must satisfy N-S <= S (N={n})")


def fused_best_power_plain(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames assembled from the views, one forward FFT per frame, one
    inverse FFT per (frame, bin), power, max and first argmax over bins."""
    s = ar.shape[1]
    frames = torch.complex(
        torch.cat([ar, br[:, : fft_size - s]], dim=1),
        torch.cat([ai, bi[:, : fft_size - s]], dim=1),
    )
    spec = torch.fft.fft(frames, dim=-1)
    corr = torch.fft.ifft(spec[:, None, :] * torch.complex(rfr, rfi)[None], dim=-1)
    power = corr.real**2 + corr.imag**2  # [FPAD, nb, N]
    best_pow, best_bin = power.max(dim=1)
    return best_pow, best_bin.to(torch.int32)


# ----------------------------------------------------------- the bf16 form

_N1 = 16  # the small radix of the four-step factorization, N = 16 x N2


@lru_cache(maxsize=8)
def dft_tables(n: int) -> dict[str, np.ndarray]:
    """The TPU kernel's four-step DFT factors, complex64, built as
    acquire_pallas.py:79-110 builds them. Forward, with time index
    ``N2 m1 + m2`` and frequency ``k1 + 16 k2``: ``f1`` ``[16, 16]``
    (k1, m1), ``twf`` ``[16, 1, N2]``, ``f2`` ``[N2, N2]`` (m2, k2).
    Inverse, with 1/N folded in: ``w2c`` ``[N2, N2]`` (k2, n2), ``tw``
    ``[16, 1, N2]``, ``w1c`` ``[16, 16]`` (n1, k1)."""
    n2 = n // _N1
    k1 = np.arange(_N1)
    m2 = np.arange(n2)
    return {
        "f1": np.exp(-2j * np.pi * np.outer(k1, k1) / _N1).astype(np.complex64),
        "twf": np.exp(-2j * np.pi * np.outer(k1, m2) / n)[:, None, :].astype(np.complex64),
        "f2": np.exp(-2j * np.pi * np.outer(m2, m2) / n2).astype(np.complex64),
        "w2c": (np.exp(2j * np.pi * np.outer(m2, m2) / n2) / n2).astype(np.complex64),
        "tw": np.exp(2j * np.pi * np.outer(k1, m2) / n)[:, None, :].astype(np.complex64),
        "w1c": (np.exp(2j * np.pi * np.outer(k1, k1) / _N1) / _N1).astype(np.complex64),
    }


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to bf16 (to nearest, ties to even), as uint16."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _b_core_matrices(t: np.ndarray) -> np.ndarray:
    """A complex ``[K, N]`` table as wgmma reads its B operand from shared
    memory (K-major, no swizzle), rounded to bf16: int16 ``[2, N/8, K/8,
    8, 8]``, for part (re, im), column block ``n // 8`` and row block
    ``k // 8`` one core matrix of 128 bytes, column ``n % 8`` at 16 bytes
    a column and row ``k % 8`` within it. Core matrices are 128 bytes apart
    along K and ``K/8 * 128`` along N (the descriptor's leading and stride
    byte offsets in ``csrc/correlate_bf16.cu``)."""
    k, n = t.shape
    parts = [_bf16_bits(p).reshape(k // 8, 8, n // 8, 8).transpose(2, 0, 3, 1)
             for p in (t.real, t.imag)]
    return np.ascontiguousarray(np.stack(parts)).view(np.int16)


def fragment_index(n: int) -> np.ndarray:
    """Where the accumulator fragments of a ``[16, N2]`` product sit in the
    ``[k1, k2]`` spectrum, as the flat frequency ``k1 + 16 k2``: int64
    ``[N2/8, 32, 4]``, for n-tile ``nt``, lane ``4 g + q`` and value ``i``
    the row ``g + 8 (i // 2)`` and column ``8 nt + 2 q + i % 2``. wgmma's
    m64 accumulator gives each of its four warps this layout for its own
    16 rows."""
    n2 = n // _N1
    lane = np.arange(32)[:, None]
    i = np.arange(4)[None, :]
    k1 = (lane >> 2) + 8 * (i >> 1)
    k2 = 8 * np.arange(n2 // 8)[:, None, None] + 2 * (lane & 3) + (i & 1)
    return k1 + _N1 * k2


# the sizes whose kernel runs the bulk products with wgmma from one shared-
# memory table, and its walk: blocks of WG_GROUPS warpgroups, each a group of
# WG_FRAMES frames at a time (csrc/correlate_bf16.cu, namespace wg)
WGMMA_FFT_SIZES = (2048,)
WG_GROUPS = 2
WG_FRAMES = 4
# the sizes whose kernel streams the table into shared memory a block at a
# time (correlate_bf16_stream: namespace st, struct Stream): table blocks of
# STREAM_COLS columns in chunks of STREAM_CHUNK_K rows, groups of
# STREAM_FRAMES frames, bins four at a time
STREAM_FFT_SIZES = (4096, 8192)
STREAM_COLS = 32
STREAM_CHUNK_K = 128
STREAM_FRAMES = 4


def stream_kprime(n2: int) -> np.ndarray:
    """The natural row ``k`` at each position ``k'`` of the streaming
    kernel's K order: the even rows, then the odd ones (int64 ``[N2]``), so
    that the second half of W2c's columns, ``(-1)^k`` times the first, is
    the first half with the odd half of ``k'`` negated."""
    return np.concatenate([np.arange(0, n2, 2), np.arange(1, n2, 2)])


def _stream_table(w2c: np.ndarray) -> np.ndarray:
    """W2c's first ``N2/2`` columns as the streaming kernel reads its
    chunks, rounded to bf16: int16 ``[blocks, chunks, 2, 4, 16, 8, 8]``,
    for table block ``tb`` (columns ``32 tb ..``), chunk ``kc`` (rows ``k' =
    128 kc ..``) and part (re, im), the K-major core matrix (column block
    ``n // 8``, row block ``k' // 8``) of 128 bytes, column ``n % 8`` at 16
    bytes a column and row ``k' % 8`` within it: a chunk is 16 KB, its
    core matrices 128 bytes apart along K and 2048 along N."""
    n2 = w2c.shape[0]
    t = w2c[stream_kprime(n2)][:, : n2 // 2]
    parts = [_bf16_bits(p).reshape(n2 // STREAM_CHUNK_K, STREAM_CHUNK_K // 8, 8,
                                   n2 // 2 // STREAM_COLS, STREAM_COLS // 8, 8).transpose(3, 0, 4, 1, 5, 2)
             for p in (t.real, t.imag)]
    return np.ascontiguousarray(np.stack(parts, axis=2))


def _replica_index(n: int) -> np.ndarray:
    """The flat frequency ``k1 + 16 k2`` at each place of the bf16 kernel's
    replica layout: :func:`fragment_index` at the sizes of
    ``WGMMA_FFT_SIZES``, else ``[16, N2]`` with ``k2`` in the order
    :func:`stream_kprime`."""
    if n in WGMMA_FFT_SIZES:
        return fragment_index(n)
    n2 = n // _N1
    return np.arange(_N1)[:, None] + _N1 * stream_kprime(n2)[None, :]


@lru_cache(maxsize=8)
def bf16_tables(n: int) -> dict[str, np.ndarray]:
    """The bf16 kernel's host tables, in numpy: ``w2c``, the bulk factor
    ``w2c`` rounded to bf16, which serves both bulk products (rounded, ``f2``
    is N2 times its conjugate), its columns ``0 .. N2/2 - 1`` only (column
    ``n + N2/2`` is column ``n`` times ``(-1)^k``, which the kernel applies
    to its left operand; bit for bit but where the exact value is 0 and the
    table holds rounding noise under 1e-15): at the sizes of
    ``WGMMA_FFT_SIZES`` in wgmma's layout (:func:`_b_core_matrices`), at
    those of ``STREAM_FFT_SIZES`` in the streaming kernel's chunks
    (:func:`_stream_table`); ``small``, float32 ``[2, 16, 16, 2]``, ``f1``
    and ``w1c`` rounded to bf16 as (re, im) pairs; ``tw``, float32 ``[2,
    16, N2, 2]``, the forward and the inverse twiddles (float32, as the TPU
    kernel keeps them)."""
    t = dft_tables(n)

    def rounded(a):
        bits = np.stack([_bf16_bits(a.real), _bf16_bits(a.imag)], axis=-1)
        return (bits.astype(np.uint32) << 16).view(np.float32)

    w2c = t["w2c"]
    return {
        "w2c": _b_core_matrices(w2c[:, : w2c.shape[1] // 2]) if n in WGMMA_FFT_SIZES else _stream_table(w2c),
        "small": np.stack([rounded(t["f1"]), rounded(t["w1c"])]),
        "tw": np.stack([t["twf"][:, 0], t["tw"][:, 0]]).view(np.float32).reshape(2, _N1, -1, 2),
    }


def persistent_walk(fpad: int, resident: int) -> np.ndarray:
    """The frames of the wgmma kernel's persistent walk: its grid is
    ``min(resident, ceil(ceil(fpad / WG_FRAMES) / WG_GROUPS))`` blocks (at
    most the card's resident blocks), and warpgroup ``w`` of block ``k``
    takes the groups of WG_FRAMES frames ``g = WG_GROUPS k + w``, then
    ``g + WG_GROUPS * blocks``, ... while ``g < ceil(fpad / WG_FRAMES)``;
    its warp ``i`` owns frame ``WG_FRAMES g + i``. Returns int64 ``[blocks,
    WG_GROUPS, steps, WG_FRAMES]``: the frame each warp owns at each step,
    -1 where it owns none (the ragged last group, or a warpgroup whose walk
    ended)."""
    groups = -(-fpad // WG_FRAMES)
    blocks = min(resident, -(-groups // WG_GROUPS))
    steps = -(-groups // (WG_GROUPS * blocks))
    g = (WG_GROUPS * np.arange(blocks)[:, None, None] + np.arange(WG_GROUPS)[None, :, None]
         + WG_GROUPS * blocks * np.arange(steps)[None, None, :])
    frames = WG_FRAMES * g[..., None] + np.arange(WG_FRAMES)
    return np.where((g[..., None] < groups) & (frames < fpad), frames, -1)


def stream_plan(fpad: int, resident: int, nb: int, n: int) -> list[dict]:
    """The streaming kernel's walk and table loads at ``n`` in
    ``STREAM_FFT_SIZES``, one entry a block of its grid
    (``min(resident, ceil(fpad / STREAM_FRAMES))`` blocks). Block ``k``
    takes the groups of STREAM_FRAMES frames ``g = k, k + blocks, ...``; a
    group's passes are its forward pass (its frames; a missing frame of a
    ragged last group is zeros) and, for each frame it has and each group
    of four bins, an inverse pass (bins ``4 bg ..``, those below ``nb``).
    A pass is one product a table block, the blocks in order. The table
    block of a block's first product is loaded at its start, and that of
    product ``p + 1`` once product ``p``'s wgmmas are done, by the kernel's
    rule ``(tb + 1) % blocks``; its last product loads none. Each stage's
    full barrier completes once a product, so product ``p`` waits for its
    phase ``p``, parity ``p & 1``. Each entry: ``passes``, a list of
    (kind, frames, bins); ``products``, int64 ``[count, 3]`` rows of
    (pass, table block, parity); ``loads``, int64 ``[count]``, the table
    block each load brings, in order (the start's, then one after each
    product but the last)."""
    blocks_tb = (n // _N1) // 2 // STREAM_COLS
    groups = -(-fpad // STREAM_FRAMES)
    blocks = min(resident, groups)
    nbg = -(-nb // 4)
    out = []
    for k in range(blocks):
        passes = []
        for g in range(k, groups, blocks):
            frames = list(range(STREAM_FRAMES * g, min(STREAM_FRAMES * (g + 1), fpad)))
            passes.append(("forward", frames, []))
            for f in frames:
                for bg in range(nbg):
                    passes.append(("inverse", [f], list(range(4 * bg, min(4 * bg + 4, nb)))))
        p = np.arange(len(passes) * blocks_tb)
        tb = p % blocks_tb
        loads = np.concatenate([[0], (tb[:-1] + 1) % blocks_tb])
        out.append({"passes": passes, "products": np.stack([p // blocks_tb, tb, p & 1], axis=1),
                    "loads": loads})
    return out


@lru_cache(maxsize=None)  # kept: captured CUDA graphs read these tensors by address
def _bf16_device_tables(n: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """:func:`bf16_tables` on ``device``, and :func:`_replica_index`."""
    t = bf16_tables(n)
    return (*(torch.from_numpy(t[k]).to(device) for k in ("w2c", "small", "tw")),
            torch.from_numpy(_replica_index(n)).to(device))


def bf16_kernel_resources(fft_size: int) -> dict[str, int]:
    """What the card gives the bf16 kernel at ``fft_size`` (a CUDA device
    needed): registers and local (spill) bytes a thread, dynamic shared
    memory bytes and threads a block, resident blocks and frames in flight
    an SM."""
    out = (ctypes.c_int * 6)()
    status = _build.library().pm_correlate_bf16_resources(fft_size.bit_length() - 1, out)
    if status != 0:
        raise RuntimeError(f"pm_correlate_bf16_resources: CUDA error {status}")
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "frames_per_sm")
    return dict(zip(keys, out))


@lru_cache(maxsize=8)
def _resident_blocks(fft_size: int, device: torch.device) -> int:
    """The streaming kernel's resident blocks on ``device``'s card."""
    with torch.cuda.device(device):
        per_sm = bf16_kernel_resources(fft_size)["blocks_per_sm"]
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def replica_table_bf16(rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int) -> torch.Tensor:
    """The replica spectra as the bf16 kernel reads them, in float32 as the
    TPU kernel keeps them: at the sizes of ``WGMMA_FFT_SIZES`` ``[nb, N2/8,
    2, 32, 4]``, for each bin, n-tile and part (re, im) the values of the
    lane's accumulator fragments (:func:`fragment_index`); at those of
    ``STREAM_FFT_SIZES`` ``[nb, 16, N2, 2]``, ``R_b[k1, k2]`` as (re, im)
    with ``k2`` in the order :func:`stream_kprime`. A caller that keeps
    its replicas builds this once and passes it to
    :func:`fused_best_power`."""
    idx = _bf16_device_tables(fft_size, rfr.device)[-1]
    return torch.stack([rfr[:, idx], rfi[:, idx]], dim=2 if fft_size in WGMMA_FFT_SIZES else -1).contiguous()


def _bf16_bins(ar, ai, br, bi, rfr, rfi, fft_size: int):
    """Each bin's power ``[FPAD, N]``, bin by bin, as the TPU kernel's bf16
    form computes it: ``dot`` rounds its left operand to bf16 and
    accumulates in float32; where the left operand is a bf16 table and the
    right one float32 data (the radix-16 DFTs), the data stays float32."""
    n, s = fft_size, ar.shape[1]
    n2 = n // _N1
    dev = ar.device
    t = dft_tables(n)

    def table(a, rounded=True):
        v = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return v.to(torch.bfloat16).float() if rounded else v

    def q(v):
        return v.to(torch.bfloat16).float()

    f1r, f1i, f2r, f2i = (table(getattr(t[k], p)) for k in ("f1", "f2") for p in ("real", "imag"))
    w2r, w2i, w1r, w1i = (table(getattr(t[k], p)) for k in ("w2c", "w1c") for p in ("real", "imag"))
    twfr, twfi = table(t["twf"].real[:, 0], False), table(t["twf"].imag[:, 0], False)
    twr, twi = table(t["tw"].real[:, 0], False), table(t["tw"].imag[:, 0], False)
    xr = torch.cat([ar, br[:, : n - s]], dim=1).view(-1, _N1, n2)  # [F, m1, m2]
    xi = torch.cat([ai, bi[:, : n - s]], dim=1).view(-1, _N1, n2)
    a_r = f1r @ xr - f1i @ xi
    a_i = f1r @ xi + f1i @ xr
    b_r, b_i = q(a_r * twfr - a_i * twfi), q(a_r * twfi + a_i * twfr)
    y_r = b_r @ f2r - b_i @ f2i  # [F, k1, k2]
    y_i = b_r @ f2i + b_i @ f2r
    # R_b[k1, k2] = rf[b, k1 + 16 k2]
    rr = rfr.view(-1, n2, _N1).transpose(1, 2)
    ri = rfi.view(-1, n2, _N1).transpose(1, 2)
    for b in range(rr.shape[0]):
        p_r, p_i = q(y_r * rr[b] - y_i * ri[b]), q(y_r * ri[b] + y_i * rr[b])
        u_r = p_r @ w2r - p_i @ w2i
        u_i = p_r @ w2i + p_i @ w2r
        v_r, v_i = u_r * twr - u_i * twi, u_r * twi + u_i * twr
        o_r = w1r @ v_r - w1i @ v_i  # [F, n1, n2]
        o_i = w1r @ v_i + w1i @ v_r
        yield (o_r * o_r + o_i * o_i).view(-1, n)


def bf16_bin_powers(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int,
) -> torch.Tensor:
    """Every bin's power ``[nb, FPAD, N]`` in the bf16 form (the plain
    version's, before the reduction over bins)."""
    return torch.stack(list(_bf16_bins(ar, ai, br, bi, rfr, rfi, fft_size)))


def fused_best_power_bf16_plain(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 form's best power and bin: the four-step factorization in
    torch with the TPU kernel's casts (:func:`_bf16_bins`), then a running
    max over the bins with a strict ``>`` from -1, so the lowest bin wins a
    tie."""
    best_pow = best_bin = None
    for b, p in enumerate(_bf16_bins(ar, ai, br, bi, rfr, rfi, fft_size)):
        if best_pow is None:
            best_pow = torch.full_like(p, -1.0)
            best_bin = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
        upd = p > best_pow
        best_pow = torch.where(upd, p, best_pow)
        best_bin = torch.where(upd, b, best_bin)
    return best_pow, best_bin


# The kernel's transform (csrc/correlate.cu): a thread holds 16 complex
# points in registers; each pass runs radix-R butterflies on them (16 / R per
# thread), with one exchange through shared memory between passes.
_RADICES = {2048: (16, 16, 8), 4096: (16, 16, 16), 8192: (16, 16, 16, 2)}
POINTS = 16
# bases of each pass's twiddles: W_L^(e*m) for these e; the kernel builds the
# other powers as products of at most three of them
TWIDDLE_BASES = (1, 2, 4, 8)


def kernel_passes(n: int) -> list[tuple[int, int, int]]:
    """``(R, L, M)`` of each pass of the kernel's decimation-in-frequency
    transform: radix ``R`` on in-place sub-sequences of length ``L``, whose
    butterflies take the points ``M = L / R`` apart."""
    out, length = [], n
    for r in _RADICES[n]:
        out.append((r, length, length // r))
        length //= r
    return out


def kernel_positions(n: int, p: int) -> np.ndarray:
    """Position in the transform's in-place array of the point that thread
    ``t`` holds in register ``j`` during pass ``p``: int64 ``[16, N/16]``.
    Thread t runs butterflies ``beta = t + (N/16) u`` for ``u < 16/R``;
    register ``j = u R + r`` holds its point ``r``, at
    ``(beta // M) L + r M + beta % M``."""
    r_, length, m_ = kernel_passes(n)[p]
    t = np.arange(n // POINTS)
    rows = []
    for u in range(POINTS // r_):
        beta = t + (n // POINTS) * u
        for r in range(r_):
            rows.append((beta // m_) * length + r * m_ + beta % m_)
    return np.array(rows, dtype=np.int64)


@lru_cache(maxsize=8)
def kernel_plan(n: int) -> dict:
    """The kernel's host tables, in numpy: ``twiddles``, complex64, for each
    pass with ``M > 1`` the bases ``W_L^(e m)``, ``e`` in ``TWIDDLE_BASES``,
    ``m < M``, as ``[4, M]`` rows, computed in float64 and concatenated in
    pass order (``offsets`` gives each pass's start); and ``freq_of``,
    int64 ``[16, N/16]``: the frequency whose spectrum value thread ``t``
    holds in register ``j`` after the forward transform (the last pass's
    positions, mixed-radix digit-reversed)."""
    passes = kernel_passes(n)
    parts, offsets, off = [], [], 0
    for _, length, m_ in passes:
        offsets.append(off)
        if m_ > 1:
            e = np.array(TWIDDLE_BASES)[:, None] * np.arange(m_)[None, :]
            parts.append(np.exp(-2j * np.pi * e / length).ravel())
            off += len(TWIDDLE_BASES) * m_
    pos = kernel_positions(n, len(passes) - 1)
    freq = np.zeros_like(pos)
    rem, scale = pos.copy(), 1
    for r_, length, m_ in passes:
        freq += (rem // m_) * scale
        rem %= m_
        scale *= r_
    return {
        "twiddles": np.concatenate(parts).astype(np.complex64),
        "offsets": offsets,
        "freq_of": freq,
    }


@lru_cache(maxsize=None)  # kept: captured CUDA graphs read these tensors by address
def _tables(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``kernel_plan(n)``'s twiddle bases (complex64) and register-order
    frequency map (int64 ``[16 * N/16]``, register-major) on ``device``."""
    plan = kernel_plan(n)
    return (
        torch.from_numpy(plan["twiddles"]).to(device),
        torch.from_numpy(plan["freq_of"].ravel()).to(device),
    )


def replica_table(rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int) -> torch.Tensor:
    """The replica spectra as the kernel reads them: float32 ``[nb, N, 2]``,
    interleaved, in the register order the kernel's forward transform
    leaves, ``rf[b, j, t] = R_b[freq_of[j, t]]``, times the inverse
    transform's 1/N (a power of two: exact). A caller that keeps its
    replicas builds this once and passes it to :func:`fused_best_power`."""
    _, freq_of = _tables(fft_size, rfr.device)
    return (torch.stack([rfr, rfi], dim=-1)[:, freq_of] * (1.0 / fft_size)).contiguous()


def fused_best_power(
    ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
    rfr: torch.Tensor, rfi: torch.Tensor, fft_size: int, block_frames: int = 16,
    *, table: torch.Tensor | None = None, bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-bin correlation power per sample over all frequency bins.

    ``ar``/``ai``/``br``/``bi``: float32 ``[FPAD, S]`` frame bodies and
    shifted views (``N - S <= S``); ``rfr``/``rfi``: float32 ``[nb, N]``
    conj replica spectra; ``table``: the kernel's replica layout where the
    caller keeps it (``replica_table``, or ``replica_table_bf16`` with
    ``bf16``), else the kernel route builds it; ``bf16``: the TPU kernel's
    bf16 form (the ``fused_bf16`` backend). FPAD must be a multiple of
    ``block_frames`` only to mirror the TPU function's checks: the CUDA
    kernels run one frame a block or a warp. Returns
    ``(best_pow float32 [FPAD, N], best_bin int32 [FPAD, N])``."""
    route = kernel_route(ar, ai, br, bi, rfr, rfi)
    _check(ar, ai, br, bi, rfr, rfi, fft_size, block_frames)
    if route == "plain":
        plain = fused_best_power_bf16_plain if bf16 else fused_best_power_plain
        return plain(ar, ai, br, bi, rfr, rfi, fft_size)
    if fft_size not in KERNEL_FFT_SIZES:
        raise ValueError(f"the CUDA correlator takes fft_size in {KERNEL_FFT_SIZES}, got {fft_size}")
    for t in (ar, ai, br, bi):
        if not t.is_contiguous():
            raise ValueError("fused_best_power needs contiguous frame views")
    fpad, s = ar.shape
    nb = rfr.shape[0]
    if not 0 < nb <= MAX_BINS:
        raise ValueError(f"the CUDA correlator takes 1 to {MAX_BINS} bins, got {nb}")
    if bf16:
        w2c, small, tw, _ = _bf16_device_tables(fft_size, ar.device)
        rf = replica_table_bf16(rfr, rfi, fft_size) if table is None else table
        n2 = fft_size // _N1
        shape = (nb, n2 // 8, 2, 32, 4) if fft_size in WGMMA_FFT_SIZES else (nb, _N1, n2, 2)
    else:
        tw, _ = _tables(fft_size, ar.device)
        rf = replica_table(rfr, rfi, fft_size) if table is None else table
        shape = (nb, fft_size, 2)
    if (rf.shape != shape or rf.dtype != torch.float32 or not rf.is_contiguous()
            or rf.device != ar.device):
        raise ValueError(f"table must be contiguous float32 {list(shape)} on {ar.device}, "
                         f"got {rf.dtype} {tuple(rf.shape)} on {rf.device}")
    best_pow = ar.new_empty(fpad, fft_size)
    best_bin = torch.empty(fpad, fft_size, dtype=torch.int32, device=ar.device)
    if fpad == 0:
        return best_pow, best_bin
    if bf16:
        # the streaming kernel's scratch: four frames' spectra a block of
        # its grid (at most the resident blocks, at most a block a group)
        blocks = 0
        scratch = best_pow
        if fft_size in STREAM_FFT_SIZES:
            blocks = min(_resident_blocks(fft_size, ar.device), -(-fpad // STREAM_FRAMES))
            scratch = ar.new_empty(blocks, STREAM_FRAMES, _N1, fft_size // _N1, 2)
        _build.launch(
            "correlate_bf16", "pm_correlate_bf16", ar.device,
            ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(), rf.data_ptr(),
            w2c.data_ptr(), small.data_ptr(), tw.data_ptr(), scratch.data_ptr(),
            best_pow.data_ptr(), best_bin.data_ptr(),
            fpad, s, nb, fft_size.bit_length() - 1, blocks, _build.stream_of(ar),
        )
    else:
        _build.launch(
            "correlate", "pm_correlate", ar.device,
            ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
            rf.data_ptr(), tw.data_ptr(), best_pow.data_ptr(), best_bin.data_ptr(),
            fpad, s, nb, fft_size.bit_length() - 1, _build.stream_of(ar),
        )
    return best_pow, best_bin
