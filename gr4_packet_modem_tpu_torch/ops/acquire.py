"""Syncword acquisition: correlation + CFAR detection.

Port of ``gr4_packet_modem_tpu/ops/acquire.py`` with its five backends. The
correlation against the ``2*freq_bins+1`` frequency-shifted syncword
replicas runs as batched overlap-save FFTs on ``torch.fft`` (``fft``); as a
real 2-in / 2nb-out convolution with the replica bank (``conv`` in float32,
``conv_bf16`` with both operands rounded to bf16 and float32 accumulation);
or through the K1 fused correlator (``ops/acquire_cuda.py``), which reduces
it to the best-bin power and bin per sample without materialising the
per-bin correlations (``fused`` in float32, ``fused_bf16`` in the TPU
kernel's bf16 form). Detection is the chunked peak detector (event-identical
to the reference's running-best state machine) and the candidate estimates
are the closed-form math of syncword_detection.hpp:56-115, vectorised over
candidates; the fused backends recompute the complex correlation and the
adjacent-bin powers exactly at the candidates. Every function takes a bank
``[C, T]`` (a single channel is ``[T]``): acquisition is batched over
channels.

The noise window of each candidate is fetched by the K2 region-fetch kernel
and the neighbour powers of each candidate by the K2b row fetch
(``ops/fetch_cuda.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
from torch import nn

from ..utils import constants as C
from ..utils.firdes import rx_rrc_taps
from ..utils.graphs import stage
from ..utils.trace import span

from .acquire_cuda import (
    KERNEL_FFT_SIZES, fused_best_power, replica_table, replica_table_bf16,
)
from .costas import PI, TWO_PI
from .fetch_cuda import fetch_regions, fetch_rows

__all__ = [
    "AcquisitionConfig", "Detections", "SyncwordAcquirer",
    "modulated_syncword", "acquirer_tables", "chunked_peak_detect", "BACKENDS",
]


def modulated_syncword(sps: int = 4) -> tuple[np.ndarray, float]:
    """RRC-modulated BPSK syncword replica and its self-correlation
    (syncword_detection.hpp:154-164)."""
    taps, _ = rx_rrc_taps(sps)
    sync = np.asarray(C.SYNCWORD)
    const = np.asarray(C.BPSK_CONSTELLATION)
    n = (sync.size - 1) * sps + taps.size
    out = np.zeros(n, dtype=np.complex64)
    for j, b in enumerate(sync):
        out[j * sps : j * sps + taps.size] += const[b] * taps
    self_corr = float(np.sum(np.abs(out) ** 2))
    return out, self_corr


BACKENDS = ("auto", "fused", "fused_bf16", "fft", "conv", "conv_bf16")


@dataclass(frozen=True)
class AcquisitionConfig:
    samples_per_symbol: int = 4
    fft_size: int = C.SYNC_FFT_SIZE
    freq_bins: int = 4  # search bins [-freq_bins, +freq_bins]
    time_threshold: int = C.SYNC_TIME_THRESHOLD
    power_threshold: float = C.SYNC_POWER_THRESHOLD
    max_detections: int = 64  # static bound per processed block
    # correlation backend:
    #   "auto"       "fused" on a CUDA device when the kernel takes fft_size,
    #                else "fft" (resolved_backend)
    #   "fused"      the K1 correlator (csrc/correlate.cu)
    #   "fused_bf16" K1's bf16 form: bulk DFTs with bf16 inputs and float32
    #                accumulation on the tensor cores (csrc/correlate_bf16.cu);
    #                candidate phase and adjacent powers still exact in float32
    #   "fft"        overlap-save FFTs, as the reference
    #   "conv"       the correlation as a real 2-plane convolution (float32)
    #   "conv_bf16"  the same with bf16 inputs and float32 accumulation
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"acquisition backend {self.backend!r} not in {BACKENDS}")
        if self.backend in ("fused", "fused_bf16") and self.fft_size % 2048:
            raise ValueError(
                f"the {self.backend} backend needs fft_size to be a multiple of 2048; "
                'use backend="auto" to run fft for other sizes'
            )

    def resolved_backend(self, device: str | torch.device) -> str:
        """The backend an acquirer on ``device`` runs."""
        if self.backend != "auto":
            return self.backend
        on_cuda = torch.device(device).type == "cuda"
        return "fused" if on_cuda and self.fft_size in KERNEL_FFT_SIZES else "fft"


@dataclass
class Detections:
    """Sparse detection set, sorted by sample index with invalid entries
    last. Fields are ``[D]``, or ``[C, D]`` for a bank (then ``overflow``
    is ``[C]``)."""

    index: torch.Tensor      # int64 syncword start sample
    valid: torch.Tensor      # bool
    amplitude: torch.Tensor  # float32
    phase: torch.Tensor      # float32
    freq: torch.Tensor       # float32 rad/sample
    freq_bin: torch.Tensor   # int64
    time_est: torch.Tensor   # float32 in [-0.5, 0.5]
    noise_power: torch.Tensor  # float32
    esn0_db: torch.Tensor    # float32
    overflow: torch.Tensor   # bool: more peaks than max_detections slots

    def map(self, fn) -> "Detections":
        """Apply ``fn`` to every field."""
        return Detections(*(fn(getattr(self, f.name)) for f in fields(self)))


def acquirer_tables(config: AcquisitionConfig) -> dict[str, np.ndarray]:
    """The acquirer's constant tables, built as the JAX acquirer builds
    them: ``replicas`` complex64 ``[nb, L]`` (frequency-shifted replicas,
    bin spacing pi / L rad/sample), ``noise_filter`` float32 ``[33]`` (the
    out-of-band high-pass of the noise estimate), ``noise_gain`` and
    ``self_corr`` (float64 scalars), ``conv_kernel`` float32 ``[L, 2, 2nb]``
    (the conv backends' kernel, acquire.py:165-174 of the JAX package:
    input planes re, im; outputs the bins' real then imaginary parts of
    ``sum_k conj(rep_b[k]) x[t+k]``)."""
    from scipy import signal

    replica, self_corr = modulated_syncword(config.samples_per_symbol)
    sync_len = replica.size
    bins = np.arange(-config.freq_bins, config.freq_bins + 1)
    k = np.arange(sync_len)
    shift = np.exp(1j * (bins[:, None] * np.pi / sync_len) * k[None, :])
    hp = signal.remez(33, [0.0, 0.22, 0.3, 0.5], [0.0, 1.0], fs=1.0).astype(
        np.float32
    )
    replicas = (replica[None, :] * shift).astype(np.complex64)
    nb = replicas.shape[0]
    rr, ri = replicas.real, replicas.imag
    kernel = np.zeros((sync_len, 2, 2 * nb), np.float32)
    kernel[:, 0, :nb] = rr.T
    kernel[:, 1, :nb] = ri.T
    kernel[:, 0, nb:] = -ri.T
    kernel[:, 1, nb:] = rr.T
    return {
        "replicas": replicas,
        "noise_filter": hp,
        "noise_gain": np.float64(np.sum(hp**2)),
        "self_corr": np.float64(self_corr),
        "conv_kernel": kernel,
    }


def chunked_peak_detect(
    best_pow: torch.Tensor, w: int, d: int, power_threshold: float,
    fresh_lo: int | torch.Tensor | None = None,
    fresh_hi: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed peak detection + CFAR over ``best_pow`` ``[C, T]``.

    Sample ``t`` is a detection event iff its power is >= everything in
    the centred window ``[t-w, t+w]``, strictly > everything in
    ``[t-w, t-1]`` (first index wins ties), both window halves exist
    (``w <= t < T-w``), ``t`` lies in ``[fresh_lo, fresh_hi)`` where those
    are given, and at least half the window is below
    ``power/power_threshold`` (the history-median CFAR proxy). The fresh
    window applies before the slots are chosen, so a streaming driver's
    look-back and lookahead peaks neither take slots nor set ``overflow``
    (they are seen when their own block is fresh). The ``d``
    slots go to the top-d passing events by power; ``overflow`` flags more
    passing events than slots. Every event is its w-sized chunk's first
    argmax, so the window tests run as offset-masked reductions over the
    ``[C, nch, w]`` chunk view (acquire.py:579-699 of the JAX package).

    Returns ``(top_pow [C, d], top_idx [C, d], overflow [C])`` with empty
    slots marked by ``top_pow == -1``.
    """
    c, tlen = best_pow.shape
    dev = best_pow.device
    nch = max(tlen // w, 1)
    pad_len = (nch + 1) * w - tlen
    neg = -torch.inf
    bp_pad = torch.cat([best_pow, best_pow.new_full((c, pad_len), neg)], dim=1)
    chunks = bp_pad.view(c, nch + 1, w)
    cur = chunks[:, :nch]
    nxt = chunks[:, 1 : nch + 1]
    prv = torch.cat([best_pow.new_full((c, 1, w), neg), chunks[:, : nch - 1]], dim=1)
    b = cur.amax(dim=-1)  # candidate powers [C, nch]
    o = cur.argmax(dim=-1)  # first maximum
    ti = o + torch.arange(nch, device=dev) * w
    off = torch.arange(w, device=dev)
    o3 = o[..., None]
    suff_prev = torch.where(off >= o3, prv, neg).amax(dim=-1)
    pref_next = torch.where(off <= o3, nxt, neg).amax(dim=-1)
    is_peak = (b > suff_prev) & (b >= pref_next)
    pos_ok = (ti >= w) & (ti < tlen - w)
    if fresh_lo is not None:
        pos_ok &= ti >= fresh_lo
    if fresh_hi is not None:
        pos_ok &= ti < fresh_hi
    thr = (b / power_threshold)[..., None]
    below = (
        ((prv < thr) & (off >= o3)).sum(dim=-1)
        + (cur < thr).sum(dim=-1)
        + ((nxt < thr) & (off <= o3)).sum(dim=-1)
    )
    passing = is_peak & pos_ok & (b > 0) & (2 * below >= 2 * w + 1)
    overflow = passing.sum(dim=-1) > d
    score = torch.where(passing, b, -1.0)
    if nch >= d:
        top_pow, sel = torch.topk(score, d, dim=-1)
        top_idx = ti.gather(1, sel)
    else:  # degenerate tiny buffers: fewer chunks than slots
        top_pow = torch.cat([score, score.new_full((c, d - nch), -1.0)], dim=1)
        top_idx = torch.cat([ti, ti.new_zeros(c, d - nch)], dim=1)
    return top_pow, top_idx, overflow


# frames per TPU kernel block; the port keeps the JAX layout's FPAD rounding
_BLOCK_FRAMES = 16


class SyncwordAcquirer(nn.Module):
    """Batched syncword acquisition; the constant tables are buffers.
    :meth:`acquire` is a stage of the owning ``Receiver``'s bank step:
    inside one it replays two graphs from the ``step_graphs`` the receiver
    sets, the peak search's and the estimates' (:meth:`_peaks`)."""

    step_graphs = None

    def __init__(self, config: AcquisitionConfig, device: str | torch.device):
        super().__init__()
        self.config = config
        self.backend = config.resolved_backend(device)
        self.fused = self.backend in ("fused", "fused_bf16")
        tables = acquirer_tables(config)
        self.sync_len = tables["replicas"].shape[1]
        self.num_bins = 2 * config.freq_bins + 1
        n = config.fft_size
        # the framing takes each frame's (sync_len-1)-sample lookahead from
        # the next stride: it must fit inside one stride
        if n < 2 * (self.sync_len - 1):
            raise ValueError(
                f"fft_size must be >= {2 * (self.sync_len - 1)} "
                f"(2*(sync_len-1)) for the overlap-save framing"
            )
        # the fused backend carves each candidate's syncword window out of
        # its noise region, at an offset of up to time_threshold + 16: the
        # window fits only if sync_len <= time_threshold + 17 (the JAX
        # package assumes it unchecked)
        k = tables["noise_filter"].size
        if self.fused and self.sync_len > config.time_threshold + k // 2 + 1:
            raise ValueError(
                f"the {self.backend} backend needs sync_len ({self.sync_len}) <= "
                f"time_threshold + {k // 2 + 1} ({config.time_threshold + k // 2 + 1})"
            )
        self.stride = n - self.sync_len + 1
        for name, value in tables.items():
            self.register_buffer(name, torch.tensor(value, device=device))
        self.derive_tables()

    def derive_tables(self) -> None:
        """Tables computed from the carried ones (call again after loading
        new ones): the conj replica spectra as I/Q planes ``[nb, N]``, and
        the noise filter's taps, time-reversed, as Python floats (so the
        step reads nothing back from the device)."""
        rep = self.replicas.new_zeros(self.num_bins, self.config.fft_size)
        rep[:, : self.sync_len] = self.replicas
        rf = torch.fft.fft(rep, dim=-1).conj()
        self.register_buffer("replica_fft_r", rf.real.contiguous(), persistent=False)
        self.register_buffer("replica_fft_i", rf.imag.contiguous(), persistent=False)
        # the same spectra in the fused kernel's layout, built once here
        layout = {"fused": replica_table, "fused_bf16": replica_table_bf16}.get(self.backend)
        self.register_buffer(
            "replica_table",
            layout(self.replica_fft_r, self.replica_fft_i, self.config.fft_size)
            if layout and self.config.fft_size in KERNEL_FFT_SIZES else None,
            persistent=False,
        )
        self._noise_taps = self.noise_filter.flip(0).tolist()

    # ------------------------------------------------------------ correlation

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        """Overlap-save frames ``[C, F, N]``: frame f = x[f*s : f*s+n] is a
        body reshape plus the lookahead tail from a one-stride-shifted
        reshape."""
        n, s = self.config.fft_size, self.stride
        c, t = x.shape
        nf = (t - n) // s + 1
        body = x[:, : nf * s].reshape(c, nf, s)
        shifted = x[:, s:]
        pad = max(0, s + nf * s - t)
        if pad:
            shifted = torch.cat([shifted, x.new_zeros(c, pad)], dim=1)
        tail = shifted[:, : nf * s].reshape(c, nf, s)[:, :, : n - s]
        return torch.cat([body, tail], dim=2)

    def _correlate_fft(self, x: torch.Tensor) -> torch.Tensor:
        """Complex correlations ``[C, nb, T']`` (T' = frames * stride) of
        ``x`` ``[C, T]`` with every replica, by overlap-save FFT."""
        s = self.stride
        frames = self._frames(x)
        c, nf, _ = frames.shape
        f = torch.fft.fft(frames, dim=-1)  # [C, F, N]
        rf = torch.complex(self.replica_fft_r, self.replica_fft_i)
        corr = torch.fft.ifft(f[:, :, None, :] * rf[None, None], dim=-1)[..., :s]
        return corr.permute(0, 2, 1, 3).reshape(c, self.num_bins, nf * s)

    def _correlate_conv(self, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """Complex correlations ``[C, nb, T-L+1]`` of ``x`` ``[C, T]`` with
        every replica, ``corr_b[t] = sum_k conj(rep_b[k]) x[t+k]``, as one
        real convolution of the I/Q planes with ``conv_kernel`` (2 inputs,
        2nb outputs, L taps). ``bf16`` rounds both operands to bf16 and
        convolves them in float32: a product of two bf16 values is exact in
        float32, so this is bf16 inputs with float32 accumulation (a bf16
        convolution would round its output too). On the card cuDNN's TF32 is
        off for the call, so ``conv`` is float32 throughout."""
        planes = torch.view_as_real(x).permute(0, 2, 1)  # [C, 2, T]
        weight = self.conv_kernel.permute(2, 1, 0)  # [2nb, 2, L]
        if bf16:
            planes = planes.to(torch.bfloat16).float()
            weight = weight.to(torch.bfloat16).float()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out = torch.nn.functional.conv1d(planes.contiguous(), weight.contiguous())
        nb = self.num_bins
        return torch.complex(out[:, :nb], out[:, nb:])

    def _correlate(self, x: torch.Tensor) -> torch.Tensor:
        """``correlate`` of a bank ``[C, T]``."""
        if self.backend == "fft":
            return self._correlate_fft(x)
        return self._correlate_conv(x, bf16=self.backend == "conv_bf16")

    def correlate(self, x: torch.Tensor) -> torch.Tensor:
        """Complex correlations of ``x`` ``[T]`` (or ``[C, T]``) with every
        replica, as the JAX acquirer's ``correlate`` dispatches: the ``fft``
        backend by overlap-save FFT, ``[nb, frames * stride]``; every other
        backend by the convolution, ``[nb, T - L + 1]`` (the bf16 one for
        ``conv_bf16``, float32 otherwise: the fused kernels never write the
        per-bin correlations)."""
        single = x.ndim == 1
        corr = self._correlate(x[None] if single else x)
        return corr[0] if single else corr

    def _frames_planes(self, x: torch.Tensor):
        """The fused kernel's frame views of a bank ``[C, T]``: each channel
        takes ``rows`` stride-long rows of one I/Q plane buffer (its ``F``
        frames, the row holding the last frame's lookahead, and zero rows up
        to a multiple of the block), so no frame's lookahead reaches the
        next channel. Returns ``(ar, ai, br, bi, frames, rows)`` with the
        body views ``a`` and the one-row-shifted views ``b``, each
        ``[C*rows, S]``."""
        n, s = self.config.fft_size, self.stride
        c, t = x.shape
        nf = (t - n) // s + 1
        rows = -(-(nf + 1) // _BLOCK_FRAMES) * _BLOCK_FRAMES
        used = min(t, rows * s)
        planes = torch.empty(2, c * rows * s + s, dtype=torch.float32, device=x.device)
        body = planes[:, : c * rows * s].view(2, c, rows * s)
        body[:, :, :used] = torch.view_as_real(x[:, :used]).permute(2, 0, 1)
        body[:, :, used:] = 0.0
        planes[:, c * rows * s :] = 0.0
        a = planes[:, : c * rows * s].view(2, c * rows, s)
        b = planes[:, s:].view(2, c * rows, s)
        return a[0], a[1], b[0], b[1], nf, rows

    def _best_power_fused(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Best-bin power and bin ``[C, T']`` per sample from the K1
        correlator, float32 or bf16 by the backend (the per-bin correlations
        never reach device memory)."""
        n, s = self.config.fft_size, self.stride
        c = x.shape[0]
        ar, ai, br, bi, nf, rows = self._frames_planes(x)
        bp, bb = fused_best_power(
            ar, ai, br, bi, self.replica_fft_r, self.replica_fft_i, n, _BLOCK_FRAMES,
            table=self.replica_table, bf16=self.backend == "fused_bf16",
        )

        def valid(a):
            return a.view(c, rows, n)[:, :nf, :s].reshape(c, nf * s)

        return valid(bp), valid(bb)

    def _corr_points(
        self, wr: torch.Tensor, wi: torch.Tensor, bins: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact correlations at the candidates by direct dots,
        ``corr[b] = sum_k conj(rep[b, k]) w[k]`` over each candidate's
        syncword window ``wr``/``wi`` ``[..., L]``, for bins ``{b-1, b,
        b+1}`` (clamped). Returns ``(re, im)`` at the centre bin and the
        three powers ``[..., 3]``."""
        nb = self.num_bins
        b3 = torch.stack([(bins - 1).clamp(min=0), bins, (bins + 1).clamp(max=nb - 1)], dim=-1)
        rr = self.replicas.real[b3]  # [..., 3, L]
        ri = self.replicas.imag[b3]
        wr, wi = wr[..., None, :], wi[..., None, :]
        cr = (wr * rr + wi * ri).sum(dim=-1)
        ci = (wi * rr - wr * ri).sum(dim=-1)
        return cr[..., 1], ci[..., 1], cr * cr + ci * ci

    @staticmethod
    def _neighbour_powers(best_pow: torch.Tensor, ti: torch.Tensor):
        """``(best_pow[ti-1], best_pow[ti+1])`` with the indices clamped to
        the row, from one 3-sample window per candidate (K2b): the window
        starts at ti-1 clamped to ``[0, T'-3]``, so the clamped neighbours
        sit at offsets ``ti - start -/+ 1`` clamped to ``[0, 2]``."""
        c, tlen = best_pow.shape
        lo = (ti - 1).clamp(0, tlen - 3)
        starts = lo + torch.arange(c, device=ti.device)[:, None] * tlen
        rows = fetch_rows(best_pow.reshape(-1), starts.reshape(-1), 3).view(c, -1, 3)
        o = (ti - lo)[..., None]
        pa = rows.gather(2, (o - 1).clamp(min=0))[..., 0]
        pc = rows.gather(2, (o + 1).clamp(max=2))[..., 0]
        return pa, pc

    # -------------------------------------------------------------- detection

    def acquire(
        self,
        x: torch.Tensor,
        index0: int = 0,
        fresh_lo: int | torch.Tensor | None = None,
        fresh_hi: int | torch.Tensor | None = None,
    ) -> Detections:
        """Detect syncwords in ``x`` complex64 ``[T]`` or ``[C, T]``.

        Correlations cover syncword starts in ``[0, T - sync_len]``;
        detection needs ``time_threshold`` margin on both sides. ``index0``
        is added to the reported indices. ``fresh_lo``/``fresh_hi``
        restrict eligible starts to ``[fresh_lo, fresh_hi)`` before the
        slots are chosen (:func:`chunked_peak_detect`). Returns
        :class:`Detections` with fields ``[D]`` (or ``[C, D]``)."""
        single = x.ndim == 1
        if single:
            x = x[None]
        with span("rx.acquire", x.device):
            peaks = self._peaks(x, fresh_lo, fresh_hi)
            return self._estimates(x, peaks, index0, single)

    @stage
    def _peaks(self, x: torch.Tensor, fresh_lo, fresh_hi):
        """Correlation and peak detection over a bank ``[C, T]``: the
        candidates, and what the estimates read of the ``[C, T']``
        correlation at them, each ``[C, D]``. A bank step replays this part
        (K1 and the peak search, some 75 launches) as a graph of its own,
        so that the card starts on it while the host launches the
        estimates' graph (some 250), and only ``[C, D]`` values pass from
        one to the other. Returns ``(top_pow, ti, overflow, bi, (pa, pc),
        at_peak)``: :func:`chunked_peak_detect`'s candidates and overflow
        flags, their best bin, the best-bin powers of their neighbour
        samples, and for the backends other than the fused ones the
        adjacent bins' powers and the phase at the peak (None for the fused
        ones, which recompute those at the candidates)."""
        cfg = self.config
        nb = self.num_bins
        c = x.shape[0]
        with span("rx.acquire.correlate"):
            if self.fused:
                best_pow, best_bin = self._best_power_fused(x)  # [C, T']
            else:
                # T' = frames * stride for fft, T - L + 1 for the conv backends
                corr = self._correlate(x)  # [C, nb, T']
                power = corr.abs() ** 2
                best_pow = power.amax(dim=1)
                best_bin = power.argmax(dim=1)
        with span("rx.acquire.peaks"):
            tlen = best_pow.shape[-1]
            top_pow, ti, overflow = chunked_peak_detect(
                best_pow, cfg.time_threshold, cfg.max_detections, cfg.power_threshold,
                fresh_lo, fresh_hi,
            )
            bi = best_bin.gather(1, ti).long()
            # time interpolation from the neighbour samples' best-bin powers,
            # indices clamped on both backends (the JAX fused path reads 0.0
            # past the padding instead; only slots pos_ok excludes get there)
            neighbours = self._neighbour_powers(best_pow, ti)
            at_peak = None
            if not self.fused:
                flat_power = power.reshape(c, nb * tlen)
                at_peak = (
                    flat_power.gather(1, (bi - 1).clamp(min=0) * tlen + ti),
                    flat_power.gather(1, (bi + 1).clamp(max=nb - 1) * tlen + ti),
                    torch.angle(corr.reshape(c, nb * tlen).gather(1, bi * tlen + ti)),
                )
        return top_pow, ti, overflow, bi, neighbours, at_peak

    @stage
    def _estimates(self, x: torch.Tensor, peaks, index0, single: bool) -> Detections:
        """The estimates at :meth:`_peaks`' candidates, sorted by index:
        the :class:`Detections` of :meth:`acquire`."""
        top_pow, ti, overflow, bi, (pa, pc), at_peak = peaks
        cfg = self.config
        w = cfg.time_threshold
        nb = self.num_bins
        c, t = x.shape
        with span("rx.acquire.estimate"):
            cand_valid = top_pow > 0
            b = top_pow
            # noise power windows [C, D, 2w + k] around the candidates, from one
            # region fetch (K2); the fused backend takes the syncword windows
            # from them too
            k = len(self._noise_taps)
            region = 2 * w + k
            tc2 = torch.clamp(ti - w - (k - 1) // 2, 0, t - region)
            starts = (tc2 + torch.arange(c, device=x.device)[:, None] * t).reshape(-1)
            wnr, wni = fetch_regions(x.reshape(-1), starts, region)
            wnr = wnr.view(c, -1, region)
            wni = wni.view(c, -1, region)
            # ---------------- parameter estimation at the candidates
            bin_spacing = float(np.float32(np.pi / self.sync_len))
            if at_peak is None:
                # the kernel keeps only the best bin's power: the complex value
                # at the peak and the adjacent bins' powers are recomputed at the
                # candidates. A valid candidate's syncword window starts at
                # offset ti - tc2 in [w, w + (k-1)/2] of its noise region
                # (__init__ checks that it fits); invalid slots are clamped
                ll = self.sync_len
                off = (ti - tc2).clamp(0, region - ll)
                j = off[..., None] + torch.arange(ll, device=x.device)
                cr, ci, p3 = self._corr_points(wnr.gather(2, j), wni.gather(2, j), bi)
                p_left, p_right = p3[..., 0], p3[..., 2]
                phase_raw = torch.atan2(ci, cr)
            else:
                p_left, p_right, phase_raw = at_peak
            interior = (bi > 0) & (bi < nb - 1)
            denom_f = 2.0 * (2.0 * b - (p_left + p_right))
            quad = torch.clamp(
                (p_right - p_left) / torch.where(denom_f == 0, 1.0, denom_f), -0.5, 0.5
            )
            delta_freq = torch.where(interior, quad * bin_spacing, 0.0)
            freq = (bi - cfg.freq_bins).to(torch.float32) * bin_spacing + delta_freq
            phase = phase_raw - delta_freq * 0.5 * float(self.sync_len)
            phase = torch.where(phase >= PI, phase - TWO_PI, phase)
            phase = torch.where(phase < -PI, phase + TWO_PI, phase)
            # power peak interpolation b + (c-a)^2 / (16 (b - (a+c)/2))
            # (syncword_detection.hpp:82-84); 16 (b - (a+c)/2) == 4 * denom_f
            p_interp = torch.where(
                interior,
                b + (p_right - p_left) ** 2
                / torch.where(denom_f == 0, 1.0, 4.0 * denom_f),
                b,
            )
            self_corr = self.self_corr.to(torch.float32)
            amplitude = torch.sqrt(torch.clamp(p_interp, min=0.0)) / self_corr
            denom_t = 2.0 * (2.0 * b - (pa + pc))
            time_est = torch.clamp(
                (pc - pa) / torch.where(denom_t == 0, 1.0, denom_t), -0.5, 0.5
            )
            # noise power: mean power of the out-of-band (high-pass) component
            # in the CFAR window around each candidate, scaled to full-band
            # complex noise power
            h_rev = self._noise_taps
            win = 2 * w + 1
            hp_r = h_rev[0] * wnr[..., 0:win]
            hp_i = h_rev[0] * wni[..., 0:win]
            for j in range(1, k):
                hp_r = hp_r + h_rev[j] * wnr[..., j : j + win]
                hp_i = hp_i + h_rev[j] * wni[..., j : j + win]
            pw = hp_r**2 + hp_i**2  # [C, D, 2w+1]
            noise_power = pw.mean(dim=-1) / self.noise_gain.to(torch.float32)
            noise_power = torch.clamp(noise_power, min=1e-12)
            sync_power = amplitude**2 * self_corr
            esn0 = 10.0 * torch.log10(
                torch.clamp(
                    sync_power
                    * float(cfg.samples_per_symbol)
                    / (noise_power * float(self.sync_len)),
                    min=1e-12,
                )
            )
            # sort by index, invalid last
            key = torch.where(cand_valid, ti, torch.iinfo(torch.int32).max)
            order = torch.argsort(key, dim=1, stable=True)

            def sel(a):
                a = a.gather(1, order)
                return a[0] if single else a

            return Detections(
                index=sel(ti + index0),
                valid=sel(cand_valid),
                amplitude=sel(amplitude),
                phase=sel(phase),
                freq=sel(freq),
                freq_bin=sel(bi - cfg.freq_bins),
                time_est=sel(time_est),
                noise_power=sel(noise_power),
                esn0_db=sel(esn0),
                overflow=overflow[0] if single else overflow,
            )
