"""Batched packet receiver (port of ``gr4_packet_modem_tpu/models/
receiver.py``).

The receive chain runs as feed-forward passes over a sample buffer:

1. **acquire** (``ops/acquire.py``): overlap-save syncword correlation,
   CFAR peak detection and per-candidate estimates;
2. **header pass**: fetch each detection's region, derotate, matched
   filter at the acquisition-selected polyphase arm (on the card one
   launch of the fused extraction kernel, ``csrc/matched.cu``), wipe off
   the syncword, Costas loop (K4), LLRs, descramble, LDPC decode (K5),
   parse;
3. **suppression**: drop detections that start inside a packet already
   claimed, one short scan per channel;
4. **payload pass**: fetch, derotate, matched filter (the same fused
   extraction, every chunk in one launch), carrier tracking
   (V&V block estimator, or the Costas loop), then LLRs, descramble,
   slice, pack and CRC-32 check (``ops/crc.py::payload_crc``: one kernel
   on the card, each row read only up to its own length).

Stages 2-4 are one chain, :meth:`Receiver.decode`, for every caller: the
one-shot ``receive``, the bank step, ``entry()`` and the streaming
drivers (which seed the suppression scan with the state carried from the
previous block). Only ``parallel/bank.py`` runs its own scan, because the
time shards exchange their extents between the header pass and it.

A bank ``[C, N]`` runs acquisition batched over channels and both decode
passes as one flat batch of all channels' detections; suppression stays
per channel. ``bank_step(x, group)`` runs the channels in groups of
``group`` one after another (the JAX package's rule and default, 16),
each group a contiguous row slice of the bank, and merges the groups' rows
back into the one-batch order: acquisition and suppression are per
channel, so every group size gives the same result. Groups bound the
working set; at the bench geometry (64 channels of 553,396 samples) one
batch fits the card's memory as well.

``stream_step(x, busy)`` is the bank step of a continuous stream
(upstream's stream mode): ``x`` is a sliding bank whose fresh window
``[front_pad, front_pad + block)`` alone may start a packet, the rest look-back
and lookahead, and ``busy`` the suppression state carried from the last
step on the card, handed on in place (:func:`hand_on_busy`, the rule of the
streaming drivers).

On a CUDA device ``bank_step`` and ``stream_step`` replay each stage
(``acquire``, ``decode_headers``, ``filter_detections``,
``decode_payloads``, and the stream step's ``hand_on``) from CUDA graphs
captured the second time they see a bank (``utils/graphs.py``; acquisition
as two, the peak search's and the estimates'): the host then issues a
launch or two a stage in place of its hundreds, and the outputs are
bit-identical. The other callers of the stages run them eagerly;
:meth:`Receiver.graph_counts` says how the steps ran.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils import constants as C
from ..utils.firdes import rx_rrc_taps
from ..utils.graphs import StepGraphs, owned, stage
from ..utils.trace import count, next_step, span

from ..ops.acquire import AcquisitionConfig, Detections, SyncwordAcquirer
from ..ops.costas import PI, TWO_PI
from ..ops.costas_cuda import costas_track
from ..ops.crc import payload_crc
from ..ops.ldpc import HeaderLdpcDecoder, combine_repetition
from ..ops.matched_cuda import extract_symbols
from ..ops.packing import pack_bits
from ..ops.scramble import descramble_soft, keystream_np
from .tables import receiver_tables, tables_from_numpy

__all__ = [
    "RxConfig", "Receiver", "HeaderResult", "PayloadResult", "Decoded",
    "packet_extent_samples", "suppress_overlapping", "flatten_detections",
    "flatten_grouped_results", "IDLE_BUSY", "hand_on_busy",
]

_HEADER_REGION_SYMS = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192
IDLE_BUSY = -(1 << 30)  # busy-until of a channel with no packet in flight


def packet_extent_samples(
    packet_length: torch.Tensor, header_ok: torch.Tensor, sps: int
) -> torch.Tensor:
    """Samples claimed by a detection: syncword+header, plus the
    payload+CRC symbols when the header decoded
    (payload_metadata_insert.hpp:227-234)."""
    payload_syms = 4 * (packet_length + C.CRC_NUM_BYTES)
    return torch.where(
        header_ok,
        sps * (_HEADER_REGION_SYMS + payload_syms),
        sps * _HEADER_REGION_SYMS,
    )


def suppress_overlapping(
    index: torch.Tensor, valid: torch.Tensor, extent: torch.Tensor,
    busy0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """In-packet suppression (SyncwordDetectionFilter +
    PayloadMetadataInsert): walk the index-sorted detections (last axis)
    once, dropping any that start before ``busy_until``; kept detections
    claim ``[index, index + extent)``. Leading axes are independent
    channels. Returns ``(busy_end, keep)``."""
    busy = busy0
    keep = []
    for i in range(index.shape[-1]):
        k = valid[..., i] & (index[..., i] >= busy)
        busy = torch.where(k, index[..., i] + extent[..., i], busy)
        keep.append(k)
    return busy, torch.stack(keep, dim=-1)


def hand_on_busy(busy_end: torch.Tensor, block: int) -> torch.Tensor:
    """The suppression state a sliding buffer carries into its next step:
    the scan's busy-until moved back by the ``block`` samples the buffer
    slides, never below :data:`IDLE_BUSY`."""
    return (busy_end - block).clamp(min=IDLE_BUSY)


def flatten_detections(
    det: Detections, chan: torch.Tensor | None = None
) -> tuple[Detections, torch.Tensor]:
    """Per-channel detections ``[C, D]`` -> one ``[C*D]`` batch (channel-
    major rows, views of ``det``'s) plus each row's channel id (``chan``
    where the caller built it before). ``overflow`` stays per channel,
    ``[C]``: the caller merges it (``.any()``) where it reads it."""
    c, dd = det.index.shape
    if chan is None:
        chan = torch.arange(c, device=det.index.device).repeat_interleave(dd)
    return det.map(lambda a: a.reshape(-1)), chan


@dataclass(frozen=True)
class RxConfig:
    samples_per_symbol: int = 4
    max_payload_len: int = 1536       # static payload byte bound
    max_detections: int = 64
    freq_bins: int = 4
    power_threshold: float = C.SYNC_POWER_THRESHOLD
    # one of ops/acquire.py's BACKENDS: "fused" (the K1 correlator),
    # "fused_bf16" (its bf16 form), "fft", "conv", "conv_bf16"; "auto" is
    # "fused" on a CUDA device (AcquisitionConfig.resolved_backend)
    acquisition_backend: str = "auto"
    acquisition_fft_size: int = C.SYNC_FFT_SIZE
    num_pfb_arms: int = 32
    ldpc_iterations: int = 25
    symbol_chunk: int = 2048          # symbol-extraction chunk size
    # payload carrier tracking: "costas" = loop-exact per-symbol recursion
    # (reference behaviour); "vv" = feed-forward block Viterbi&Viterbi
    payload_carrier: str = "costas"
    vv_block: int = 64                # V&V averaging block (symbols)
    # keep the corrected payload symbols in PayloadResult.symbols (for the
    # symbol taps of StreamingReceiver, packet_receiver.hpp:159-189); with
    # the Costas carrier a slot with no detection holds zeros there, as it
    # does in the header symbols
    keep_payload_symbols: bool = False

    def __post_init__(self):
        if self.payload_carrier not in ("costas", "vv"):
            raise ValueError(f"payload_carrier {self.payload_carrier!r} not in ('costas', 'vv')")
        if not 1 <= self.max_payload_len <= C.MAX_PACKET_LEN:
            raise ValueError(f"max_payload_len {self.max_payload_len} outside [1, {C.MAX_PACKET_LEN}]")
        if self.max_detections < 1 or self.symbol_chunk < 1:
            raise ValueError("max_detections and symbol_chunk must be positive")
        # the V&V estimator needs one whole block of payload symbols; the
        # JAX package silently runs it with zero blocks below ~12 bytes
        if self.payload_carrier == "vv" and self.max_payload_syms < self.vv_block:
            raise ValueError(
                f"payload_carrier='vv' needs max_payload_syms >= vv_block "
                f"({self.max_payload_syms} < {self.vv_block}): raise "
                f"max_payload_len to >= {self.vv_block // 4 - C.CRC_NUM_BYTES}"
            )
        AcquisitionConfig(  # validates
            fft_size=self.acquisition_fft_size, backend=self.acquisition_backend
        )

    @property
    def max_payload_syms(self) -> int:
        return 4 * (self.max_payload_len + C.CRC_NUM_BYTES)


@dataclass
class HeaderResult:
    """Per-detection header decode results (aligned with Detections rows)."""

    packet_length: torch.Tensor  # int64 [D]
    packet_type: torch.Tensor    # int64 [D]
    header_ok: torch.Tensor      # bool [D] (LDPC ok & length>0 & known type)
    phase: torch.Tensor          # float32 [D] Costas phase after header
    freq: torch.Tensor           # float32 [D] Costas freq after header
    arm: torch.Tensor            # int64 [D] PFB arm
    n_base: torch.Tensor         # int64 [D] sample of symbol 0
    amp_scale: torch.Tensor      # float32 [D] 1/syncword_amplitude


@dataclass
class PayloadResult:
    data: torch.Tensor      # uint8 [D, max_payload_len] decoded payload bytes
    lengths: torch.Tensor   # int64 [D]
    crc_ok: torch.Tensor    # bool [D]
    accepted: torch.Tensor  # bool [D] kept & header & crc & user-data type
    symbols: torch.Tensor   # float32 [D, S, 2] corrected payload symbols as
    #                         I/Q ([D, 0, 2] unless keep_payload_symbols)


class Decoded(NamedTuple):
    """The receive chain's results (:meth:`Receiver.decode`), rows flat."""

    det: Detections               # [R] rows; overflow: any channel's
    hdr: HeaderResult             # [R]
    header_symbols: torch.Tensor  # [R, 192] corrected syncword + header
    res: PayloadResult            # [R]
    keep: torch.Tensor            # bool [R] kept by the suppression scan
    busy_end: torch.Tensor        # [C] (a bank) or [] busy-until after the scan


def flatten_grouped_results(parts: list[tuple]) -> tuple:
    """Merge per-group ``(det, hdr, res, keep)`` of :meth:`Receiver.
    decode_bank`, in group order, into one ``(det, hdr, res, keep)`` with
    rows group-major, then channel-major within a group: the row order of
    one batch. ``overflow`` is any group's."""
    def merge(name, vals):
        return torch.stack(vals).any() if name == "overflow" else torch.cat(vals)

    def cat(objs):
        cls = type(objs[0])
        return cls(*(merge(f.name, [getattr(o, f.name) for o in objs]) for f in fields(cls)))

    dets, hdrs, ress, keeps = zip(*parts)
    return cat(dets), cat(hdrs), cat(ress), torch.cat(keeps)


class Receiver(nn.Module):
    """The receive chain; its constant tables are buffers (see
    ``models/tables.py``). ``step_graphs`` holds the captured stages of
    :meth:`bank_step`."""

    def __init__(self, config: RxConfig, device: str | torch.device):
        super().__init__()
        self.config = config
        self.step_graphs = StepGraphs()
        self._chan_ids: dict[tuple, torch.Tensor] = {}
        sps = config.samples_per_symbol
        acq = AcquisitionConfig(
            samples_per_symbol=sps,
            fft_size=config.acquisition_fft_size,
            freq_bins=config.freq_bins,
            power_threshold=config.power_threshold,
            max_detections=config.max_detections,
            backend=config.acquisition_backend,
        )
        self.acquirer = SyncwordAcquirer(acq, device)
        self.acquirer.step_graphs = self.step_graphs
        self.filter_delay = rx_rrc_taps(sps)[0].size - 1  # 44
        tables = receiver_tables(sps, config.num_pfb_arms, config.max_payload_len)
        for name, value in tables_from_numpy(tables).items():
            self.register_buffer(name, value.to(device))
        self.arm_len = self.arm_taps.shape[1]
        self.header_decoder = HeaderLdpcDecoder(config.ldpc_iterations, device=device)
        # the stream steps' row counts (rows kept with a good header, the
        # IDLE ones among them), added on the card: a graph adds to it by address
        self.register_buffer("stream_counts", torch.zeros(2, dtype=torch.int64, device=device),
                             persistent=False)
        self._derive_tables()
        s_pay = config.max_payload_syms
        ks = keystream_np(C.HEADER_LLRS + 2 * s_pay).astype(bool)
        self.register_buffer(
            "ks_header", torch.tensor(ks[: C.HEADER_LLRS], device=device),
            persistent=False,
        )
        # the payload's keystream packed MSB first: byte i flips the LLRs of
        # payload byte i (ops/crc.py::payload_crc)
        self.register_buffer(
            "ks_payload", torch.tensor(np.packbits(ks[C.HEADER_LLRS :]), device=device),
            persistent=False,
        )

    def _derive_tables(self) -> None:
        """Tables computed from the carried ones: the acquirer's, the header
        decoder's and the V&V interpolation tables. Drops the captured
        stages, which read the tables they replace."""
        self.step_graphs.clear()
        self.acquirer.derive_tables()
        self.header_decoder.set_tables(self.ldpc_vidx, self.ldpc_vmask, self.ldpc_h)
        dev = self.ldpc_vidx.device
        # V&V: each payload symbol's two block centres and its weight
        # (_vv_track), made here so that a step copies nothing to the card
        blk, s = self.config.vv_block, self.config.max_payload_syms
        nb = s // blk
        pos = (np.arange(s) - (blk - 1) / 2.0) / blk
        b0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 1)
        b1 = np.clip(b0 + 1, 0, nb - 1)
        frac = np.clip(pos - b0, 0.0, 1.0).astype(np.float32)
        for name, value in (("vv_b0", b0), ("vv_b1", b1), ("vv_frac", frac)):
            self.register_buffer(name, torch.tensor(value, device=dev), persistent=False)

    def load_tables(self, tables: dict[str, torch.Tensor]) -> None:
        """Replace the constant tables (names of ``models/tables.py``,
        e.g. from ``tables_from_numpy(numpy_tables_of(jax_receiver))``).
        Shapes and dtypes must match the receiver's own."""
        bufs = {name: self.get_buffer(name) for name in tables}
        for name, buf in bufs.items():
            value = tables[name]
            if buf.shape != value.shape or buf.dtype != value.dtype:
                raise ValueError(
                    f"table {name}: {value.dtype} {tuple(value.shape)} does not "
                    f"match {buf.dtype} {tuple(buf.shape)}"
                )
        for name, buf in bufs.items():
            buf.copy_(tables[name])
        self._derive_tables()

    def _apply(self, fn, *args, **kwargs):
        # buffers moved or cast: the captured stages read the old ones
        self.step_graphs.clear()
        self._chan_ids.clear()
        return super()._apply(fn, *args, **kwargs)

    def graph_counts(self) -> dict[str, int]:
        """How this receiver's bank steps ran: steps ``captured``,
        ``replayed`` and ``eager``, and chains ``evicted``
        (``utils/graphs.py``)."""
        return dict(self.step_graphs.counts)

    # -------------------------------------------------------------- geometry

    @property
    def front_pad(self) -> int:
        """Zero history in front of a capture: the CFAR window plus the
        filter margin, so a packet at the very start is detectable."""
        return C.SYNC_TIME_THRESHOLD + self.filter_delay + 20

    def pad_tail(self) -> int:
        """Lookahead needed past a syncword start: full packet extraction
        plus the acquisition coverage margin."""
        cfg = self.config
        sps = cfg.samples_per_symbol
        extraction = (
            sps * (_HEADER_REGION_SYMS + cfg.max_payload_syms) + self.arm_len + 8
        )
        return extraction + C.SYNC_TIME_THRESHOLD + cfg.acquisition_fft_size

    # ---------------------------------------------------------- symbol timing

    def _timing(self, det: Detections):
        """PFB arm, base sample and adjusted phase per detection
        (symbol_filter.hpp:141-202)."""
        arms = self.config.num_pfb_arms
        neg = det.time_est < 0
        te = torch.where(neg, det.time_est + 1.0, det.time_est)
        arm = torch.clamp(torch.round(arms * te).to(torch.int64), 0, arms - 1)
        n_base = det.index + self.filter_delay - neg.to(torch.int64)
        phase0 = torch.where(neg, det.phase - det.freq, det.phase)
        return arm, n_base, phase0

    # ------------------------------------------------------ symbol extraction

    def _extraction_chunks(self, num_syms: int) -> tuple[int, int]:
        """``(chunk, chunks)`` of an extraction of ``num_syms`` symbols: long
        extractions run in ``symbol_chunk``-symbol chunks, each chunk's
        region clamped to the row on its own (and, on the CPU, each chunk's
        ``[D, region]`` intermediates bounded)."""
        chunk = self.config.symbol_chunk
        if num_syms > 4 * chunk:
            return chunk, -(-num_syms // chunk)
        return num_syms, 1

    def _extract_symbols(
        self,
        x: torch.Tensor,
        n_base: torch.Tensor,
        arm: torch.Tensor,
        freq: torch.Tensor,
        n0: torch.Tensor,
        amp_scale: torch.Tensor,
        sym_offset: int,
        num_syms: int,
        chan: torch.Tensor | None = None,
        plain_span: str | None = None,
    ) -> torch.Tensor:
        """Matched-filter ``num_syms`` symbols from symbol ``sym_offset`` of
        each detection: region fetch, coarse derotation by
        ``exp(-i freq (n - n0))``, polyphase-arm filtering and amplitude
        normalisation, chunked over symbols (``ops/matched_cuda.py::
        extract_symbols``: on the card one launch of the fused extraction
        kernel for all chunks, on the CPU K2's and K3's plain versions with
        the derotation between them). ``x`` is ``[N]``, or a bank
        ``[C, N]`` with ``chan`` giving each detection's channel (regions
        then address the flattened bank; indices stay channel-local).
        Counts the chunks in ``rx.extract.chunks``; ``plain_span`` names a
        span around the CPU route's passes (on the card the extraction is
        one launch, inside the caller's span)."""
        chunk, nchunks = self._extraction_chunks(num_syms)
        count("rx.extract.chunks", nchunks)
        with span(plain_span) if plain_span and x.device.type == "cpu" else nullcontext():
            return extract_symbols(
                x.reshape(-1), x.shape[-1], n_base, chan, arm, self.arm_taps, freq, n0, amp_scale,
                self.config.samples_per_symbol, sym_offset, num_syms, chunk,
            )

    # ------------------------------------------------------------ header pass

    @stage
    def decode_headers(
        self, x: torch.Tensor, det: Detections, chan: torch.Tensor | None = None
    ) -> tuple[HeaderResult, torch.Tensor]:
        """Decode the header of every detection. ``x`` carries ``front_pad``
        zeros in front (indices are relative to ``x``). Returns
        ``(HeaderResult, corrected sync+header symbols [D, 192])``."""
        with span("rx.headers", x.device):
            with span("rx.headers.extract"):
                arm, n_base, phase0 = self._timing(det)
                amp_scale = 1.0 / torch.clamp(det.amplitude, min=1e-9)
                syms = self._extract_symbols(
                    x, n_base, arm, det.freq, det.index, amp_scale, 0,
                    _HEADER_REGION_SYMS, chan,
                )
            with span("rx.headers.costas"):
                # wipe off the syncword modulation -> pure pilot
                syms[:, : C.SYNCWORD_LEN] *= self.sync_bipolar
                # a slot with no detection is not tracked (its rows read
                # zeros): its 1e9 scale would run its loop away
                corrected, ph_end, fr_end = costas_track(
                    syms, phase0.contiguous(), torch.zeros_like(phase0), offset=0,
                    active=det.valid,
                )
            with span("rx.headers.ldpc"):
                hdr_syms = corrected[:, C.SYNCWORD_LEN :]  # [D, 128]
                llrs = torch.view_as_real(hdr_syms).reshape(
                    hdr_syms.shape[0], -1
                ) * self.llr_scale
                comb = combine_repetition(descramble_soft(llrs, self.ks_header)).contiguous()
                bits, ldpc_ok = self.header_decoder.decode(comb)
                hdr_bytes = pack_bits(bits, 8)  # [D, 4]
                packet_length = hdr_bytes[:, 0] << 8 | hdr_bytes[:, 1]
                type_field = hdr_bytes[:, 2]
                header_ok = (
                    ldpc_ok
                    & det.valid
                    & (packet_length > 0)
                    & (type_field <= 1)
                    & (packet_length <= self.config.max_payload_len)
                )
        hdr = HeaderResult(
            packet_length=packet_length,
            packet_type=type_field,
            header_ok=header_ok,
            phase=ph_end,
            freq=fr_end,
            arm=arm,
            n_base=n_base,
            amp_scale=amp_scale,
        )
        return hdr, corrected

    # --------------------------------------------------- detection filtering

    @stage
    def filter_detections(
        self, det: Detections, hdr: HeaderResult, busy0: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Suppress detections that start inside an earlier kept packet's
        extent, the scan seeded with ``busy0`` (busy-until per channel,
        carried from block to block by a streaming caller; None seeds -1,
        made inside the stage, so that a graphed step's key never holds a
        new tensor). ``det``/``hdr`` rows are ``[D]`` or ``[C, D]``.
        Returns ``(busy_end, keep)`` as :func:`suppress_overlapping`."""
        with span("rx.suppress", det.index.device):
            extent = packet_extent_samples(
                hdr.packet_length.reshape(det.index.shape),
                hdr.header_ok.reshape(det.index.shape),
                self.config.samples_per_symbol,
            )
            if busy0 is None:
                busy0 = torch.full(det.index.shape[:-1], -1, device=det.index.device)
            return suppress_overlapping(det.index, det.valid, extent, busy0)

    # ------------------------------------------------------------ the chain

    def decode(
        self, x: torch.Tensor, det: Detections, busy0: torch.Tensor | None = None
    ) -> Decoded:
        """The receive chain after acquisition: ``decode_headers``,
        ``filter_detections`` (seeded with ``busy0``) and
        ``decode_payloads``. ``x`` is a capture ``[T]`` with detections
        ``[D]``, or a bank ``[C, T]`` with ``[C, D]``, whose channels'
        rows run as one flat batch, channel-major (row ``c*D + i``)."""
        # the stages' inputs at fixed addresses (as a captured step's stages
        # read them): views of ``det``, the channel ids built once, and
        # ``overflow`` merged only after the stages
        if det.index.ndim == 2:
            detf, chan = flatten_detections(det, self.channel_ids(*det.index.shape, det.index.device))
        else:
            detf, chan = det, None
        hdr, header_symbols = self.decode_headers(x, detf, chan)
        busy_end, keep = self.filter_detections(det, hdr, busy0)
        keep = keep.reshape(-1)
        res = self.decode_payloads(x, detf, hdr, keep, chan)
        detf.overflow = det.overflow.any()
        return Decoded(detf, hdr, header_symbols, res, keep, busy_end)

    def decode_bank(self, x: torch.Tensor, det: Detections):
        """Decode all channels' detections of a bank ``[C, N]`` as one flat
        batch (:meth:`decode`). Returns ``(det_flat, hdr, res, keep)``."""
        out = self.decode(x, det)
        return out.det, out.hdr, out.res, out.keep

    def channel_ids(self, c: int, d: int, device: torch.device) -> torch.Tensor:
        """Each row's channel in a flattened ``[C, D]`` batch, built once
        per ``(C, D, device)``: every caller gets the same tensor."""
        ids = self._chan_ids.get((c, d, device))
        if ids is None:
            ids = self._chan_ids[c, d, device] = torch.arange(c, device=device).repeat_interleave(d)
        return ids

    def bank_step(self, x: torch.Tensor, group: int = 16):
        """Acquire (batched over channels) and decode a bank ``[C, N]``.
        Returns ``(det_flat, hdr, res, keep)`` as :meth:`decode_bank`.

        With ``0 < group < C`` and ``C % group == 0`` the channels run in
        groups of ``group``, one after another, each a contiguous row slice
        of ``x``; otherwise (``group=0`` among them) as one batch. The rows
        come out in the same order either way.

        On a CUDA device the stages replay from CUDA graphs from the second
        step on the same ``x`` (its address, shape and strides) and
        ``group`` (``utils/graphs.py``); the results are the caller's
        own either way."""
        return self._step(x, group)

    def stream_step(self, x: torch.Tensor, busy: torch.Tensor):
        """The bank step of a continuous stream: ``x`` ``[C, front_pad +
        block + pad_tail()]`` is a sliding buffer whose fresh window
        ``[front_pad, front_pad + block)`` alone may start a packet (the
        ``front_pad`` samples before it are look-back, the ``pad_tail()``
        after it the lookahead that finishes a packet started in it), and
        ``busy`` int64 ``[C]`` the suppression state carried from the last
        step (:data:`IDLE_BUSY` where no packet is in flight). After the
        decode, ``busy`` is overwritten on the card with the state the next
        step takes, :func:`hand_on_busy` of this step's, for a buffer that
        slides by ``block`` samples; and the rows kept with a good header,
        and those of them of type IDLE, are added on the card to the
        counts :meth:`stream_rows` reads. The channels run as one batch.
        Returns ``(det_flat, hdr, res, keep)`` as :meth:`bank_step`, graphs
        as there: a graphed step needs ``busy`` at one address from step to
        step."""
        fp = self.front_pad
        block = x.shape[-1] - fp - self.pad_tail()
        if block < fp + self.pad_tail():
            raise ValueError(
                f"a sliding buffer of {x.shape[-1]} samples holds a block of {block}, less than the "
                f"{fp + self.pad_tail()} samples it keeps from step to step"
            )
        if busy.shape != x.shape[:1] or busy.dtype != torch.int64 or busy.device != x.device:
            raise ValueError(f"busy must be int64 [{x.shape[0]}] on {x.device}, got {busy.dtype} "
                             f"{tuple(busy.shape)} on {busy.device}")
        return self._step(x, 0, busy, block)

    def _step(self, x: torch.Tensor, group: int, busy=None, block: int = 0):
        """:meth:`bank_step`, or with ``busy`` the one batch of
        :meth:`stream_step`."""
        c = x.shape[0]
        carry = () if busy is None else (busy, block)
        next_step()
        with span("rx.step", x.device), self.step_graphs.step(x, group, *carry) as graphed:
            if not (0 < group < c and c % group == 0):
                if busy is None:
                    out = self.decode_bank(x, self.acquirer.acquire(x))
                else:
                    fp = self.front_pad
                    d = self.decode(x, self.acquirer.acquire(x, fresh_lo=fp, fresh_hi=fp + block), busy)
                    self.hand_on(d.busy_end, d.hdr.header_ok, d.hdr.packet_type, d.keep, busy, block)
                    out = d.det, d.hdr, d.res, d.keep
                # a graphed step's outputs are its graphs' own: copy them out
                return owned(out) if graphed else out
            return flatten_grouped_results([  # concatenates: new tensors
                self.decode_bank(g, self.acquirer.acquire(g)) for g in x.split(group)
            ])

    @stage
    def hand_on(
        self, busy_end: torch.Tensor, header_ok: torch.Tensor, packet_type: torch.Tensor,
        keep: torch.Tensor, busy: torch.Tensor, block: int,
    ) -> None:
        """The stream step's last stage, on the card: ``busy`` overwritten
        with :func:`hand_on_busy` of the scan's ``busy_end``, and the rows
        kept with a good header, and those of type IDLE among them, added
        to the buffer ``stream_counts``."""
        with span("rx.hand_on", busy.device):
            busy.copy_(hand_on_busy(busy_end, block))
            good = keep & header_ok
            idle = good & (packet_type == int(C.PacketType.IDLE))
            self.stream_counts.add_(torch.stack([good.sum(), idle.sum()]))

    def stream_rows(self) -> dict[str, int]:
        """The rows the stream steps kept with a good header
        (``"header_ok"``) and the IDLE rows among them (``"idle"``), added
        on the card by every step, a replayed one too (one synchronising
        read: not for a step's path)."""
        good, idle = self.stream_counts.tolist()
        return {"header_ok": good, "idle": idle}

    # -------------------------------------------- feed-forward carrier track

    def _vv_track(
        self, syms: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor
    ) -> torch.Tensor:
        """Scan-free payload carrier tracking: propagate the header-end loop
        state linearly, then refine with a block Viterbi&Viterbi 4th-power
        estimator (phase mod pi/2 per block, ambiguity resolved by
        continuity; cumulative unwrap across blocks), interpolated linearly
        between block centres."""
        blk = self.config.vv_block
        d, s = syms.shape
        nb = s // blk
        idx = torch.arange(s, device=syms.device, dtype=torch.float32)
        base_phase = phase0[:, None] + freq0[:, None] * idx[None, :]
        z = syms * torch.complex(torch.cos(base_phase), -torch.sin(base_phase))
        zb = z[:, : nb * blk].reshape(d, nb, blk)
        z2 = zb * zb
        m4 = (z2 * z2).mean(dim=-1)
        ph4 = torch.angle(m4)  # 4 * residual phase, wrapped
        d4 = torch.diff(ph4, dim=-1)
        d4 = torch.where(d4 > PI, d4 - TWO_PI, d4)
        d4 = torch.where(d4 < -PI, d4 + TWO_PI, d4)
        # QPSK points sit at 45 degrees, so angle(z^4) = pi + 4*residual;
        # the first block's pi/2 ambiguity wraps to [-pi/4, pi/4)
        resid0 = (ph4[:, :1] - PI) / 4.0
        quarter = float(np.float32(np.pi / 4))
        resid0 = torch.remainder(resid0 + quarter, float(np.float32(np.pi / 2))) - quarter
        resid = torch.cat([resid0, resid0 + torch.cumsum(d4 / 4.0, dim=-1)], dim=-1)
        frac = self.vv_frac
        resid_per_sym = resid[:, self.vv_b0] * (1.0 - frac) + resid[:, self.vv_b1] * frac
        return z * torch.complex(torch.cos(resid_per_sym), -torch.sin(resid_per_sym))

    # ----------------------------------------------------------- payload pass

    @stage
    def decode_payloads(
        self,
        x: torch.Tensor,
        det: Detections,
        hdr: HeaderResult,
        keep: torch.Tensor,
        chan: torch.Tensor | None = None,
    ) -> PayloadResult:
        cfg = self.config
        s_pay = cfg.max_payload_syms
        count("rx.payload.slot_symbols", det.index.numel() * s_pay)
        with span("rx.payload", x.device):
            with span("rx.payload.extract"):
                syms = self._extract_symbols(
                    x, hdr.n_base, hdr.arm, det.freq, det.index, hdr.amp_scale,
                    _HEADER_REGION_SYMS, s_pay, chan, "rx.payload.extract.chunk",
                )
            with span("rx.payload.carrier"):
                if cfg.payload_carrier == "vv":
                    corrected = self._vv_track(syms, hdr.phase, hdr.freq)
                else:
                    corrected, _, _ = costas_track(
                        syms, hdr.phase, hdr.freq, offset=_HEADER_REGION_SYMS,
                        active=det.valid,
                    )
            with span("rx.payload.crc"):
                plen = hdr.packet_length
                payload, crc, crc_rx = payload_crc(
                    corrected, self.llr_scale, self.ks_payload, plen,
                    self.crc_g_packed, self.crc_init_lut, self.crc_final_xor,
                )
                # suppressed or invalid slots hold garbage extractions and must not
                # report a coincidental CRC pass
                crc_ok = (crc == crc_rx) & keep
                accepted = (
                    keep
                    & hdr.header_ok
                    & crc_ok
                    & (hdr.packet_type == int(C.PacketType.USER_DATA))
                )
            if cfg.keep_payload_symbols:
                symbols = torch.view_as_real(corrected)
            else:
                symbols = corrected.new_zeros(corrected.shape[0], 0, 2, dtype=torch.float32)
        return PayloadResult(
            data=payload, lengths=plen, crc_ok=crc_ok, accepted=accepted,
            symbols=symbols,
        )

    # -------------------------------------------------------------- high level

    def pad(self, samples: np.ndarray | torch.Tensor) -> torch.Tensor:
        """``front_pad`` zeros + samples + ``pad_tail()`` zeros along the
        last axis (a capture ``[N]`` or a bank ``[C, N]``), as a complex64
        tensor on the receiver's device. ``samples`` is a numpy array, or a
        tensor on that device (padded there, with no trip through the
        host)."""
        dev = self.arm_taps.device
        if isinstance(samples, torch.Tensor):
            if samples.device != dev:
                raise ValueError(f"samples on {samples.device}, the receiver on {dev}")
            body = samples.to(torch.complex64)
        else:
            body = torch.from_numpy(np.asarray(samples, np.complex64)).to(dev)
        lead = body.shape[:-1]
        return torch.cat([
            body.new_zeros(*lead, self.front_pad), body, body.new_zeros(*lead, self.pad_tail()),
        ], dim=-1)

    def receive(self, samples: np.ndarray | torch.Tensor) -> PayloadResult:
        """One-shot receive over a full capture (numpy, or a complex tensor
        on the receiver's device): pad, acquire, then :meth:`decode`. Rows
        are aligned with the sorted detections; ``accepted`` marks decoded
        user packets."""
        x = self.pad(samples)
        next_step()
        return self.decode(x, self.acquirer.acquire(x)).res
