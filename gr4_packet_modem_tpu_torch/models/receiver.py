"""Batched packet receiver (port of ``gr4_packet_modem_tpu/models/
receiver.py``).

The receive chain runs as feed-forward passes over a sample buffer:

1. **acquire** (``ops/acquire.py``): overlap-save syncword correlation,
   CFAR peak detection and per-candidate estimates;
2. **header pass**: fetch each detection's region (K2), derotate, matched
   filter at the acquisition-selected polyphase arm (K3), wipe off the
   syncword, Costas loop (K4), LLRs, descramble, LDPC decode (K5), parse;
3. **suppression**: drop detections that start inside a packet already
   claimed, one short scan per channel;
4. **payload pass**: fetch, derotate, matched filter, carrier tracking
   (V&V block estimator, or the Costas loop), LLRs, descramble, slice,
   pack and CRC-32 check.

A bank ``[C, N]`` runs acquisition batched over channels and both decode
passes as one flat batch of all channels' detections; suppression stays
per channel. ``bank_step(x, group)`` runs the channels in groups of
``group`` one after another (the JAX package's rule and default, 16),
each group a contiguous row slice of the bank, and merges the groups' rows
back into the one-batch order: acquisition and suppression are per
channel, so every group size gives the same result. Groups bound the
working set; at the bench geometry (64 channels of 553,396 samples) one
batch fits the card's memory as well.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
from torch import nn

from ..utils import constants as C
from ..utils.firdes import rx_rrc_taps

from ..ops.acquire import AcquisitionConfig, Detections, SyncwordAcquirer
from ..ops.costas import PI, TWO_PI
from ..ops.costas_cuda import costas_track
from ..ops.crc import crc32_compute
from ..ops.fetch_cuda import fetch_regions
from ..ops.ldpc import HeaderLdpcDecoder, combine_repetition
from ..ops.matched_cuda import matched_filter
from ..ops.packing import binary_slice, pack_bits
from ..ops.scramble import descramble_soft, keystream_np
from .tables import receiver_tables, tables_from_numpy

__all__ = [
    "RxConfig", "Receiver", "HeaderResult", "PayloadResult",
    "packet_extent_samples", "suppress_overlapping", "flatten_detections",
    "flatten_grouped_results",
]

_HEADER_REGION_SYMS = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192


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


def flatten_detections(det: Detections) -> tuple[Detections, torch.Tensor]:
    """Per-channel detections ``[C, D]`` -> one ``[C*D]`` batch (channel-
    major rows) plus each row's channel id."""
    c, dd = det.index.shape
    chan = torch.arange(c, device=det.index.device).repeat_interleave(dd)
    overflow = det.overflow.any()
    detf = det.map(lambda a: a.reshape(-1))
    detf.overflow = overflow
    return detf, chan


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
    # symbol taps of StreamingReceiver, packet_receiver.hpp:159-189)
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
    ``models/tables.py``)."""

    def __init__(self, config: RxConfig, device: str | torch.device):
        super().__init__()
        self.config = config
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
        self.filter_delay = rx_rrc_taps(sps)[0].size - 1  # 44
        tables = receiver_tables(sps, config.num_pfb_arms, config.max_payload_len)
        for name, value in tables_from_numpy(tables).items():
            self.register_buffer(name, value.to(device))
        self.arm_len = self.arm_taps.shape[1]
        self.header_decoder = HeaderLdpcDecoder(config.ldpc_iterations, device=device)
        self._derive_tables()
        s_pay = config.max_payload_syms
        ks = keystream_np(C.HEADER_LLRS + 2 * s_pay).astype(bool)
        self.register_buffer(
            "ks_header", torch.tensor(ks[: C.HEADER_LLRS], device=device),
            persistent=False,
        )
        self.register_buffer(
            "ks_payload", torch.tensor(ks[C.HEADER_LLRS :], device=device),
            persistent=False,
        )

    def _derive_tables(self) -> None:
        """Tables computed from the carried ones: the acquirer's, the header
        decoder's and the V&V interpolation tables."""
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
        extractions run in ``symbol_chunk``-symbol chunks to bound the
        ``[D, region]`` intermediates, each one K2 and one K3 launch."""
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
    ) -> torch.Tensor:
        """Matched-filter ``num_syms`` symbols from symbol ``sym_offset`` of
        each detection: region fetch (K2), coarse derotation by
        ``exp(-i freq (n - n0))``, polyphase-arm filtering (K3) and
        amplitude normalisation, chunked over symbols. ``x`` is ``[N]``, or
        a bank ``[C, N]`` with ``chan`` giving each detection's channel
        (regions then address the flattened bank; indices stay channel-
        local)."""
        cfg = self.config
        sps = cfg.samples_per_symbol
        kk = self.arm_len
        taps = self.arm_taps[arm].flip(1).contiguous()  # [D, K] time-reversed
        chunk, nchunks = self._extraction_chunks(num_syms)
        row_len = x.shape[-1]
        xf = x.reshape(-1)
        region_len = sps * (chunk - 1) + kk
        j = torch.arange(region_len, device=x.device)
        out = []
        for c in range(nchunks):
            start = n_base + sps * (sym_offset + c * chunk) - (kk - 1)
            start = torch.clamp(start, 0, row_len - region_len)
            fetch_start = start if chan is None else start + chan * row_len
            rr, ri = fetch_regions(xf, fetch_start, region_len)
            ph = -freq[:, None] * (start[:, None] + j - n0[:, None]).to(torch.float32)
            cph, sph = torch.cos(ph), torch.sin(ph)
            dr = rr * cph - ri * sph
            di = rr * sph + ri * cph
            outr, outi = matched_filter(dr, di, taps, sps, chunk)
            out.append(torch.complex(outr, outi) * amp_scale[:, None])
        return torch.cat(out, dim=1)[:, :num_syms].contiguous()

    # ------------------------------------------------------------ header pass

    def decode_headers(
        self, x: torch.Tensor, det: Detections, chan: torch.Tensor | None = None
    ) -> tuple[HeaderResult, torch.Tensor]:
        """Decode the header of every detection. ``x`` carries ``front_pad``
        zeros in front (indices are relative to ``x``). Returns
        ``(HeaderResult, corrected sync+header symbols [D, 192])``."""
        arm, n_base, phase0 = self._timing(det)
        amp_scale = 1.0 / torch.clamp(det.amplitude, min=1e-9)
        syms = self._extract_symbols(
            x, n_base, arm, det.freq, det.index, amp_scale, 0,
            _HEADER_REGION_SYMS, chan,
        )
        # wipe off the syncword modulation -> pure pilot
        syms[:, : C.SYNCWORD_LEN] *= self.sync_bipolar
        corrected, ph_end, fr_end = costas_track(
            syms, phase0.contiguous(), torch.zeros_like(phase0), offset=0
        )
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

    def filter_detections(self, det: Detections, hdr: HeaderResult) -> torch.Tensor:
        """Suppress detections that start inside an earlier kept packet's
        extent. ``det``/``hdr`` rows are ``[D]`` or ``[C, D]``."""
        extent = packet_extent_samples(
            hdr.packet_length.reshape(det.index.shape),
            hdr.header_ok.reshape(det.index.shape),
            self.config.samples_per_symbol,
        )
        busy0 = torch.full(det.index.shape[:-1], -1, device=det.index.device)
        _, keep = suppress_overlapping(det.index, det.valid, extent, busy0)
        return keep

    # ------------------------------------------------------------ bank decode

    def decode_bank(self, x: torch.Tensor, det: Detections, upto: str = "full"):
        """Decode all channels' detections as one flat batch.

        ``x``: ``[C, N]`` complex64; ``det``: per-channel detections
        ``[C, D]``. Returns ``(det_flat, hdr, res, keep)`` with rows
        flattened channel-major (row ``c*D + i``). ``upto`` stops early for
        stage timing: "headers" -> ``(det_flat, hdr)``, "filter" ->
        ``(det_flat, hdr, keep)``."""
        detf, chan = flatten_detections(det)
        hdr, _ = self.decode_headers(x, detf, chan)
        if upto == "headers":
            return detf, hdr
        keep = self.filter_detections(det, hdr).reshape(-1)
        if upto == "filter":
            return detf, hdr, keep
        res = self.decode_payloads(x, detf, hdr, keep, chan)
        return detf, hdr, res, keep

    def bank_step(self, x: torch.Tensor, group: int = 16):
        """Acquire (batched over channels) and decode a bank ``[C, N]``.
        Returns ``(det_flat, hdr, res, keep)`` as :meth:`decode_bank`.

        With ``0 < group < C`` and ``C % group == 0`` the channels run in
        groups of ``group``, one after another, each a contiguous row slice
        of ``x``; otherwise (``group=0`` among them) as one batch. The rows
        come out in the same order either way."""
        c = x.shape[0]
        if not (0 < group < c and c % group == 0):
            return self.decode_bank(x, self.acquirer.acquire(x))
        return flatten_grouped_results([
            self.decode_bank(g, self.acquirer.acquire(g)) for g in x.split(group)
        ])

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
        syms = self._extract_symbols(
            x, hdr.n_base, hdr.arm, det.freq, det.index, hdr.amp_scale,
            _HEADER_REGION_SYMS, s_pay, chan,
        )
        if cfg.payload_carrier == "vv":
            corrected = self._vv_track(syms, hdr.phase, hdr.freq)
        else:
            corrected, _, _ = costas_track(
                syms, hdr.phase, hdr.freq, offset=_HEADER_REGION_SYMS
            )
        llrs = torch.view_as_real(corrected).reshape(
            corrected.shape[0], -1
        ) * self.llr_scale  # [D, 2*s_pay]
        bits = binary_slice(descramble_soft(llrs, self.ks_payload))  # invert=true slicer
        all_bytes = pack_bits(bits, 8).to(torch.uint8)  # [D, s_pay/4]
        plen = hdr.packet_length
        pos = torch.arange(cfg.max_payload_len, device=x.device)
        payload = torch.where(
            pos[None, :] < plen[:, None], all_bytes[:, : cfg.max_payload_len], 0
        )
        crc = crc32_compute(
            payload, torch.clamp(plen, 0, cfg.max_payload_len),
            self.crc_g_packed, self.crc_init_lut, self.crc_final_xor,
        )
        # received CRC: the 4 bytes at plen..plen+4, big-endian
        plen_c = torch.clamp(plen, 0, all_bytes.shape[1] - C.CRC_NUM_BYTES)
        at = plen_c[:, None] + torch.arange(C.CRC_NUM_BYTES, device=x.device)
        rx_bytes = all_bytes.gather(1, at).to(torch.int64)
        crc_rx = (
            rx_bytes[:, 0] << 24 | rx_bytes[:, 1] << 16 | rx_bytes[:, 2] << 8
            | rx_bytes[:, 3]
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
        on the receiver's device): pad, acquire, decode headers, suppress
        overlapping detections, decode payloads. Rows are aligned with the
        sorted detections; ``accepted`` marks decoded user packets."""
        x = self.pad(samples)
        det = self.acquirer.acquire(x)
        hdr, _ = self.decode_headers(x, det)
        keep = self.filter_detections(det, hdr)
        return self.decode_payloads(x, det, hdr, keep)
