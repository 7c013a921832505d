"""Streaming drivers: block-wise receive and transmit with carried state.

Port of ``StreamingReceiver``, ``StreamingBank``, ``PacketToStream`` and
``StreamingTransmitter`` of ``gr4_packet_modem_tpu/runtime/streaming.py``.
A host loop feeds fixed-size
sample blocks through the receiver over a sliding device buffer of
``front_pad + block + pad_tail`` samples per channel, so packets crossing a
block boundary decode exactly once: only syncword starts in the buffer's
fresh block ``[front_pad, front_pad + block)`` compete for detection slots,
and the in-packet suppression state (busy-until) is carried across blocks on
the device, pre-shifted into the next block's coordinates.

Each block is one host-to-device transfer of ``[2, C, block]`` wire planes
(float32, bfloat16, int8 or packed int4; ``utils/cplx.py``) and one
device-to-host transfer of a packed byte array of results
(:func:`pack_result_wire`). On a CUDA device both go through pinned host
buffers with ``non_blocking`` copies on the current stream, each ring
``pipeline_depth + 1`` deep and guarded by CUDA events, so a buffer is never
refilled while its copy is in flight. :meth:`process` waits on the device
only to materialise the block ``pipeline_depth`` behind the newest one.

The sliding buffer is two device buffers in ping-pong: each step writes the
shifted old buffer and the new block into the other one (an in-place
overlapping shift is not safe).

``StreamingReceiver(header_tap=, payload_tap=)`` publishes the corrected
header and payload symbols of every accepted packet to sinks with a
``send(np.ndarray)`` method (``io/zmq_pub.py``), the monitoring taps of
packet_receiver.hpp:159-189; the symbols cross to the host only when a tap
is set.

On the transmit side, ``StreamingTransmitter`` carries the GLFSR packet
index and the stream-mode FIR history across calls, and ``PacketToStream``
turns bursts into a constant-rate stream on the host.

Not ported yet: ``StreamingShardedBank`` (multi-GPU).
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..models.receiver import (
    Receiver,
    RxConfig,
    flatten_detections,
    packet_extent_samples,
    suppress_overlapping,
)
from ..models.transmitter import Transmitter
from ..ops.fir import stream_interpolating_fir
from ..utils import constants as C
from ..utils.cplx import planes_to_complex, to_transfer_planes, wire_dtype
from ..utils.ragged import PacketBatch, ragged_concat

__all__ = [
    "StreamingReceiver", "StreamingBank", "StreamingTransmitter", "PacketToStream",
    "DecodedPacket", "pack_result_wire", "unpack_result_wire", "wire_slots", "wire_bytes",
]

_WIRE_META_FIELDS = 9
_IDLE_BUSY = -(1 << 30)  # busy-until of a channel with no packet in flight


@dataclass
class DecodedPacket:
    data: np.ndarray
    index: int            # absolute sample index of the syncword start
    packet_type: int
    esn0_db: float
    channel: int = 0      # bank channel (StreamingBank)
    freq: float = 0.0     # carrier frequency estimate (rad/sample)
    arm: int = 0          # polyphase matched-filter arm (symbol timing)


def pack_result_wire(
    idx, lens, types, esn0, freq, arm, chan, accepted, data,
    det_overflow, budget: int | None,
) -> torch.Tensor:
    """Pack per-row decode results into ONE flat uint8 tensor, so a block's
    results cross to the host in one transfer.

    With ``budget`` set, rows are compacted on the device to the first
    ``budget`` accepted rows (stable row order, so each channel's index
    order is kept): the reference ships only decoded packets
    (tun_sink.hpp:33-37), while an uncompacted wire ships ``rows x
    max_payload_len`` bytes of mostly unused slots. Accepted rows beyond the
    budget are flagged (second flag), not silently dropped.

    Layout: 9 float32 metadata rows of one value per slot (index, length,
    type, esn0, freq, arm, channel, accepted, source row), 2 float32 flags
    (detection overflow, budget overflow), then the payload bytes
    ``[slots, max_payload_len]``. Indices are buffer-local: float32 holds
    them exactly below 2**24 (the streaming classes check their buffer
    length)."""
    rows = idx.shape[0]
    k = wire_slots(rows, budget)
    row_ids = torch.arange(rows, device=idx.device)
    budget_ovf = accepted.sum() > k
    cols = (idx, lens, types, esn0, freq, arm, chan, accepted, row_ids)
    if k < rows:
        # stable argsort: accepted rows first, original order preserved
        sel = torch.argsort((~accepted).to(torch.uint8), stable=True)[:k]
        cols = tuple(a[sel] for a in cols)
        data = data[sel]
    meta = torch.cat([a.to(torch.float32) for a in cols] + [
        det_overflow.to(torch.float32).reshape(1), budget_ovf.to(torch.float32).reshape(1),
    ])
    return torch.cat([meta.view(torch.uint8), data.reshape(-1)])


def wire_slots(rows: int, budget: int | None) -> int:
    """Number of result slots on the wire for ``rows`` decode rows."""
    return rows if budget is None else min(int(budget), rows)


def wire_bytes(rows: int, budget: int | None, max_len: int) -> int:
    k = wire_slots(rows, budget)
    return 4 * (_WIRE_META_FIELDS * k + 2) + k * max_len


def unpack_result_wire(packed: np.ndarray, k: int, max_len: int):
    """Host-side inverse of :func:`pack_result_wire`.

    Returns ``(slots, det_overflow, budget_overflow)`` where ``slots`` is a
    dict of per-slot arrays (``index/length/type/esn0/freq/arm/channel/
    accepted/row/data``)."""
    meta_bytes = 4 * (_WIRE_META_FIELDS * k + 2)
    meta = packed[:meta_bytes].view(np.float32)
    data = packed[meta_bytes:].reshape(k, max_len)

    def f(i):
        return meta[i * k : (i + 1) * k]

    slots = {
        "index": f(0).astype(np.int64),
        "length": f(1).astype(np.int64),
        "type": f(2).astype(np.int64),
        "esn0": f(3),
        "freq": f(4),
        "arm": f(5).astype(np.int64),
        "channel": f(6).astype(np.int64),
        "accepted": f(7) > 0.5,
        "row": f(8).astype(np.int64),
        "data": data,
    }
    flags = meta[_WIRE_META_FIELDS * k :]
    return slots, flags[0] > 0.5, flags[1] > 0.5


def _flag_overflows(driver, det_ovf: bool, budget_ovf: bool) -> None:
    """Count, and warn once for, the two per-block saturation flags."""
    if det_ovf:
        driver.overflow_blocks += 1
        if driver.overflow_blocks == 1:
            warnings.warn(
                "acquisition candidate cap saturated (max_detections = "
                f"{driver.rx.config.max_detections}); packets may be "
                "dropped — raise RxConfig.max_detections",
                RuntimeWarning,
                stacklevel=4,
            )
    if budget_ovf:
        driver.budget_overflow_blocks += 1
        if driver.budget_overflow_blocks == 1:
            warnings.warn(
                "result-wire budget saturated (result_budget = "
                f"{driver.result_budget}); packets were dropped from the "
                "wire — raise result_budget",
                RuntimeWarning,
                stacklevel=4,
            )


_rx_logger = logging.getLogger("gr4_packet_modem_tpu_torch.rx")


def _log_packet(p: DecodedPacket) -> None:
    """Per-packet RX debug line (PayloadMetadataInsert{log:true} /
    header_debug, payload_metadata_insert.hpp:66,
    packet_receiver.hpp:151-157)."""
    _rx_logger.info(
        "packet ch=%d index=%d len=%d type=%d esn0=%.1fdB freq=%+.5f arm=%d",
        p.channel, p.index, len(p.data), p.packet_type, p.esn0_db, p.freq,
        p.arm,
    )


class StreamingBank:
    """Host-fed multi-channel streaming receiver: the serving path for a
    whole channel bank on one card.

    ``C`` channels stream through one step per block: one ``[2, C, block]``
    wire transfer in, per-channel sliding buffers and suppression state on
    the device, the decode passes batched over all channels' detections
    (``Receiver.decode_bank`` layout), one packed result array out.
    ``group`` (a divisor of ``channels`` below it; otherwise the whole bank
    is one group) runs the channels group by group to bound the working
    set. Results materialise ``pipeline_depth`` blocks behind the feed, so
    the device-to-host copy overlaps later blocks. ``result_budget`` caps
    the result slots per block (:func:`pack_result_wire`); ``log`` logs one
    line per packet.
    """

    header_tap = None  # symbol sinks (StreamingReceiver)
    payload_tap = None

    def __init__(
        self,
        config: RxConfig,
        device: str | torch.device,
        channels: int = 8,
        block: int = 1 << 18,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        group: int = 16,
        result_budget: int | None = None,
        log: bool = False,
    ):
        self.device = torch.device(device)
        self.transfer_dtype = transfer_dtype
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.result_budget = result_budget
        self.log = log
        self.rx = Receiver(config, self.device)
        self.channels = int(channels)
        self.block = int(block)
        self.group = group if 0 < group < channels and channels % group == 0 else 0
        fp, pt = self.rx.front_pad, self.rx.pad_tail()
        self.fp, self.pt = fp, pt
        self.buf_len = fp + block + pt
        if self.buf_len >= 1 << 24:
            raise ValueError(
                "block too large: buffer-local indices must stay below 2^24 "
                "for the float32 result wire"
            )
        c, dev = self.channels, self.device
        self._bufs = [torch.zeros(c, self.buf_len, dtype=torch.complex64, device=dev) for _ in range(2)]
        self._cur = 0
        # absolute stream index of buffer position 0; the first real sample
        # lands at buffer position fp + pt after the first block
        self._abs_offset = -(fp + pt + block)
        self._busy = torch.full((c,), _IDLE_BUSY, dtype=torch.int64, device=dev)
        self._fill = 0  # samples of the next block already staged
        self._carry = np.zeros((c, 0), np.complex64)  # int4: an unpaired sample
        self.overflow_blocks = 0  # blocks whose acquisition saturated
        self.budget_overflow_blocks = 0  # blocks whose result wire saturated
        self.stats = {"h2d_s": 0.0, "dispatch_s": 0.0, "materialize_s": 0.0, "blocks": 0}
        # host rings (pinned on a CUDA device), one slot more than the
        # blocks in flight; a slot's event marks its last copy done. The
        # samples are converted straight into the staging slots, so the
        # host copies each sample once
        cuda = dev.type == "cuda"
        ring = self.pipeline_depth + 1
        wd = wire_dtype(transfer_dtype)
        if wd == torch.uint8 and block % 2:
            raise ValueError("the int4 wire packs sample pairs: block must be even")
        width = block // 2 if wd == torch.uint8 else block
        self._stage = [torch.empty(2, c, width, dtype=wd, pin_memory=cuda) for _ in range(ring)]
        self._stage_np = [(s.view(torch.int16) if wd == torch.bfloat16 else s).numpy() for s in self._stage]
        self._stage_done: list[torch.cuda.Event | None] = [None] * ring
        self._rows = c * config.max_detections
        nbytes = wire_bytes(self._rows, result_budget, config.max_payload_len)
        self._wire = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda) for _ in range(ring)]
        self._inflight: list[tuple[int, torch.cuda.Event | None, int]] = []

    # ------------------------------------------------------------------ step

    def _decode_group(self, buf: torch.Tensor, busy0: torch.Tensor):
        """Acquire over the fresh window and decode one channel group
        ``buf`` ``[G, buf_len]`` with suppression state ``busy0`` ``[G]``."""
        rx = self.rx
        dd = rx.config.max_detections
        det = rx.acquirer.acquire(buf, fresh_lo=self.fp, fresh_hi=self.fp + self.block)
        detf, chan = flatten_detections(det)
        hdr, hdr_syms = rx.decode_headers(buf, detf, chan)
        extent = packet_extent_samples(
            hdr.packet_length, hdr.header_ok, rx.config.samples_per_symbol
        )
        busy_end, keep = suppress_overlapping(
            det.index, det.valid, extent.view(-1, dd), busy0
        )
        res = rx.decode_payloads(buf, detf, hdr, keep.reshape(-1), chan)
        out = (
            detf.index, res.lengths, hdr.packet_type, detf.esn0_db, detf.freq,
            hdr.arm, res.accepted, res.data, detf.overflow, busy_end,
        )
        return out + ((hdr_syms, res.symbols) if self._with_syms else ())

    @property
    def _with_syms(self) -> bool:
        return self.header_tap is not None or self.payload_tap is not None

    def _step(self, planes: torch.Tensor):
        """Slide the buffer by one block of wire planes ``[2, C, ...]``,
        decode, carry the suppression state; returns the packed results and,
        when a tap is set, the rows' header symbols ``[rows, 192]`` and
        payload symbol planes ``[rows, S, 2]`` (else None)."""
        chunk = planes_to_complex(planes, packed_int4=self.transfer_dtype == "int4")
        b = self.block
        src, buf = self._bufs[self._cur], self._bufs[1 - self._cur]
        buf[:, :-b].copy_(src[:, b:])
        buf[:, -b:].copy_(chunk)
        self._cur = 1 - self._cur
        g = self.group or self.channels
        outs = [
            self._decode_group(buf[i : i + g], self._busy[i : i + g])
            for i in range(0, self.channels, g)
        ]
        merged = [torch.stack(o) if o[0].ndim == 0 else torch.cat(o) for o in zip(*outs)]
        idx, lens, types, esn0, freq, arm, acc, data, ovf, busy_end = merged[:10]
        # busy state pre-shifted into the next block's coordinates
        self._busy = (busy_end - b).clamp(min=_IDLE_BUSY)
        chan = torch.arange(idx.shape[0], device=idx.device) // self.rx.config.max_detections
        packed = pack_result_wire(
            idx, lens, types, esn0, freq, arm, chan, acc, data, ovf.any(),
            self.result_budget,
        )
        return packed, (tuple(merged[10:]) or None)

    # ------------------------------------------------------------------ feed

    def process(self, samples: np.ndarray) -> list[DecodedPacket]:
        """Feed ``[C, n]`` samples (all channels advance in lockstep);
        returns the packets of blocks materialised meanwhile."""
        x = np.asarray(samples, np.complex64)
        if x.ndim != 2 or x.shape[0] != self.channels:
            raise ValueError(f"expected [{self.channels}, n] samples, got {x.shape}")
        return self._feed(x)

    def _feed(self, x: np.ndarray) -> list[DecodedPacket]:
        """Convert ``x`` ``[C, n]`` straight into the staging slots, block
        by block, and push each slot once it holds a whole block. On the
        int4 wire, samples pack in pairs: an odd sample waits in a carry
        for its partner."""
        out: list[DecodedPacket] = []
        pos, n = 0, x.shape[1]
        if self._carry.shape[1] and n:
            out.extend(self._fill_slot(np.concatenate([self._carry, x[:, :1]], axis=1)))
            self._carry, pos = self._carry[:, :0], 1
        if self.transfer_dtype == "int4" and (n - pos) % 2:
            n -= 1
            self._carry = x[:, n:].copy()
        while pos < n:
            w = min(self.block - self._fill, n - pos)
            out.extend(self._fill_slot(x[:, pos : pos + w]))
            pos += w
        return out

    def _fill_slot(self, piece: np.ndarray) -> list[DecodedPacket]:
        """Write ``piece`` (at most the rest of the block) into the current
        staging slot; push the slot when the block is whole."""
        t0 = time.perf_counter()
        i = self.stats["blocks"] % len(self._stage)
        if self._fill == 0 and self._stage_done[i] is not None:
            self._stage_done[i].synchronize()  # its last h2d copy is done
        f, w = self._fill, piece.shape[1]
        cols = slice(f // 2, (f + w) // 2) if self.transfer_dtype == "int4" else slice(f, f + w)
        to_transfer_planes(piece, self.transfer_dtype, out=self._stage_np[i][:, :, cols])
        self._fill += w
        self.stats["h2d_s"] += time.perf_counter() - t0
        if self._fill < self.block:
            return []
        self._fill = 0
        return self._push(i)

    def _push(self, i: int) -> list[DecodedPacket]:
        """One whole block in staging slot ``i``: copy it to the device,
        dispatch the step, start the results' copy back, and materialise
        the blocks more than ``pipeline_depth`` behind."""
        t0 = time.perf_counter()
        planes = self._stage[i].to(self.device, non_blocking=True)
        self._stage_done[i] = self._record()
        self.stats["h2d_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._abs_offset += self.block
        packed, syms = self._step(planes)
        self._wire[i].copy_(packed, non_blocking=True)
        self._inflight.append((i, self._record(), self._abs_offset, syms))
        self.stats["dispatch_s"] += time.perf_counter() - t0
        self.stats["blocks"] += 1
        out: list[DecodedPacket] = []
        while len(self._inflight) > self.pipeline_depth:
            out.extend(self._materialize(self._inflight.pop(0)))
        return out

    def _record(self) -> torch.cuda.Event | None:
        """An event after the work queued so far (on a CUDA device)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def flush(self) -> list[DecodedPacket]:
        """Drain the pipeline: pad the buffered tail to a full block, then
        feed enough zero blocks that every real sample passes through the
        fresh window with full lookahead. (The fresh window lags the newest
        ``pad_tail`` samples by design, so even input that ends on a block
        boundary needs one more block.) Finally materialise every block in
        flight."""
        c = self.channels
        out: list[DecodedPacket] = []
        pending = self._fill + self._carry.shape[1]
        if pending:
            out.extend(self._feed(np.zeros((c, self.block - pending), np.complex64)))
        nz = -(-self.pt // self.block)
        out.extend(self._feed(np.zeros((c, nz * self.block), np.complex64)))
        out.extend(self._drain())
        return out

    def _drain(self) -> list[DecodedPacket]:
        out: list[DecodedPacket] = []
        while self._inflight:
            out.extend(self._materialize(self._inflight.pop(0)))
        return out

    def _materialize(self, inflight) -> list[DecodedPacket]:
        t0 = time.perf_counter()
        i, done, abs_offset, syms = inflight
        if done is not None:
            done.synchronize()
        k = wire_slots(self._rows, self.result_budget)
        slots, det_ovf, budget_ovf = unpack_result_wire(
            self._wire[i].numpy(), k, self.rx.config.max_payload_len
        )
        _flag_overflows(self, det_ovf, budget_ovf)
        out = []
        for r in np.nonzero(slots["accepted"])[0]:
            n = int(slots["length"][r])
            out.append(
                DecodedPacket(
                    data=slots["data"][r, :n].copy(),
                    index=int(slots["index"][r]) + abs_offset,
                    packet_type=int(slots["type"][r]),
                    esn0_db=float(slots["esn0"][r]),
                    channel=int(slots["channel"][r]),
                    freq=float(slots["freq"][r]),
                    arm=int(slots["arm"][r]),
                )
            )
            if self.log:
                _log_packet(out[-1])
        if out and syms is not None:
            self._send_taps(slots, syms)
        self.stats["materialize_s"] += time.perf_counter() - t0
        return out

    def _send_taps(self, slots: dict, syms: tuple[torch.Tensor, torch.Tensor]) -> None:
        """For each accepted slot, in order: the 128 header symbols after
        the syncword to ``header_tap``, then the first ``4*(len+4)`` payload
        symbols to ``payload_tap``, complex64, taken from the slot's
        pre-compaction decode row."""
        hs = syms[0].cpu().numpy() if self.header_tap is not None else None
        ps = syms[1].cpu().numpy() if self.payload_tap is not None else None
        for i in np.nonzero(slots["accepted"])[0]:
            r = int(slots["row"][i])
            if hs is not None:
                self.header_tap.send(hs[r, C.SYNCWORD_LEN :].copy())
            if ps is not None:
                n_syms = 4 * (int(slots["length"][i]) + C.CRC_NUM_BYTES)
                self.payload_tap.send(ps[r, :n_syms].copy().view(np.complex64)[:, 0])


class StreamingReceiver(StreamingBank):
    """Block-streaming wrapper around the receiver for one channel: a
    :class:`StreamingBank` of one channel that takes ``[n]`` samples.

    ``header_tap`` and ``payload_tap`` are sinks with a
    ``send(np.ndarray)`` method (e.g. ``io.zmq_pub.ZmqPduPubSink``); each
    accepted packet sends its corrected header and payload symbols there.
    A payload tap turns ``keep_payload_symbols`` on."""

    def __init__(
        self,
        config: RxConfig,
        device: str | torch.device,
        block: int = 1 << 18,
        header_tap=None,
        payload_tap=None,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        result_budget: int | None = None,
        log: bool = False,
    ):
        self.header_tap, self.payload_tap = header_tap, payload_tap
        if payload_tap is not None and not config.keep_payload_symbols:
            config = dataclasses.replace(config, keep_payload_symbols=True)
        super().__init__(
            config, device, channels=1, block=block, transfer_dtype=transfer_dtype,
            pipeline_depth=pipeline_depth, group=0, result_budget=result_budget,
            log=log,
        )

    def process(self, samples: np.ndarray) -> list[DecodedPacket]:
        """Feed ``[n]`` samples; returns the packets of blocks materialised
        meanwhile."""
        x = np.asarray(samples, np.complex64)
        if x.ndim != 1:
            raise ValueError(f"expected [n] samples, got {x.shape}")
        return self._feed(x[None])


class PacketToStream:
    """Burst -> continuous-stream converter with zero fill when starved
    (packet_to_stream.hpp:17-45), on the host: ``pull(n)`` always returns
    exactly ``n`` samples for a constant-rate DAC. Queued bursts are
    emitted back to back; when the queue runs dry *between* packets the
    output is zero-filled, but zeros are never inserted mid-packet.
    ``on_packet`` mirrors the optional ``count`` port (one call per burst
    that starts crossing, with the running total)."""

    def __init__(self, on_packet=None):
        self._queue: list[np.ndarray] = []
        self._current: np.ndarray | None = None
        self._pos = 0
        self._packet_count = 0
        self.on_packet = on_packet
        self.zeros_inserted = 0

    def push(self, burst: np.ndarray) -> None:
        """Enqueue one finished burst (one packet's samples)."""
        b = np.asarray(burst, np.complex64)
        if b.size:
            self._queue.append(b)

    @property
    def pending(self) -> int:
        """Samples queued, the unfinished current packet included."""
        n = sum(b.size for b in self._queue)
        if self._current is not None:
            n += self._current.size - self._pos
        return n

    def pull(self, n: int) -> np.ndarray:
        """Exactly ``n`` samples: packet data while available, zeros
        between packets when starved."""
        out = np.zeros(n, np.complex64)
        filled = 0
        while filled < n:
            if self._current is None:
                if not self._queue:
                    self.zeros_inserted += n - filled
                    break
                self._current = self._queue.pop(0)
                self._pos = 0
                self._packet_count += 1
                if self.on_packet is not None:
                    self.on_packet(self._packet_count)
            take = min(n - filled, self._current.size - self._pos)
            out[filled : filled + take] = self._current[self._pos : self._pos + take]
            self._pos += take
            filled += take
            if self._pos == self._current.size:
                self._current = None
        return out


class StreamingTransmitter:
    """Host driver around a :class:`Transmitter` that carries the GLFSR
    packet index and the stream-mode FIR history across calls.

    ``burst``, ``stream`` and ``flush`` return the samples as a complex64
    tensor on the transmitter's device (the transceiver's route: nothing
    crosses to the host); ``send_burst``, ``send_stream`` and
    ``flush_stream`` return the same samples as numpy, as the JAX driver
    does. Sample counts come from the payload lengths on the host, so no
    call waits on the device for them."""

    def __init__(self, tx: Transmitter):
        self.tx = tx
        self._packet_index = 0
        self._fir_carry: torch.Tensor | None = None

    def _batch(self, payloads, types) -> PacketBatch:
        return PacketBatch.from_list(
            payloads, self.tx.config.max_payload_len, self.tx.taps.device, types=types
        )

    def burst(self, payloads, types=None) -> torch.Tensor:
        """Modulate payloads as back-to-back bursts."""
        samples, lens = self.tx.modulate_bursts(
            self._batch(payloads, types), packet_index0=self._packet_index
        )
        self._packet_index += len(payloads)
        n = self.tx.config.samples_per_symbol * sum(C.burst_symbols(len(p)) for p in payloads)
        return ragged_concat(samples, lens, n)[0]

    def stream(self, payloads, types=None) -> torch.Tensor:
        """Modulate payloads in stream mode (continuous FIR state)."""
        out_syms = sum(C.stream_symbols(len(p)) for p in payloads)
        self._fir_carry, samples, _ = self.tx.modulate_stream(
            self._batch(payloads, types), out_syms, self._fir_carry
        )
        return samples

    def flush(self) -> torch.Tensor:
        """Flush the stream-mode FIR history with zero symbols and return
        the tail samples; resets the carry for a fresh stream. A finite
        stream needs it: the carry holds the last ``arm_len - 1`` symbols'
        contribution, without which the final packet's last samples never
        leave the filter (the reference's burst chain appends zero flush
        symbols for the same reason, packet_transmitter_pdu.hpp:251-259)."""
        dev = self.tx.taps.device
        if self._fir_carry is None:
            return torch.zeros(0, dtype=torch.complex64, device=dev)
        zeros = torch.zeros(self.tx.arm_len - 1, dtype=torch.complex64, device=dev)
        _, samples = stream_interpolating_fir(
            self._fir_carry, zeros, self.tx.taps, self.tx.config.samples_per_symbol
        )
        self._fir_carry = None
        return samples

    def send_burst(self, payloads, types=None) -> np.ndarray:
        return self.burst(payloads, types).cpu().numpy()

    def send_stream(self, payloads, types=None) -> np.ndarray:
        return self.stream(payloads, types).cpu().numpy()

    def flush_stream(self) -> np.ndarray:
        return self.flush().cpu().numpy()
