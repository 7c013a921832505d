"""Block inventory registry: reference block -> the port's equivalent.

Port of ``gr4_packet_modem_tpu/registry.py``: the same keys, kinds and
reference headers, each ``target`` the PyTorch port's counterpart and
``resolve()`` importing from ``gr4_packet_modem_tpu_torch``. Where a
counterpart launches one of the port's hand-written CUDA kernels on CUDA
tensors, the note names it:

- K1 ``csrc/correlate.cu``: fused syncword correlation (acquisition), and
  its bf16 form ``csrc/correlate_bf16.cu`` (the ``fused_bf16`` backend);
- K2 and K2b ``csrc/fetch.cu``: region fetch (symbol extraction) and row
  fetch (acquisition estimates);
- K3 ``csrc/matched.cu``: polyphase matched filter;
- K4 ``csrc/costas.cu``: the Costas loop;
- K5 ``csrc/ldpc.cu``: header LDPC belief propagation.

On CPU tensors the same counterparts run their plain PyTorch versions.

The reference exposes its ~70 blocks through a string-keyed BlockRegistry
to Python (python/bindings/python_bindings.cpp:250-320). The registry is
both a parity map (every block of the reference inventory with its
equivalent: a function or class, a config knob of a composite, or a
structural subsumption) and a string factory: ``resolve(name)`` returns the
implementing callable or class, like the reference's
``fg.emplaceBlock('gr::packet_modem::Mapper', ...)``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BLOCK_REGISTRY", "resolve", "coverage"]


@dataclass(frozen=True)
class BlockEntry:
    """One reference block and its equivalent in the port."""

    reference: str          # reference header (blocks/include/.../*.hpp)
    kind: str               # "op" | "model" | "runtime" | "io" | "subsumed"
    target: str             # dotted path or description of the equivalent
    note: str = ""


_E = BlockEntry

BLOCK_REGISTRY: dict[str, BlockEntry] = {
    # ----------------------------------------------------------- TX chain
    "PacketIngress": _E("packet_ingress.hpp", "model",
        "models.transmitter.Transmitter._frame_symbols",
        "length validation + header metadata emission are the batch header "
        "build; oversized packets are rejected at PacketBatch construction"),
    "HeaderFormatter": _E("header_formatter.hpp", "op",
        "utils.constants.format_header",
        "batched form inside Transmitter._frame_symbols"),
    "HeaderFecEncoder": _E("header_fec_encoder.hpp", "op",
        "ops.ldpc.encode_header"),
    "CrcAppend": _E("crc_append.hpp", "op",
        "ops.crc.BatchedCrcAppend",
        "integer XOR-reduce CRC append w/ swap_endianness + skip_header_bytes"),
    "PacketMux": _E("packet_mux.hpp", "subsumed",
        "models.transmitter.Transmitter.modulate_bursts",
        "static-offset concatenation of header||payload and "
        "sync||data||ramp||flush sections"),
    "AdditiveScrambler": _E("additive_scrambler.hpp", "op",
        "ops.scramble", "precomputed keystream XOR / sign flip"),
    "PackBits": _E("pack_bits.hpp", "op", "ops.packing.pack_bits"),
    "UnpackBits": _E("unpack_bits.hpp", "op", "ops.packing.unpack_bits"),
    "Mapper": _E("mapper.hpp", "op", "ops.packing.map_symbols"),
    "InterpolatingFirFilter": _E("interpolating_fir_filter.hpp", "op",
        "ops.fir.interpolating_fir", "stream variant: stream_interpolating_fir"),
    "BurstShaper": _E("burst_shaper.hpp", "subsumed",
        "models.transmitter.Transmitter.modulate_bursts",
        "leading/trailing ramp multiplies"),
    "GlfsrSource": _E("glfsr_source.hpp", "op", "utils.lfsr.glfsr_bits"),
    "StreamToPdu": _E("stream_to_pdu.hpp", "subsumed",
        "models.transmitter", "ramp-down bit reservoir reshaped per packet"),
    "MultiplyPacketLenTag": _E("multiply_packet_len_tag.hpp", "subsumed",
        "utils.ragged", "length vectors are explicit; scaling is arithmetic"),
    "PacketTransmitter": _E("packet_transmitter.hpp", "model",
        "models.transmitter.Transmitter",
        "legacy tag-stream variant subsumed: stream/burst are config modes"),
    "PacketTransmitterPdu": _E("packet_transmitter_pdu.hpp", "model",
        "models.transmitter.Transmitter"),
    # ----------------------------------------------------------- RX chain
    "SyncwordDetection": _E("syncword_detection.hpp", "op",
        "ops.acquire.SyncwordAcquirer",
        "K1 (fused acquisition, the default on CUDA; its bf16 form for fused_bf16) "
        "and K2b (estimates)"),
    "SyncwordDetectionFilter": _E("syncword_detection_filter.hpp", "model",
        "models.receiver.Receiver.filter_detections",
        "in-packet suppression after the header pass (K2, K3, K4, K5)"),
    "CoarseFrequencyCorrection": _E("coarse_frequency_correction.hpp",
        "subsumed", "models.receiver.Receiver._extract_symbols",
        "fused derotation in the packet symbol extraction (K2, K3)"),
    "SymbolFilter": _E("symbol_filter.hpp", "op",
        "ops.fir.pfb_symbol_filter",
        "batched form on the card: Receiver._extract_symbols (K2, K3)"),
    "SyncwordWipeoff": _E("syncword_wipeoff.hpp", "subsumed",
        "models.receiver.Receiver.decode_headers", "bipolar multiply"),
    "PayloadMetadataInsert": _E("payload_metadata_insert.hpp", "model",
        "models.receiver", "two-pass header->payload restructure; "
        "constellation/bandwidth schedule in ops.costas.costas_segments"),
    "CostasLoop": _E("costas_loop.hpp", "op", "ops.costas.costas_run",
        "the plain recursion; the receiver's schedule runs as K4 "
        "(ops.costas_cuda.costas_track)"),
    "SyncwordRemove": _E("syncword_remove.hpp", "subsumed",
        "models.receiver.Receiver.decode_headers",
        "header LLRs start at symbol 64"),
    "ConstellationLLRDecoder": _E("constellation_llr_decoder.hpp", "subsumed",
        "models.receiver", "scale 2/sigma^2 on I/Q planes"),
    "HeaderPayloadSplit": _E("header_payload_split.hpp", "subsumed",
        "models.receiver", "explicit two-pass split"),
    "HeaderFecDecoder": _E("header_fec_decoder.hpp", "op",
        "ops.ldpc.HeaderLdpcDecoder",
        "batched min-sum BP replacing the Rust ldpc-toolbox FFI; K5 "
        "(ops.ldpc_cuda.ldpc_totals) on CUDA tensors"),
    "HeaderParser": _E("header_parser.hpp", "subsumed",
        "models.receiver.Receiver.decode_headers", "K2, K3, K4, K5"),
    "BinarySlicer": _E("binary_slicer.hpp", "op", "ops.packing.binary_slice"),
    "CrcCheck": _E("crc_check.hpp", "op",
        "ops.crc.BatchedCrcCheck",
        "batched check (also fused in Receiver.decode_payloads)"),
    "PacketTypeFilter": _E("packet_type_filter.hpp", "subsumed",
        "models.receiver.Receiver.decode_payloads", "accepted mask"),
    "PacketReceiver": _E("packet_receiver.hpp", "model",
        "models.receiver.Receiver", "K1, K2, K2b, K3, K4, K5"),
    # ------------------------------------------------- IO / flow / latency
    "TunSource": _E("tun_source.hpp", "io", "io.tun.TunDevice",
        "idle-packet + credit logic in apps.packet_transceiver and "
        "runtime.flow.PacketCredit"),
    "TunSink": _E("tun_sink.hpp", "io", "io.tun.TunDevice.write_packet"),
    "PacketCounter": _E("packet_counter.hpp", "runtime",
        "runtime.flow.PacketCredit.release"),
    "PacketLimiter": _E("packet_limiter.hpp", "runtime",
        "runtime.flow.PacketCredit"),
    "PacketToStream": _E("packet_to_stream.hpp", "runtime",
        "runtime.streaming.StreamingTransmitter",
        "burst concatenation + zero fill"),
    "Throttle": _E("throttle.hpp", "runtime", "runtime.flow.Throttle"),
    "ProbeRate": _E("probe_rate.hpp", "runtime", "runtime.flow.ProbeRate"),
    "ZmqPduPubSink": _E("zmq_pdu_pub_sink.hpp", "io",
        "io.zmq_pub.ZmqPduPubSink"),
    "FileSource": _E("file_source.hpp", "io", "io.file.stream_c64_blocks"),
    "FileSink": _E("file_sink.hpp", "io", "io.file.FileSinkC64"),
    "Head": _E("head.hpp", "subsumed", "array slicing",
        "finite batches are explicit; [:n] is the op"),
    "VectorSource": _E("vector_source.hpp", "op",
        "utils.ragged.PacketBatch.from_list"),
    "VectorSink": _E("vector_sink.hpp", "op",
        "utils.ragged.PacketBatch.to_list"),
    "RandomSource": _E("random_source.hpp", "subsumed",
        "numpy default_rng in tests", "seeded uniform byte packets"),
    "NullSource": _E("null_source.hpp", "subsumed", "torch.zeros"),
    "NullSink": _E("null_sink.hpp", "subsumed", "discarding results"),
    "NoiseSource": _E("noise_source.hpp", "op", "models.channel.awgn"),
    "Add": _E("add.hpp", "subsumed", "tensor addition (fused into awgn)"),
    "Rotator": _E("rotator.hpp", "op", "models.channel.rotate"),
    "PfbArbResampler": _E("pfb_arb_resampler.hpp", "op",
        "ops.fir.pfb_arb_resample", "channel SFO model: models.channel.sfo"),
    "StreamToTaggedStream": _E("stream_to_tagged_stream.hpp", "subsumed",
        "utils.ragged", "fixed-length segmentation is a reshape"),
    "TaggedStreamToPdu": _E("tagged_stream_to_pdu.hpp", "subsumed",
        "utils.ragged.PacketBatch", "length vectors replace len tags"),
    "PduToTaggedStream": _E("pdu_to_tagged_stream.hpp", "op",
        "utils.ragged.ragged_concat"),
    "TagGate": _E("tag_gate.hpp", "subsumed",
        "no implicit tag propagation exists; metadata flow is explicit"),
    "MessageDebug": _E("message_debug.hpp", "runtime",
        "runtime.messages.MessageDebug"),
    "MessageDebugStream": _E("message_debug_stream.hpp", "runtime",
        "runtime.messages.MessageDebugStream"),
    "MessageStrobe": _E("message_strobe.hpp", "runtime",
        "runtime.messages.MessageStrobe"),
    "ItemStrobe": _E("item_strobe.hpp", "runtime",
        "runtime.messages.ItemStrobe"),
    "PacketStrobe": _E("packet_strobe.hpp", "runtime",
        "runtime.messages.PacketStrobe"),
    # --------------------------------------------------- shared primitives
    "Pdu": _E("pdu.hpp", "op", "utils.ragged.PacketBatch"),
    "Crc": _E("crc.hpp", "op", "ops.crc.CrcRef"),
    "firdes": _E("firdes.hpp", "op", "utils.firdes.root_raised_cosine"),
    "packet_transmitter_rrc_taps": _E("packet_transmitter_rrc_taps.hpp",
        "op", "utils.firdes.tx_rrc_taps"),
    "pfb_arb_taps": _E("pfb_arb_taps.hpp", "op",
        "models.channel.pfb_arb_taps", "remez-designed equivalent"),
    "random": _E("random.hpp", "subsumed",
        "torch.Generator", "seeded (Philox on CUDA) instead of xoroshiro"),
    "PacketType": _E("packet_type.hpp", "op", "utils.constants.PacketType"),
    "Constellation": _E("constellation.hpp", "op",
        "utils.constants.Constellation"),
    "Endianness": _E("endianness.hpp", "subsumed",
        "msb_first parameter of ops.packing"),
    "Tun": _E("tun.hpp", "io", "io.tun.native_lib",
        "native/tunio.cpp pm_tun_open via ctypes"),
    "xoroshiro128p": _E("xoroshiro128p.h", "subsumed",
        "torch.Generator (seeded noise has no bit-parity requirement)"),
}


def resolve(name: str):
    """Return the implementing object for a registry entry (or raise)."""
    import importlib

    entry = BLOCK_REGISTRY[name]
    if entry.kind == "subsumed":
        raise KeyError(
            f"{name} is structurally subsumed: {entry.target} ({entry.note})"
        )
    parts = entry.target.split(".")
    for split in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(
                "gr4_packet_modem_tpu_torch." + ".".join(parts[:split])
            )
        except ImportError:
            continue
        obj = mod
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(entry.target)


def coverage() -> dict[str, int]:
    """Inventory coverage statistics by kind."""
    out: dict[str, int] = {}
    for e in BLOCK_REGISTRY.values():
        out[e.kind] = out.get(e.kind, 0) + 1
    return out
