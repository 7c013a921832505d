"""Host-fed sharded serving: ``StreamingShardedBank`` on a ``(ch, time)``
mesh (port of examples/sharded_serving.py). The host streams ``[C, n]``
sample blocks to the mesh, each rank stages only its cell of the int8 wire,
the block is reassembled between time neighbours, every rank decodes its
own time shard with the in-packet suppression state chained across shards
and blocks, and the results come back compacted to the accepted packets.
Per-packet debug lines (``log=True``) mirror the reference's
``PayloadMetadataInsert{log:true}`` (payload_metadata_insert.hpp:66). On
CUDA tensors the decode runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.sharded_serving
       [--world N] [--device DEV]
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from ..models.channel import awgn, rotate
from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..parallel.bank import make_mesh, mesh_device, mesh_shape
from ..parallel.serving import StreamingShardedBank
from ..utils.ragged import PacketBatch, ragged_concat
from . import _mesh, check, parse

MODULE = __spec__.name  # the import name, also under python -m (where __name__ is "__main__")

BLOCK = 1 << 12


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """On every rank of the process group (or on ``--world`` spawned
    ranks). Returns ``mesh`` ``(ch, time)``, ``channels``, ``decoded`` (the
    count), ``per_channel`` counts, ``expected``, the ``packets``
    (``DecodedPacket``) and the two overflow counts."""
    args, dev = parse(argv, "sharded_serving", _mesh.parser(MODULE))
    if not _mesh.in_group(dev):
        return _mesh.spawn([(MODULE, argv)], args.world, dev.type, echo)[0]
    # every rank holds every packet; rank 0 logs them
    logging.basicConfig(level=logging.INFO if dist.get_rank() == 0 else logging.WARNING,
                        format="%(name)s %(message)s")

    mesh = make_mesh(device_type=dev.type)
    ch_shards, t_shards = mesh_shape(mesh)
    n_dev = ch_shards * t_shards
    channels = ch_shards
    echo(f"mesh: {ch_shards} ch x {t_shards} time shards ({n_dev} devices), {channels} channels")
    dev = mesh_device(mesh)

    # per-channel traffic: repeating bursts with per-channel CFO and noise
    tx = Transmitter(TxConfig(max_payload_len=128), dev)
    rng = np.random.default_rng(0)
    ch_payloads = [
        [rng.integers(0, 256, n, dtype=np.uint8) for n in (100, 64, 128)]
        for _ in range(channels)
    ]
    x = np.zeros((channels, 3 * BLOCK), np.complex64)
    for c, payloads in enumerate(ch_payloads):
        s, lens = tx.modulate_bursts(PacketBatch.from_list(payloads, 128, dev))
        stream, _ = ragged_concat(s, lens, int(lens.sum()))
        gen = torch.Generator(device=dev).manual_seed(c)
        sig = awgn(rotate(stream, 0.002 * (c + 1)), 0.05, gen).cpu().numpy()
        off = 200 + 900 * c
        x[c, off : off + sig.size] = sig

    bank = StreamingShardedBank(
        mesh,
        RxConfig(max_payload_len=128, max_detections=4, freq_bins=1),
        channels=channels,
        block=BLOCK,
        transfer_dtype=torch.int8,  # 2 B/sample host-to-device wire
        result_budget=4,            # compacted device-to-host: accepted rows only
        log=True,                   # per-packet RX debug lines
    )
    pkts = bank.process(x) + bank.flush()

    expected = sum(len(p) for p in ch_payloads)
    echo(f"decoded {len(pkts)}/{expected} packets on the mesh "
         f"(overflow blocks: {bank.overflow_blocks}, "
         f"budget overflow: {bank.budget_overflow_blocks})")
    check(len(pkts) == expected, f"decoded {len(pkts)} of {expected} packets")
    per_ch = np.bincount([p.channel for p in pkts], minlength=channels)
    return {"mesh": (ch_shards, t_shards), "channels": channels, "decoded": len(pkts),
            "per_channel": per_ch.tolist(), "expected": expected, "packets": pkts,
            "overflow_blocks": bank.overflow_blocks,
            "budget_overflow_blocks": bank.budget_overflow_blocks}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
