"""Sharded receiver bank over a ``(ch, time)`` mesh (port of
examples/sharded_bank.py): each rank decodes its own time shard; packets
that straddle a shard edge are recovered through the halo exchange
(``parallel/bank.py``). On CUDA tensors the step runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.sharded_bank
       [--world N] [--device DEV]
"""

from __future__ import annotations


import numpy as np
import torch
import torch.distributed as dist

from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..parallel.bank import BankConfig, ReceiverBank, make_mesh, mesh_shape
from ..utils.ragged import PacketBatch, ragged_concat
from . import _mesh, check, parse

MODULE = __spec__.name  # the import name, also under python -m (where __name__ is "__main__")

BLOCK = 8192


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """On every rank of the process group (or on ``--world`` spawned
    ranks). Returns ``mesh`` ``(ch, time)``, ``channels``, ``decoded`` (the
    total), ``per_channel`` counts and ``expected``."""
    args, dev = parse(argv, "sharded_bank", _mesh.parser(MODULE))
    if not _mesh.in_group(dev):
        return _mesh.spawn([(MODULE, argv)], args.world, dev.type, echo)[0]

    mesh = make_mesh(device_type=dev.type)
    ch_shards, t_shards = mesh_shape(mesh)
    n_dev = ch_shards * t_shards
    echo(f"mesh: {ch_shards} channel shards x {t_shards} time shards ({n_dev} devices)")

    channels = 2 * ch_shards
    bank = ReceiverBank(mesh, BankConfig(rx=RxConfig(max_payload_len=128, max_detections=8, freq_bins=1)))
    dev = bank.device

    tx = Transmitter(TxConfig(max_payload_len=128), dev)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 96, dtype=np.uint8) for _ in range(3)]
    s, lens = tx.modulate_bursts(PacketBatch.from_list(payloads, 128, dev))
    burst = ragged_concat(s, lens, int(lens.sum()))[0].cpu().numpy()

    total = BLOCK * t_shards
    x = np.zeros((channels, total), np.complex64)
    for c in range(channels):
        x[c, 37 + 101 * c : 37 + 101 * c + burst.size] = burst  # staggered

    x_loc = torch.as_tensor(np.ascontiguousarray(bank.local_slice(x)), device=dev)
    res = bank.step(x_loc)
    counts = torch.zeros(channels, dtype=torch.int64, device=dev)
    c_loc = x_loc.shape[0]
    counts[bank.ch_idx * c_loc : (bank.ch_idx + 1) * c_loc] = res.accepted.sum(dim=1)
    dist.all_reduce(counts)
    per_ch = counts.cpu().numpy()
    decoded = int(per_ch.sum())
    expected = channels * len(payloads)
    echo(f"decoded {decoded} packets (expected {expected}) across {n_dev} devices")
    check(decoded == expected, f"decoded {decoded} of {expected} packets")
    return {"mesh": (ch_shards, t_shards), "channels": channels, "decoded": decoded,
            "per_channel": per_ch.tolist(), "expected": expected}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
