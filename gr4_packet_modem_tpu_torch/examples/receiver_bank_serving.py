"""Serving: a sharded multi-channel receiver bank decoding continuous
traffic with rate monitoring (port of examples/receiver_bank_serving.py):
``ReceiverBank`` (channels x time over the mesh, halos exchanged between
time neighbours), ``ProbeRate`` (probe_rate.hpp) and packet accounting, the
counterpart of running N ``packet_receiver`` flowgraphs at once. On CUDA
tensors the step runs all six kernels.

usage: python -m gr4_packet_modem_tpu_torch.examples.receiver_bank_serving
       [--world N] [--device DEV]
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.channel import awgn, rotate
from ..models.receiver import RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..parallel.bank import BankConfig, ReceiverBank, make_mesh, mesh_shape
from ..runtime.flow import ProbeRate
from ..utils.ragged import PacketBatch, ragged_concat
from . import _mesh, check, parse

MODULE = __spec__.name  # the import name, also under python -m (where __name__ is "__main__")

BLOCK = 1 << 14
STEPS = 4


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """On every rank of the process group (or on ``--world`` spawned
    ranks). Returns ``channels``, ``mesh`` ``(ch, time)``, ``decoded`` (the
    total), ``per_channel`` counts, ``expected`` (the least a channel must
    decode), the bank's ``samples``, ``seconds`` of the step and the
    probe's ``rate_avg`` (None when the step took less than the probe's
    0.2 s window)."""
    args, dev = parse(argv, "receiver_bank_serving", _mesh.parser(MODULE))
    if not _mesh.in_group(dev):
        return _mesh.spawn([(MODULE, argv)], args.world, dev.type, echo)[0]

    mesh = make_mesh(device_type=dev.type)
    ch_shards, t_shards = mesh_shape(mesh)
    n_dev = ch_shards * t_shards
    channels = max(8, 2 * n_dev)
    echo(f"mesh: {dict(ch=ch_shards, time=t_shards)} ({n_dev} devices), {channels} channels")

    bank = ReceiverBank(mesh, BankConfig(rx=RxConfig(max_payload_len=256, max_detections=32)))
    dev = bank.device
    # per-channel traffic: repeating bursts, per-channel CFO; every rank
    # makes the whole bank, as the host does, and steps its own cell
    tx = Transmitter(TxConfig(max_payload_len=256), dev)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (200, 64, 133)]
    s, lens = tx.modulate_bursts(PacketBatch.from_list(payloads, 256, dev))
    burst = ragged_concat(s, lens, int(lens.sum()))[0].cpu().numpy()
    one = torch.as_tensor(np.tile(burst, BLOCK * STEPS // burst.size + 1)[: BLOCK * STEPS], device=dev)
    x = np.zeros((channels, BLOCK * STEPS), np.complex64)
    for c in range(channels):
        gen = torch.Generator(device=dev).manual_seed(c)
        x[c] = awgn(rotate(one, 0.002 * (c % 5 - 2)), 0.05, gen).cpu().numpy()

    probe = ProbeRate(alpha=0.3)
    probe.update(0)  # prime the probe's clock (the first call only records the time)
    x_loc = torch.as_tensor(np.ascontiguousarray(bank.local_slice(x)), device=dev)

    t0 = time.time()
    res = bank.step(x_loc)
    counts = torch.zeros(channels, dtype=torch.int64, device=dev)
    c_loc = x_loc.shape[0]
    counts[bank.ch_idx * c_loc : (bank.ch_idx + 1) * c_loc] = res.accepted.sum(dim=1)
    dist.all_reduce(counts)
    per_ch = counts.cpu().numpy()
    seconds = time.time() - t0
    report = probe.update(channels * BLOCK * STEPS)
    echo(f"decoded {int(per_ch.sum())} packets across {channels} channels "
         f"in {seconds:.1f}s (first step, set-up included)")
    echo(f"per-channel packet counts: {per_ch.tolist()}")
    if report:
        echo(f"probe: rate_avg={report.rate_avg:,.0f} samples/s")
    expected = len(payloads) * (BLOCK * STEPS // burst.size)
    check(int(per_ch.min()) >= expected - len(payloads), f"per-channel counts {per_ch.tolist()}")
    echo("OK")
    return {"channels": channels, "mesh": (ch_shards, t_shards), "decoded": int(per_ch.sum()),
            "per_channel": per_ch.tolist(), "expected": expected,
            "samples": channels * BLOCK * STEPS, "seconds": seconds,
            "rate_avg": report.rate_avg if report else None}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
