"""Benchmark: the full RX chain's throughput on one card (port of the root
``bench.py``).

The reference's headline benchmark (benchmarks/benchmark_packet_receiver
at 4 syncword frequency bins, results.md:43-51), made harder: the receiver
is fed continuous back-to-back 1500-byte bursts, so every block runs
acquisition, header decode, carrier tracking and payload decode. The
metric is complex samples/s over a channel bank decoded on one card by
``Receiver.bank_step(x, group)``. Then three sustained rates through the
host-fed streaming receivers, each reported only when its parity gate holds (every
fed packet out exactly once, no block that saturated the detection slots
or the result wire; otherwise 0.0):

- ``StreamingReceiver``, one channel;
- ``StreamingBank``, ``BENCH_BANK_CHANNELS`` channels;
- ``StreamingShardedBank`` on a ``(ch, time)`` mesh over the process
  group: the one set up already, one started from ``PM_COORDINATOR`` /
  ``PM_NUM_PROCESSES`` / ``PM_PROCESS_ID``, or a world of one started
  here (NCCL on the card, gloo on the CPU) and destroyed at the end.

Knobs (environment, bench.py's names and defaults): ``BENCH_CHANNELS``
(64), ``BENCH_BLOCK`` (2**19), ``BENCH_ITERS`` (20), ``BENCH_CARRIER``
(``vv``; ``costas``), ``BENCH_ACQ`` (``fused``; ``fused_bf16``, ``fft``,
``conv``, ``conv_bf16``, as the root bench.py takes them), ``BENCH_GROUP``
(16), ``BENCH_MAXDET`` (packets that can start in a block + 2, rounded up
to 4, at least 16), ``BENCH_BUDGET`` (``auto``: packets a block + 4, at
most the detection slots; ``0`` no compaction; or a number a channel),
``BENCH_XFER`` (``f32``, ``bf16``, ``int8``, ``int4``), ``BENCH_BANK_CHANNELS``
(8) and the switches ``BENCH_SUSTAINED``, ``BENCH_BANK``, ``BENCH_SHARDED``
(``1``).

Prints one JSON line with bench.py's keys; ``compile_s`` is the first
step's seconds, ``device`` the card's name, and ``card`` the card's name
and power limit as ``nvidia-smi`` gives them. ``BASELINE_RX_SPS`` is the
GR4 reference's full RX rate at 4 frequency bins on a Ryzen 7 5800X CPU
(results.md:43-51), the yardstick of ``vs_baseline``.

usage: [BENCH_*=...] python -m gr4_packet_modem_tpu_torch.bench [--device DEV]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .benchmarks.common import card_fields, parse, process_group, sync, tiled_burst_signal
from .models.receiver import Receiver, RxConfig
from .parallel.bank import make_mesh, mesh_shape
from .parallel.serving import StreamingShardedBank
from .runtime.streaming import StreamingBank, StreamingReceiver
from .utils import constants as C

BASELINE_RX_SPS = 7.0e6  # the GR4 reference's full RX, 4 frequency bins (results.md:43-51)
N_PAYLOADS = 12  # random 1500-byte packets (seed 0), back to back, tiled
STREAM_SIZE = N_PAYLOADS * 4 * C.burst_symbols(1500)  # samples of one tile
WIRES = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}


def sustain(receiver, unit: np.ndarray, iters: int, expected_per_unit: int) -> dict:
    """Feed ``unit`` once to warm up, then ``iters`` times timed (the
    pipelined tail materialised inside the timing, the final lookahead
    decoded after it), as bench.py's three sustained runs do. Returns the
    parity verdict, the packet counts, the rate (0.0 unless the gate holds,
    samples of one channel a second times the channels) and the per-block
    host split of the timed blocks in ms."""
    n_pkts = len(receiver.process(unit))
    blocks0, stats0 = receiver.stats["blocks"], dict(receiver.stats)
    t0 = time.perf_counter()
    for _ in range(iters):
        n_pkts += len(receiver.process(unit))
    n_pkts += len(receiver._drain())
    dt = time.perf_counter() - t0
    blocks = receiver.stats["blocks"] - blocks0
    stats1 = dict(receiver.stats)
    n_pkts += len(receiver.flush())
    expected = expected_per_unit * (1 + iters)
    parity_ok = (
        n_pkts == expected and receiver.overflow_blocks == 0 and receiver.budget_overflow_blocks == 0
    )
    nb = max(blocks, 1)
    return {
        "parity_ok": parity_ok, "expected": expected, "decoded": n_pkts,
        "sps": blocks * receiver.block * receiver.channels / dt if parity_ok else 0.0,
        **{k: round(1e3 * (stats1[f"{k}_s"] - stats0[f"{k}_s"]) / nb, 2)
           for k in ("h2d", "dispatch", "materialize")},
    }


def split(prefix: str, r: dict) -> dict:
    """``r``'s per-block host split under bench.py's key names."""
    return {f"{prefix}_{k}_ms_per_block": r[k] for k in ("h2d", "dispatch", "materialize")}


def run(argv: list[str] | None = None, device="cuda", echo: bool = True) -> dict:
    """Runs the four measurements; returns the printed record."""
    rest, dev = parse(argv, device)
    if rest:
        raise SystemExit(f"bench takes no positional arguments (BENCH_* variables set it): {rest}")
    env = os.environ.get
    channels = int(env("BENCH_CHANNELS", "64"))
    block = int(env("BENCH_BLOCK", str(1 << 19)))
    iters = int(env("BENCH_ITERS", "20"))
    carrier = env("BENCH_CARRIER", "vv")
    acq_backend = env("BENCH_ACQ", "fused")
    group = int(env("BENCH_GROUP", "16"))
    xfer = env("BENCH_XFER", "int8")
    bank_ch = int(env("BENCH_BANK_CHANNELS", "8"))
    wire = WIRES[xfer]

    # one block of continuous 1500-byte bursts a channel; the packets whose
    # whole burst fits in the block are expected to decode (the tail burst
    # may be cut)
    signal, num_pkts_per_block = tiled_burst_signal(total=block, device=dev)

    # detection slots: packets that can start in a block (the cut tail
    # burst included) + 2, rounded up to a multiple of 4; a dropped packet
    # shows in decoded_packet_frac and the parity gates
    pkts_ub = -(-block * N_PAYLOADS // STREAM_SIZE)
    max_det = int(env("BENCH_MAXDET", str(max(16, -(-(pkts_ub + 2) // 4) * 4))))
    config = RxConfig(
        max_payload_len=1536, max_detections=max_det, freq_bins=4,
        payload_carrier=carrier, acquisition_backend=acq_backend,
    )
    rx = Receiver(config, dev)
    fp = rx.front_pad
    x = np.zeros((channels, fp + block + rx.pad_tail()), np.complex64)
    for c in range(channels):
        x[c, fp : fp + block] = signal * np.exp(1j * 0.1 * c)
    x = torch.from_numpy(x).to(dev)

    def rx_step(samples: torch.Tensor):
        # every output is consumed, the Es/N0 estimates included, as
        # bench.py's step does: the serving paths ship them per packet
        det, _, res, _ = rx.bank_step(samples, group)
        return res.accepted.sum(), res.crc_ok.sum(), det.esn0_db.sum()

    t0 = time.perf_counter()
    acc, _, _ = rx_step(x)
    sync(dev)
    compile_s = time.perf_counter() - t0
    decoded_frac = int(acc) / max(num_pkts_per_block * channels, 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        rx_step(x)
    sync(dev)
    sps = channels * block * iters / (time.perf_counter() - t0)
    del x

    # result-wire budget (accepted rows first, runtime/streaming.
    # pack_result_wire): a channel's packets a block + 4; BENCH_BUDGET=0
    # ships every row, a number sets the budget a channel
    bud_env = env("BENCH_BUDGET", "auto")
    if bud_env == "0":
        budget_per_ch = None
    elif bud_env == "auto":
        budget_per_ch = min(max_det, pkts_ub + 4)
    else:
        budget_per_ch = int(bud_env)

    # the streaming runs are fed whole 12-burst tiles: a burst cut
    # mid-payload claims its full extent in its header and suppresses the
    # next real start (as the reference's SyncwordDetectionFilter does), a
    # property of the stimulus, not a receiver loss
    sig_unit, pkts_per_unit = tiled_burst_signal(
        total=max(1, -(-block // STREAM_SIZE)) * STREAM_SIZE, device=dev)
    bank_group = 16 if bank_ch > 16 and bank_ch % 16 == 0 else 0
    bank_budget = None if budget_per_ch is None else budget_per_ch * bank_ch
    x_unit = np.stack([sig_unit * np.exp(1j * 0.1 * c) for c in range(bank_ch)]).astype(np.complex64)

    sustained, sustained_info = 0.0, {}
    if env("BENCH_SUSTAINED", "1") == "1":
        srx = StreamingReceiver(config, dev, block=block, transfer_dtype=wire, result_budget=budget_per_ch)
        r = sustain(srx, sig_unit, max(iters // 2, 5), pkts_per_unit)
        sustained = r["sps"]
        sustained_info = {
            "sustained_xfer": xfer, "sustained_budget": budget_per_ch,
            "sustained_parity_ok": r["parity_ok"], "sustained_expected_pkts": r["expected"],
            "sustained_decoded_pkts": r["decoded"], "sustained_overflow_blocks": srx.overflow_blocks,
            **split("sustained", r),
        }
        del srx

    bank_sustained, bank_info = 0.0, {}
    if env("BENCH_BANK", "1") == "1":
        bank = StreamingBank(config, dev, channels=bank_ch, block=block, transfer_dtype=wire,
                             group=bank_group, result_budget=bank_budget)
        r = sustain(bank, x_unit, max(iters // 4, 3), pkts_per_unit * bank_ch)
        bank_sustained = r["sps"]
        bank_info = {
            "bank_channels": bank_ch, "bank_budget": bank.result_budget,
            "bank_sustained_parity_ok": r["parity_ok"], "bank_sustained_expected_pkts": r["expected"],
            "bank_sustained_decoded_pkts": r["decoded"], **split("bank", r),
        }
        del bank

    sharded_sustained, sharded_info = 0.0, {}
    if env("BENCH_SHARDED", "1") == "1":
        with process_group(dev):
            mesh = make_mesh(dist.get_world_size(), device_type=dev.type)
            c_shards = mesh_shape(mesh)[0]
            sbank = StreamingShardedBank(
                mesh, config, channels=bank_ch, block=block, transfer_dtype=wire, group=bank_group,
                result_budget=None if budget_per_ch is None else budget_per_ch * (bank_ch // c_shards),
            )
            r = sustain(sbank, x_unit, max(iters // 4, 3), pkts_per_unit * bank_ch)
            sharded_sustained = r["sps"]
            sharded_info = {
                "sharded_mesh": list(mesh_shape(mesh)), "sharded_budget": sbank.result_budget,
                "sharded_parity_ok": r["parity_ok"], "sharded_expected_pkts": r["expected"],
                "sharded_decoded_pkts": r["decoded"], **split("sharded", r),
            }
            del sbank, mesh

    result = {
        "metric": "rx_chain_samples_per_sec_per_chip",
        "value": float(f"{sps:.4g}"),
        "unit": "samples/s",
        "vs_baseline": float(f"{sps / BASELINE_RX_SPS:.4g}"),
        "channels": channels,
        "block": block,
        "carrier": carrier,
        "acq_backend": acq_backend,
        "sustained_stream_sps": float(f"{sustained:.4g}"),
        "bank_sustained_sps": float(f"{bank_sustained:.4g}"),
        "sharded_bank_sustained_sps": float(f"{sharded_sustained:.4g}"),
        "max_detections": max_det,
        "decoded_packet_frac": round(decoded_frac, 4),
        "compile_s": round(compile_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        **sustained_info,
        **bank_info,
        **sharded_info,
        **card_fields(dev),
    }
    if echo:
        print(json.dumps(result), flush=True)
    return result


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
