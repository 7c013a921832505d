#!/usr/bin/env python3
"""Profile the sharded serving driver against ``StreamingBank`` on one GPU.

One process, NCCL at world 1, a 1 x 1 ``make_mesh``. For ``StreamingBank``
and ``StreamingShardedBank`` (int8 wire, 64 channels of 2**19-sample
blocks, groups of 16, the stimulus of ``chip_smoke.py``'s streaming phase)
and for ``ReceiverBank.step`` and ``Receiver.bank_step(x, 16)`` on the bench
bank, it prints the wall time a block or step, the device busy time, and
the operations that take the most host (self CPU) and device time under
``torch.profiler``, and the largest idle gaps between device operations
with the operations on either side.

    python3 scripts/profile_sharded_torch.py [--top 12] [--gaps 5]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--gaps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bench_signal, free_port, stream_stimulus
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.parallel.bank import BankConfig, ReceiverBank, make_mesh
    from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank

    if not torch.cuda.is_available():
        raise SystemExit("profile_sharded_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    mesh = make_mesh(1)
    block, channels = BENCH_BLOCK, BENCH_CHANNELS

    def report(label: str, fn, n: int) -> None:
        """Wall ms a unit of ``fn`` (``n`` units a call), then the
        profiler's device busy and top operations of one call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        for e in ev:  # the name before torch 2.4
            e.dev_us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        # busy: the device operations themselves (an aten op's device time
        # is its kernels' again)
        cuda = torch.autograd.DeviceType.CUDA
        busy = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == cuda) / 1e3 / n
        print(f"{label}: wall {wall:.2f} ms a unit, device busy {busy:.2f} ms a unit  [{card}]", flush=True)
        for key, name in (("self_cpu_time_total", "host"), ("dev_us", "device")):
            rows = sorted(ev, key=lambda e: getattr(e, key), reverse=True)[: args.top]
            print(f"  top by {name} time (ms a unit, calls a unit):")
            for e in rows:
                print(f"    {getattr(e, key) / 1e3 / n:9.3f}  {e.count / n:7.1f}  {e.key[:90]}")
        ops = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
        gaps = sorted(((b.time_range.start - a.time_range.end) / 1e3, a.name, b.name)
                      for a, b in zip(ops, ops[1:]))[::-1][: args.gaps]
        print(f"  largest idle gaps of the device ({len(ops)} operations in a span of "
              f"{(ops[-1].time_range.end - ops[0].time_range.start) / 1e3:.2f} ms):")
        for g, a, b in gaps:
            print(f"    {g:8.3f} ms after {a[:60]} before {b[:60]}")

    # the two drivers, one unit of whole tiles each (blocks counted)
    x_unit, _ = stream_stimulus(block, channels, 1)
    budget = BENCH_CONFIG.max_detections * channels
    for label, driver in (
        ("StreamingBank int8", StreamingBank(BENCH_CONFIG, dev, channels=channels, block=block, group=16,
                                             transfer_dtype=torch.int8, result_budget=budget)),
        ("StreamingShardedBank int8 1x1", StreamingShardedBank(
            mesh, BENCH_CONFIG, dev, channels=channels, block=block, group=16, transfer_dtype=torch.int8,
            result_budget=budget)),
    ):
        driver.process(x_unit)
        blocks = x_unit.shape[1] // block

        def feed(d=driver):
            d.process(x_unit)
            d._drain()

        report(f"{label} (per block, {blocks} blocks a call)", feed, blocks)
        del driver

    # one step of the bench bank
    rbank = ReceiverBank(mesh, BankConfig(rx=BENCH_CONFIG))
    samples, _, _ = bench_signal(block, channels)
    x_loc = torch.from_numpy(samples).to(dev)
    rx = rbank.rx
    x = rx.pad(x_loc)
    report("ReceiverBank.step", lambda: rbank.step(x_loc).accepted.sum().item(), 1)
    report("bank_step(x, 16)", lambda: rx.bank_step(x, 16)[2].accepted.sum().item(), 1)

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
