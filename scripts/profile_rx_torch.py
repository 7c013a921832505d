#!/usr/bin/env python3
"""Profile the PyTorch port's bank step on the GPU (torch.profiler).

Runs ``Receiver.bank_step``'s stages at the bench geometry (64 channels of
2**19 samples, the stimulus of ``chip_smoke.py``) under ``torch.profiler``
and prints: device time per stage (acquire, headers, filter, payloads), the
top kernels by device time, and the device's busy and idle share of the
wall time of the same steps run without the profiler (and with it). The Chrome trace goes to
``chiprun_out/profile_rx_torch_<carrier>.json``.

    python3 scripts/profile_rx_torch.py [--steps 3] [--channels 64] [--carrier vv]

``--carrier costas`` runs the Costas payload carrier (K4 over the payload)
in place of bench.py's V&V.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--carrier", choices=("vv", "costas"), default="vv")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import bench_signal
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CONFIG, bank_entry
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, flatten_detections

    if not torch.cuda.is_available():
        raise SystemExit("profile_rx_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    _, (x,) = bank_entry(dev, channels=args.channels)
    rx = Receiver(dataclasses.replace(BENCH_CONFIG, payload_carrier=args.carrier), dev)
    samples, _, _ = bench_signal(BENCH_BLOCK, args.channels)
    x[:, rx.front_pad : rx.front_pad + BENCH_BLOCK] = torch.from_numpy(samples).to(dev)

    def one_step():
        with record_function("stage:acquire"):
            det = rx.acquirer.acquire(x)
        with record_function("stage:headers"):
            detf, chan = flatten_detections(det)
            hdr, _ = rx.decode_headers(x, detf, chan)
        with record_function("stage:filter"):
            keep = rx.filter_detections(det, hdr).reshape(-1)
        with record_function("stage:payloads"):
            res = rx.decode_payloads(x, detf, hdr, keep, chan)
        return res.accepted.sum().item() + detf.esn0_db.sum().item()

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one_step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out", f"profile_rx_torch_{args.carrier}.json"))

    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    spans = [e for e in evs if e.name.startswith("stage:")]
    kernels = [e for e in evs if not e.name.startswith("stage:")]
    busy_ms = sum(k.time_range.elapsed_us() for k in kernels) / 1e3
    stage_busy = {}
    stage_span = {}
    stage_kernels = {}
    for a in spans:
        stage_span[a.name] = stage_span.get(a.name, 0.0) + a.time_range.elapsed_us() / 1e3
        inside = [k for k in kernels
                  if a.time_range.start <= k.time_range.start < a.time_range.end]
        stage_busy[a.name] = stage_busy.get(a.name, 0.0) + sum(
            k.time_range.elapsed_us() for k in inside) / 1e3
        per = stage_kernels.setdefault(a.name, {})
        for k in inside:
            per[k.name] = per.get(k.name, 0.0) + k.time_range.elapsed_us() / 1e3
    n = args.steps
    print(f"card: {card}; {n} steps of {args.channels} ch x {BENCH_BLOCK} samples, "
          f"{args.carrier} payload carrier")
    print(f"wall {plain_wall_ms / n:.3f} ms/step unprofiled, {wall_ms / n:.3f} profiled; "
          f"device busy {busy_ms / n:.3f} ms/step in {len(kernels) / n:.0f} kernels; "
          f"idle share {1 - busy_ms / plain_wall_ms:.3f} "
          f"of the unprofiled wall, {1 - busy_ms / wall_ms:.3f} of the profiled")
    for name in stage_span:
        print(f"  {name:16s} device span {stage_span[name] / n:.3f} ms/step, "
              f"kernels busy {stage_busy[name] / n:.3f} ms/step; top:")
        for kname, t in sorted(stage_kernels[name].items(), key=lambda kv: -kv[1])[:6]:
            print(f"      {t / n:9.3f}  {kname[:100]}")
    by_name = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us() / 1e3, c + 1)
    print("top kernels by device time (ms/step, launches/step):")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t / n:9.3f}  {c / n:6.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
