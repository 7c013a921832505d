"""Time the receiver paths that an edit to the receiver's passes can move,
for comparing two checkouts in turns on one card: the V&V bank step at
group 0 (bench geometry, 64 channels of 2^19 samples) and
``StreamingReceiver``'s sustained rate on bench.py's feed. Each is repeated
``--reps`` times in the process; the stimulus, the decode gates and the
timers are ``chip_smoke.py``'s, taken from the checkout under test.

    python3 scripts/ab_receiver_torch.py [--root CHECKOUT] [--reps 5] [--units 6]

``--root`` (default: this script's checkout) is the tree whose package and
``chip_smoke.py`` are imported, so one copy of this script times a parent
checkout as well. Prints one JSON line: the card as ``nvidia-smi`` gives
it, the step medians (ms, 10 calls each) and the streaming rates
(samples/s). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--units", type=int, default=6, help="timed stream units a repetition")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_receiver_torch: torch.cuda.is_available() is false")
    import chip_smoke as cs
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG, bank_entry
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingReceiver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    block, channels = BENCH_BLOCK, BENCH_CHANNELS

    step, (x,) = bank_entry(dev)
    rx = step.__self__
    samples, expected, _ = cs.bench_signal(block, channels)
    x[:, rx.front_pad : rx.front_pad + block] = torch.from_numpy(samples).to(dev)

    def full():
        det, _, res, _ = rx.bank_step(x, 0)
        n = int(res.accepted.sum().item())
        cs.check(n == channels * len(expected), f"V&V step accepted {n} packets")
        return det.esn0_db.sum().item() + res.crc_ok.sum().item()

    x_unit, stream_expected = cs.stream_stimulus(block, channels, args.units)
    budget = BENCH_CONFIG.max_detections
    step_ms, stream_sps = [], []
    for _ in range(args.reps):
        step_ms.append(cs.median_ms(torch, full, reps=10))
        srx = StreamingReceiver(BENCH_CONFIG, dev, block=block, result_budget=budget)
        r, _ = cs.stream_run(torch, card, srx, x_unit[0], stream_expected, args.units, "StreamingReceiver f32")
        stream_sps.append(r["rate_sps"])
        del srx
    print(json.dumps({"root": root, "card": card, "vv_group0_step_ms": step_ms,
                      "streaming_receiver_sps": stream_sps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
