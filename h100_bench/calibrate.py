"""Read the numbers that decide ``correct`` over many seeds in one
process, for setting and re-checking the limits (PERF.md gives the
readings). ``--rx key=value`` changes a field of the configuration's
receiver for the whole call: ``--rx acquisition_backend=fused_bf16`` runs
the control, the program's own lower-precision acquisition.

    python3 -m h100_bench.calibrate --workload <name> --seeds 1,2,3 --seconds 3 [--rx k=v]

Prints one JSON line a seed: the seed, ``correct``, and each number with
its limit.
"""

from __future__ import annotations

import argparse
import json

from .run import ROOT, pin_caches, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rx", action="append", default=[])
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA card")
    rx = {}
    for kv in args.rx:
        k, v = kv.split("=", 1)
        rx[k] = json.loads(v) if v[:1].isdigit() else v
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run_cell(manifest, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), hooks={"rx": rx})
        print(json.dumps({"seed": seed, "rx": rx, "correct": result["correct"],
                          "checks": result["checks"], "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
